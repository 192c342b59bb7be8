"""`tests/test_properties.py`'s hypothesis properties on the port's plain
functions, each also held to the JAX function on the drawn example.

Shapes are fixed; hypothesis draws the values (``SETTINGS`` as JAX's).
The invariants are JAX's, with its tolerances.  Against JAX: the codec
and the IoU to 1e-6 (rtol and atol), the NMS keep mask and the matcher's
classes exactly, the train transform's boxes and labels exactly and its
image to 1e-6 (both run the same numpy code from the same rng).
"""

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from objectdetection_ssd_tpu.data import augment as jaugment
from objectdetection_ssd_tpu.infer.postprocess import \
    greedy_nms_mask as jgreedy_nms_mask
from objectdetection_ssd_tpu.ops import boxes as jboxes
from objectdetection_ssd_tpu.ops import matching as jmatching
from objectdetection_ssd_torch.data import augment
from objectdetection_ssd_torch.infer.nms_cuda import greedy_nms_mask
from objectdetection_ssd_torch.ops import boxes as box_ops
from objectdetection_ssd_torch.ops import matching
from objectdetection_ssd_torch.ops.priors import ssd300_priors

SETTINGS = dict(deadline=None, max_examples=25)
TOL = dict(rtol=1e-6, atol=1e-6)


def _boxes_strategy(n):
    """(n, 4) xyxy boxes with positive extents inside [0, 1]."""
    lo = hnp.arrays(np.float32, (n, 2),
                    elements=st.floats(0.0, 0.75, width=32,
                                       allow_subnormal=False))
    wh = hnp.arrays(np.float32, (n, 2),
                    elements=st.floats(0.0625, 0.25, width=32,
                                       allow_subnormal=False))
    return st.tuples(lo, wh).map(
        lambda t: np.concatenate([t[0], t[0] + t[1]], axis=1))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@settings(**SETTINGS)
@given(_boxes_strategy(16))
def test_codec_roundtrip(boxes_xyxy):
    """decode(encode(b, p), p) == b for any positive-extent box/prior."""
    cxcywh = box_ops.xyxy_to_cxcywh(torch.from_numpy(boxes_xyxy))
    priors = torch.roll(cxcywh, 1, dims=0)
    enc = box_ops.encode(cxcywh, priors)
    dec = box_ops.decode(enc, priors)
    np.testing.assert_allclose(_np(dec), _np(cxcywh), atol=1e-4, rtol=1e-4)

    j_cxcywh = jboxes.xyxy_to_cxcywh(jnp.asarray(boxes_xyxy))
    j_priors = jnp.roll(j_cxcywh, 1, axis=0)
    j_enc = jboxes.encode(j_cxcywh, j_priors)
    np.testing.assert_allclose(_np(cxcywh), np.asarray(j_cxcywh), **TOL)
    np.testing.assert_allclose(_np(enc), np.asarray(j_enc), **TOL)
    np.testing.assert_allclose(_np(dec),
                               np.asarray(jboxes.decode(j_enc, j_priors)),
                               **TOL)


@settings(**SETTINGS)
@given(_boxes_strategy(12))
def test_iou_bounds_symmetry_identity(boxes_xyxy):
    b = torch.from_numpy(boxes_xyxy)
    iou = _np(box_ops.pairwise_iou(b, b))
    assert np.all(iou >= -1e-6) and np.all(iou <= 1 + 1e-6)
    np.testing.assert_allclose(iou, iou.T, atol=1e-6)
    np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-5)
    jb = jnp.asarray(boxes_xyxy)
    np.testing.assert_allclose(iou, np.asarray(jboxes.pairwise_iou(jb, jb)),
                               **TOL)


def _greedy_nms_oracle(iou, valid, thr):
    """Direct transcription of the greedy suppression semantics."""
    k = len(valid)
    keep = np.zeros(k, bool)
    suppressed = np.zeros(k, bool)
    for i in range(k):
        if not valid[i] or suppressed[i]:
            continue
        keep[i] = True
        for j in range(i + 1, k):
            if iou[i, j] >= thr:
                suppressed[j] = True
    return keep


@settings(**SETTINGS)
@given(_boxes_strategy(24),
       hnp.arrays(np.bool_, (24,), elements=st.booleans()),
       st.floats(0.125, 0.875, allow_subnormal=False))
def test_nms_matches_python_oracle(boxes_xyxy, valid, thr):
    """The plain version beside K1 (`infer/nms_cuda.py`)."""
    b = torch.from_numpy(boxes_xyxy)
    iou = box_ops.pairwise_iou(b, b)
    ours = _np(greedy_nms_mask(iou, torch.from_numpy(valid), float(thr)))
    oracle = _greedy_nms_oracle(_np(iou), valid, float(thr))
    np.testing.assert_array_equal(ours, oracle)
    # JAX's keep mask on the same IoU matrix.
    np.testing.assert_array_equal(ours, np.asarray(jgreedy_nms_mask(
        jnp.asarray(_np(iou)), jnp.asarray(valid), float(thr))))


@settings(**SETTINGS)
@given(_boxes_strategy(8),
       hnp.arrays(np.int32, (8,), elements=st.integers(0, 19)))
def test_matcher_force_assigns_every_gt(boxes_xyxy, classes):
    """Every valid GT claims at least one prior with its class, unless a
    later GT with the same best prior steals it (last object wins, the
    reference's semantics)."""
    priors_xyxy = box_ops.cxcywh_to_xyxy(torch.from_numpy(ssd300_priors()))
    m = matching.match_batch(
        torch.from_numpy(boxes_xyxy)[None], torch.from_numpy(classes)[None],
        torch.ones((1, len(classes)), dtype=torch.bool), priors_xyxy, 0.5)
    matched = _np(m.matched_class[0])
    boxes = _np(m.matched_box[0])
    iou = _np(box_ops.pairwise_iou(torch.from_numpy(boxes_xyxy),
                                   priors_xyxy))
    best_prior = np.argmax(iou, axis=1)
    for g in range(len(classes)):
        rows = np.flatnonzero(
            (np.abs(boxes - boxes_xyxy[g]) < 1e-6).all(axis=1)
            & (matched == classes[g]))
        stolen = any(best_prior[g2] == best_prior[g]
                     for g2 in range(g + 1, len(classes)))
        assert len(rows) > 0 or stolen

    jm = jmatching.match_batch(
        jnp.asarray(boxes_xyxy)[None], jnp.asarray(classes)[None],
        jnp.ones((1, len(classes)), bool),
        jboxes.cxcywh_to_xyxy(jnp.asarray(ssd300_priors())), 0.5)
    np.testing.assert_array_equal(m.matched_class.numpy(),
                                  np.asarray(jm.matched_class))


@settings(**SETTINGS)
@given(st.integers(0, 2**31 - 1))
def test_train_transform_geometric_invariants(seed):
    """Whatever the random draw, the augmentation pipeline emits boxes
    inside the output image, with positive extents, labels a subset of the
    inputs, and equal box and label counts."""
    def drawn():
        rng = np.random.default_rng(seed)
        return rng, rng.integers(0, 255, (48, 64, 3)).astype(
            np.float32) / 255.0

    rng, img = drawn()
    boxes = np.asarray([[5.0, 6.0, 30.0, 28.0],
                        [20.0, 10.0, 60.0, 44.0],
                        [1.0, 1.0, 10.0, 9.0]], np.float32)
    labels = np.asarray([2, 7, 11], np.int64)

    out_img, out_boxes, out_labels = augment.train_transform(
        img, boxes.copy(), labels.copy(), rng)

    h, w = out_img.shape[:2]
    assert len(out_boxes) == len(out_labels)
    assert set(out_labels.tolist()) <= set(labels.tolist())
    if len(out_boxes):
        assert np.all(out_boxes[:, 0] < out_boxes[:, 2] + 1e-3)
        assert np.all(out_boxes[:, 1] < out_boxes[:, 3] + 1e-3)
        assert np.all(out_boxes[:, :2] >= -1.0 - 1e-3)   # flip math is x-1
        assert np.all(out_boxes[:, 2] <= w + 1e-3)
        assert np.all(out_boxes[:, 3] <= h + 1e-3)
    assert np.isfinite(out_img).all()
    assert out_img.min() >= -1e-3 and out_img.max() <= 1.0 + 1e-3

    # JAX's transform from an rng in the same state.
    j_rng, j_img = drawn()
    j_img, j_boxes, j_labels = jaugment.train_transform(
        j_img, boxes.copy(), labels.copy(), j_rng)
    np.testing.assert_array_equal(out_boxes, j_boxes)
    np.testing.assert_array_equal(out_labels, j_labels)
    np.testing.assert_allclose(out_img, j_img, **TOL)

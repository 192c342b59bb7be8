"""Greedy-NMS suppression of the PyTorch port against the JAX package.

The plain version (`greedy_nms_mask`, and `greedy_nms_keep` on CPU tensors)
must give a keep mask EQUAL to JAX `greedy_nms_mask(pairwise_iou(...))`:
no tolerance.  The CUDA kernel is held to the same plain version on the
card by `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from objectdetection_ssd_tpu.infer import postprocess as jpost
from objectdetection_ssd_tpu.ops import boxes as jboxes
from objectdetection_ssd_torch.infer import nms_cuda
from objectdetection_ssd_torch.infer.postprocess import greedy_nms_mask
from objectdetection_ssd_torch.ops.boxes import pairwise_iou

torch.set_num_threads(2)

THR = 0.45


def _jax_keep(boxes, valid, thr=THR):
    iou = jboxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes))
    return np.asarray(jpost.greedy_nms_mask(iou, jnp.asarray(valid), thr,
                                            unrolled=False))


def _port_keep(boxes, valid, thr=THR):
    keep = nms_cuda.greedy_nms_keep(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), thr)
    return keep.numpy()


def _random_sets(seed, b, k, invalid_share=0.2):
    """Clustered boxes (so many pairs overlap), sorted-score order implied
    by position, with a share of invalid slots."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (b, 20, 4, 2))
    pick = rng.integers(0, 4, (b, 20, k))
    cxy = np.take_along_axis(centers, pick[..., None], axis=2)
    cxy = cxy + rng.normal(0, 0.04, (b, 20, k, 2))
    wh = rng.uniform(0.1, 0.3, (b, 20, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    valid = rng.uniform(size=(b, 20, k)) >= invalid_share
    return boxes.astype(np.float32), valid


def crafted_sets():
    """(name, boxes (n, K, 4), valid (n, K)) edge cases."""
    f32 = np.float32
    cases = []
    # IoU exactly 0.45 in f32: [0,0,1,1] vs [0,0,0.45,1] -> inter 0.45,
    # union 1.45 - 0.45 -> 0.45f; `>=` must suppress.
    cases.append(("iou_exactly_thr",
                  np.array([[[0, 0, 1, 1], [0, 0, 0.45, 1]]], f32),
                  np.array([[True, True]])))
    # Chain: A suppresses B, B (suppressed) must not suppress C.
    cases.append(("chain",
                  np.array([[[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0],
                             [0.5, 0.0, 1.5, 1.0]]], f32),
                  np.array([[True, True, True]])))
    cases.append(("all_invalid",
                  np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], f32), (1, 8, 1)),
                  np.zeros((1, 8), bool)))
    # Duplicates: the first valid copy survives, every later copy goes.
    cases.append(("duplicates",
                  np.tile(np.array([[0.2, 0.2, 0.6, 0.7]], f32), (1, 6, 1)),
                  np.array([[False, True, True, False, True, True]])))
    # An invalid top box never acts.
    cases.append(("invalid_never_acts",
                  np.array([[[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0]]],
                           f32),
                  np.array([[False, True]])))
    return cases


@pytest.mark.parametrize("k", [8, 64, 200])
def test_plain_matches_jax_random(k):
    boxes, valid = _random_sets(seed=k, b=2, k=k)
    got = _port_keep(boxes, valid)
    want = _jax_keep(boxes, valid)
    np.testing.assert_array_equal(got, want)
    assert (valid & ~got).any()          # something was suppressed


@pytest.mark.parametrize("case", crafted_sets(), ids=lambda c: c[0])
def test_plain_matches_jax_crafted(case):
    _, boxes, valid = case
    np.testing.assert_array_equal(_port_keep(boxes, valid),
                                  _jax_keep(boxes, valid))


def test_crafted_expected_masks():
    got = {name: _port_keep(b, v)[0].tolist()
           for name, b, v in crafted_sets()}
    assert got["iou_exactly_thr"] == [True, False]
    assert got["chain"] == [True, False, True]
    assert got["all_invalid"] == [False] * 8
    assert got["duplicates"] == [False, True, False, False, False, False]
    assert got["invalid_never_acts"] == [False, True]


def _np_iou(a, b):
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (aa[:, None] + ab[None, :] - inter)


@pytest.mark.parametrize("boxes,valid,thr,want", [
    # tests/test_postprocess.py: golden chain at 0.45.
    ([[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0], [1.0, 0.0, 2.0, 1.0]],
     [True, True, True], 0.45, [True, False, True]),
    # suppressed box does not suppress, at 0.3.
    ([[0.0, 0.0, 1.0, 1.0], [0.4, 0.0, 1.4, 1.0], [0.9, 0.0, 1.9, 1.0]],
     [True, True, True], 0.3, [True, False, True]),
    # invalid top box never acts or survives.
    ([[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0]],
     [False, True], 0.45, [False, True]),
])
def test_reference_cases_on_given_iou(boxes, valid, thr, want):
    """The recurrence alone, on one numpy IoU matrix fed to both."""
    iou = _np_iou(np.asarray(boxes, np.float32), np.asarray(boxes, np.float32))
    got = greedy_nms_mask(torch.from_numpy(iou), torch.tensor(valid), thr)
    jgot = jpost.greedy_nms_mask(jnp.asarray(iou), jnp.asarray(valid), thr)
    assert got.tolist() == want == np.asarray(jgot).tolist()


def test_reference_random_oracle_case():
    """tests/test_postprocess.py:test_greedy_nms_random_matches_oracle's
    input, on both packages."""
    rng = np.random.default_rng(0)
    n = 64
    lo = rng.uniform(0, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    boxes = np.concatenate([lo, lo + wh], 1).astype(np.float32)
    iou = _np_iou(boxes, boxes)
    got = greedy_nms_mask(torch.from_numpy(iou), torch.ones(n, dtype=bool),
                          0.45)
    want = jpost.greedy_nms_mask(jnp.asarray(iou), jnp.ones(n, bool), 0.45)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        _port_keep(boxes, np.ones(n, bool)), _jax_keep(boxes, np.ones(n, bool)))


def test_plain_path_does_not_count_launches():
    boxes, valid = _random_sets(seed=5, b=1, k=16)
    before = nms_cuda.launches
    _port_keep(boxes, valid)
    assert nms_cuda.launches == before


def test_greedy_nms_keep_matches_plain_on_iou():
    boxes, valid = _random_sets(seed=9, b=3, k=32)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    np.testing.assert_array_equal(
        nms_cuda.greedy_nms_keep(b, v, THR).numpy(),
        greedy_nms_mask(pairwise_iou(b, b), v, THR).numpy())


@pytest.mark.parametrize("boxes,valid,err", [
    (torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=bool), ValueError),
    (torch.zeros(2, 8, 4), torch.ones(2, 7, dtype=bool), ValueError),
    (torch.zeros(2, 8, 4, dtype=torch.float64), torch.ones(2, 8, dtype=bool),
     TypeError),
    (torch.zeros(2, 8, 4, dtype=torch.bfloat16), torch.ones(2, 8, dtype=bool),
     TypeError),
    (torch.zeros(2, 8, 4), torch.ones(2, 8, dtype=torch.uint8), TypeError),
    (torch.zeros(1, 257, 4), torch.ones(1, 257, dtype=bool), ValueError),
    (torch.zeros(1, 0, 4), torch.ones(1, 0, dtype=bool), ValueError),
    (torch.zeros(2, 4, 8).transpose(1, 2), torch.ones(2, 8, dtype=bool),
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(boxes, valid, err):
    with pytest.raises(err):
        nms_cuda.greedy_nms_keep(boxes, valid, THR)


def test_wrapper_takes_k_256():
    boxes, valid = _random_sets(seed=1, b=1, k=256)
    keep = nms_cuda.greedy_nms_keep(torch.from_numpy(boxes[:, :1]),
                                    torch.from_numpy(valid[:, :1]), THR)
    assert keep.shape == (1, 1, 256)

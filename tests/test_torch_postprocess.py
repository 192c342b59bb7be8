"""Postprocess of the PyTorch port against the JAX `postprocess`, on the
same random (2, 8732, 4) / (2, 8732, 21) predictions and the real priors.

Tolerance: valid masks and classes equal; on the valid rows, boxes and
scores to 1e-6 absolute (exp/logsumexp come from different libraries on
each side, a few f32 ulp).  Invalid rows are unspecified in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from objectdetection_ssd_tpu.config import PostprocessConfig as JPPConfig
from objectdetection_ssd_tpu.eval.evaluate import exact_eval_postprocess
from objectdetection_ssd_tpu.infer import postprocess as jpost
from objectdetection_ssd_tpu.ops.priors import ssd300_priors
from objectdetection_ssd_torch.config import PostprocessConfig
from objectdetection_ssd_torch.infer import postprocess as tpost

torch.set_num_threads(2)

P = 8732


def _predictions(seed, b=2, boost=None, cells=40):
    """Logits with confident clusters: all 4 priors of a 38x38-map cell get
    one class, so overlapping candidates clear 0.2 and must be suppressed.
    ``boost(rng)`` draws the 4 logit boosts of a cell."""
    rng = np.random.default_rng(seed)
    offsets = rng.normal(0, 0.2, (b, P, 4)).astype(np.float32)
    logits = rng.normal(0, 0.5, (b, P, 21)).astype(np.float32)
    logits[..., 20] += 4.0
    for i in range(b):
        for cell in rng.choice(38 * 38, cells, replace=False):
            idx = 4 * cell + np.arange(4)
            extra = (rng.uniform(4.0, 9.0, 4) if boost is None
                     else boost(rng))
            logits[i, idx, rng.integers(0, 20)] += extra.astype(np.float32)
    return offsets, logits


def _configs():
    base = JPPConfig()
    return {
        "two_stage": (base, PostprocessConfig()),
        "exact_eval": (exact_eval_postprocess(base),
                       PostprocessConfig(use_approx_top_k=False,
                                         anchor_prefilter=0,
                                         per_class_top_k=200)),
    }


def assert_same_detections(got, want, atol=1e-6):
    """`got` (port, tensors) vs `want` (JAX, arrays) on the valid rows."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.cpu().numpy(), valid)
    np.testing.assert_array_equal(got.classes.cpu().numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.cpu().numpy()[valid],
                               np.asarray(want.scores)[valid], atol=atol)
    np.testing.assert_allclose(got.boxes_xyxy.cpu().numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid], atol=atol)


@pytest.mark.parametrize("name", ["two_stage", "exact_eval"])
def test_postprocess_matches_jax(name):
    jcfg, tcfg = _configs()[name]
    offsets, logits = _predictions(seed=7)
    priors = ssd300_priors()
    want = jpost.postprocess(jnp.asarray(offsets), jnp.asarray(logits),
                             jnp.asarray(priors), jcfg)
    got = tpost.postprocess(torch.from_numpy(offsets),
                            torch.from_numpy(logits),
                            torch.from_numpy(priors), tcfg)
    assert got.boxes_xyxy.shape == (2, 200, 4)
    assert got.scores.dtype == torch.float32
    assert got.classes.dtype == torch.int32 and got.valid.dtype == torch.bool
    assert_same_detections(got, want)
    n_valid = got.valid.sum(dim=1)
    assert (n_valid > 20).all() and (n_valid < 200).all()


def test_nms_suppresses_in_this_input():
    _, tcfg = _configs()["two_stage"]
    offsets, logits = _predictions(seed=7)
    cand, scores, valid = tpost.select_candidates(
        torch.from_numpy(offsets), torch.from_numpy(logits),
        torch.from_numpy(ssd300_priors()), tcfg)
    assert cand.shape == (2, 20, 64, 4)
    keep = tpost.greedy_nms_mask(
        tpost.box_ops.pairwise_iou(cand, cand), valid, 0.45)
    assert (valid & ~keep).sum() > 10


def test_single_stage_bf16_ranking_matches_jax():
    """use_approx_top_k without a prefilter ranks bf16 scores.  JAX's CPU
    `approx_max_k` orders bf16 ties arbitrarily (not by index, unlike its
    f32 lowering), and greedy NMS depends on that order, so this input keeps
    the valid scores of each class distinct in bf16: the comparison then
    pins everything but the order of invalid slots."""
    jcfg = dataclasses.replace(JPPConfig(), anchor_prefilter=0)
    tcfg = PostprocessConfig(anchor_prefilter=0)
    offsets, logits = _predictions(
        seed=8, b=1, cells=12, boost=lambda rng: 4.0
        + 0.8 * rng.permutation(4) + rng.uniform(0, 0.5))
    priors = torch.from_numpy(ssd300_priors())
    _, scores, valid = tpost.select_candidates(
        torch.from_numpy(offsets), torch.from_numpy(logits), priors, tcfg)
    for c in range(20):
        s = scores[0, c][valid[0, c]]
        assert len(torch.unique(s)) == len(s)
    want = jpost.postprocess(jnp.asarray(offsets), jnp.asarray(logits),
                             jnp.asarray(priors.numpy()), jcfg)
    got = tpost.postprocess(torch.from_numpy(offsets),
                            torch.from_numpy(logits), priors, tcfg)
    assert_same_detections(got, want)


def test_bf16_predictions_match_jax():
    """bf16 model outputs (the timed path) go in without a cast."""
    offsets, logits = _predictions(seed=9, b=1)
    offsets = np.array(jnp.asarray(offsets, jnp.bfloat16)
                       .astype(jnp.float32))
    logits = np.array(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))
    priors = ssd300_priors()
    want = jpost.postprocess(jnp.asarray(offsets, jnp.bfloat16),
                             jnp.asarray(logits, jnp.bfloat16),
                             jnp.asarray(priors), JPPConfig())
    got = tpost.postprocess(torch.from_numpy(offsets).bfloat16(),
                            torch.from_numpy(logits).bfloat16(),
                            torch.from_numpy(priors), PostprocessConfig())
    assert_same_detections(got, want, atol=1e-5)


def test_empty_when_all_background():
    priors = torch.tensor([[0.5, 0.5, 0.2, 0.2]] * 3)
    logits = torch.zeros(2, 3, 21)
    logits[..., 20] = 10.0
    dets = tpost.postprocess(torch.zeros(2, 3, 4), logits, priors,
                             PostprocessConfig(per_class_top_k=3, top_k=5))
    assert dets.valid.shape == (2, 5) and not dets.valid.any()
    assert not dets.classes.any() and not dets.scores.any()


def test_scale_detections():
    dets = tpost.Detections(
        boxes_xyxy=torch.tensor([[[0.1, 0.2, 0.5, 0.8]]]),
        scores=torch.tensor([[0.9]]),
        classes=torch.tensor([[2]], dtype=torch.int32),
        valid=torch.tensor([[True]]))
    out = tpost.scale_detections(dets, torch.tensor([[200, 100]]))
    np.testing.assert_allclose(out.boxes_xyxy[0, 0].numpy(),
                               [20.0, 20.0, 100.0, 80.0], atol=1e-5)
    jd = jpost.Detections(*(jnp.asarray(t.numpy()) for t in dets))
    want = jpost.scale_detections(jd, jnp.asarray([[200, 100]]))
    np.testing.assert_array_equal(out.boxes_xyxy.numpy(),
                                  np.asarray(want.boxes_xyxy))
    assert out.classes is dets.classes


@pytest.mark.parametrize("shape,k", [((2, 20, 128), 64), ((2, 1280), 200),
                                     ((1, 8732), 128)])
def test_top_k_tie_order_matches_lax_top_k(shape, k):
    """Many exact ties (small integers, and the zeros of suppressed slots):
    the stable sort must give `lax.top_k`'s lower-index-first order."""
    import jax
    rng = np.random.default_rng(k)
    x = rng.integers(0, 5, shape).astype(np.float32)
    x[..., ::3] = 0.0
    values, idx = tpost._top_k(torch.from_numpy(x), k)
    jvalues, jidx = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))
    assert idx.is_contiguous() and values.is_contiguous()


def test_score_exactly_at_threshold_is_valid():
    """`valid = top_scores >= score_threshold` (postprocess.py:232): a
    candidate scoring exactly the threshold is kept, in both packages."""
    offsets, logits = _predictions(seed=7, b=1)
    priors = ssd300_priors()
    _, scores, valid = tpost.select_candidates(
        torch.from_numpy(offsets), torch.from_numpy(logits),
        torch.from_numpy(priors), PostprocessConfig())
    c = int(valid.sum(dim=-1).argmax())
    thr = float(scores[0, c, 1])           # second candidate of a busy class
    jcfg = dataclasses.replace(JPPConfig(), score_threshold=thr)
    tcfg = PostprocessConfig(score_threshold=thr)
    _, scores2, valid2 = tpost.select_candidates(
        torch.from_numpy(offsets), torch.from_numpy(logits),
        torch.from_numpy(priors), tcfg)
    assert scores2[0, c, 1] == thr and valid2[0, c, 1]
    assert not valid2[0, c, 2:].any() or scores2[0, c, 2] == thr
    want = jpost.postprocess(jnp.asarray(offsets), jnp.asarray(logits),
                             jnp.asarray(priors), jcfg)
    got = tpost.postprocess(torch.from_numpy(offsets),
                            torch.from_numpy(logits),
                            torch.from_numpy(priors), tcfg)
    assert_same_detections(got, want)
    assert (got.scores[got.valid] >= thr).all()

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


# ---------------------------------------------------------------- Soft-NMS


def _soft_nms_inputs(seed, b=3, k=48):
    """Clustered xyxy candidates with scores sorted descending, ~20%
    invalid, and runs of exactly equal scores (argmax ties)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (b, 20, 4, 2))
    pick = rng.integers(0, 4, (b, 20, k))
    cxy = np.take_along_axis(centers, pick[..., None], axis=2)
    cxy = cxy + rng.normal(0, 0.04, cxy.shape)
    wh = rng.uniform(0.1, 0.3, (b, 20, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(
        np.float32)
    scores = -np.sort(-rng.uniform(0.0, 1.0, (b, 20, k)), axis=-1)
    scores = np.round(scores * 16) / 16                  # many exact ties
    valid = rng.uniform(size=(b, 20, k)) >= 0.2
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize("method,sigma", [
    ("soft_gaussian", 0.5), ("soft_gaussian", 0.3), ("soft_linear", 0.5),
    ("soft_linear", 0.3)])
def test_soft_nms_scores_match_jax(method, sigma):
    boxes, scores, valid = _soft_nms_inputs(seed=int(sigma * 10))
    iou = tpost.box_ops.pairwise_iou(torch.from_numpy(boxes),
                                     torch.from_numpy(boxes))
    want = jpost.soft_nms_scores(jnp.asarray(iou.numpy()),
                                 jnp.asarray(scores), jnp.asarray(valid),
                                 method=method, sigma=sigma)
    got = tpost.soft_nms_scores(iou, torch.from_numpy(scores),
                                torch.from_numpy(valid), method=method,
                                sigma=sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # Ties decided, something decayed, invalid candidates never picked.
    assert (np.diff(scores, axis=-1) == 0).sum() > 100
    assert (got.numpy()[valid] < scores[valid]).sum() > 100
    assert not got.numpy()[~valid].any()


def test_soft_nms_first_index_on_ties():
    """Two identical boxes of equal score: the first is picked at full
    score and the second decays; an unknown method raises."""
    iou = torch.tensor([[[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    scores = torch.tensor([[0.9, 0.9, 0.5]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    got = tpost.soft_nms_scores(iou, scores, valid, "soft_linear")
    assert got.tolist() == [[pytest.approx(0.9), 0.0, pytest.approx(0.5)]]
    got = tpost.soft_nms_scores(iou, scores, valid, "soft_gaussian", 0.5)
    np.testing.assert_allclose(got.numpy(),
                               [[0.9, 0.9 * np.exp(-2.0), 0.5]], rtol=1e-6)
    with pytest.raises(ValueError, match="soft-NMS"):
        tpost.soft_nms_scores(iou, scores, valid, "soft_cubic")


@pytest.mark.parametrize("name", ["two_stage", "exact_eval"])
@pytest.mark.parametrize("method", ["soft_gaussian", "soft_linear"])
def test_soft_postprocess_matches_jax(name, method):
    jcfg, tcfg = _configs()[name]
    jcfg = dataclasses.replace(jcfg, nms_method=method, soft_nms_sigma=0.3)
    tcfg = dataclasses.replace(tcfg, nms_method=method, soft_nms_sigma=0.3)
    offsets, logits = _predictions(seed=11, b=1)
    priors = ssd300_priors()
    want = jpost.postprocess(jnp.asarray(offsets), jnp.asarray(logits),
                             jnp.asarray(priors), jcfg)
    got = tpost.postprocess(torch.from_numpy(offsets),
                            torch.from_numpy(logits),
                            torch.from_numpy(priors), tcfg)
    assert_same_detections(got, want)
    hard = tpost.postprocess(torch.from_numpy(offsets),
                             torch.from_numpy(logits),
                             torch.from_numpy(priors),
                             dataclasses.replace(tcfg, nms_method="hard"))
    # Soft-NMS keeps decayed overlaps that hard NMS drops.
    assert got.valid.sum() > hard.valid.sum()

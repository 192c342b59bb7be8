"""The port's mAP evaluation against the JAX package's: `voc_map`,
`voc_map_sweep` and the PR curves on random detections (to 1e-12), and
`evaluate_records` over SSD300 with the same weights (bridged by
`from_flax_params`) on an 8-image fixture, batch 4, exact postprocess.

Tolerances of `evaluate_records`: valid masks and classes equal, boxes and
scores to 1e-4 absolute (the SSD300 outputs differ by ~1e-5 from the conv
summation order, `test_torch_model.py`), per-class AP to 1e-6.
"""

import dataclasses
import json
import logging.handlers
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu.config import Config as JConfig
from objectdetection_ssd_tpu.data import synthetic as jsynthetic
from objectdetection_ssd_tpu.eval import evaluate as jevaluate
from objectdetection_ssd_tpu.eval import voc_map as jvoc_map
from objectdetection_ssd_tpu.infer.detector import Detector as JDetector
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_torch.config import Config, PostprocessConfig
from objectdetection_ssd_torch.data import voc
from objectdetection_ssd_torch.eval import evaluate, voc_map
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.models.convert import from_flax_params

torch.set_num_threads(2)


def _random_dets(seed, n_images=12):
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("db", "dc", "ds", "gb", "gc", "dif")}
    for _ in range(n_images):
        ng, nd = int(rng.integers(0, 6)), int(rng.integers(0, 30))
        g = rng.random((ng, 2)) * 0.7
        gb = np.concatenate([g, g + 0.05 + rng.random((ng, 2)) * 0.25], 1)
        gc = rng.integers(0, 4, ng)
        # Detections near the ground truth, with jitter, plus noise boxes.
        pick = rng.integers(0, max(ng, 1), nd)
        base = (gb[pick] if ng else rng.random((nd, 4)) * 0.5)
        db = base + rng.normal(0, 0.03, (nd, 4))
        dc = np.where(rng.random(nd) < 0.8, gc[pick] if ng else 0,
                      rng.integers(0, 4, nd))
        ds = rng.random(nd).astype(np.float32)
        ds[: nd // 4] = 0.5                            # score ties
        out["db"].append(db.astype(np.float32))
        out["dc"].append(dc.astype(np.int32))
        out["ds"].append(ds)
        out["gb"].append(gb.astype(np.float32))
        out["gc"].append(gc.astype(np.int32))
        out["dif"].append(rng.random(ng) < 0.2)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_map_and_curves_match_jax(seed):
    d = _random_dets(seed)
    args = (d["db"], d["dc"], d["ds"], d["gb"], d["gc"])
    for kw in ({}, {"difficulties": d["dif"]}, {"iou_threshold": 0.3}):
        aps, m, curves = voc_map.voc_map(*args, return_curves=True, **kw)
        japs, jm, jcurves = jvoc_map.voc_map(*args, return_curves=True, **kw)
        assert aps.keys() == japs.keys()
        for name in aps:
            assert abs(aps[name] - japs[name]) <= 1e-12, name
            for key in ("scores", "precision", "recall"):
                np.testing.assert_allclose(curves[name][key],
                                           jcurves[name][key], rtol=0,
                                           atol=1e-12)
        assert abs(m - jm) <= 1e-12
    assert m > 0                              # the check is not vacuous
    per, mean = voc_map.voc_map_sweep(*args)
    jper, jmean = jvoc_map.voc_map_sweep(*args)
    assert per.keys() == jper.keys() and len(per) == 10
    for thr in per:
        assert abs(per[thr] - jper[thr]) <= 1e-12
    assert abs(mean - jmean) <= 1e-12


def test_eleven_point_ap_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        p, r = rng.random(40), np.sort(rng.random(40))
        assert voc_map.eleven_point_ap(p, r) == jvoc_map.eleven_point_ap(p, r)


def test_exact_eval_postprocess_matches_jax():
    got = evaluate.exact_eval_postprocess(PostprocessConfig())
    want = jevaluate.exact_eval_postprocess(JConfig().postprocess)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name)
    assert got.per_class_top_k == 200 and not got.use_approx_top_k


def test_bounded_map_is_ordered_and_lazy():
    started = []

    def fn(x):
        started.append(x)
        return x * 2

    with ThreadPoolExecutor(max_workers=4) as pool:
        gen = evaluate._bounded_map(pool, fn, range(100), window=6)
        first = next(gen)
        time.sleep(0.3)
        assert len(started) <= 7
        rest = list(gen)
    assert [first] + rest == [x * 2 for x in range(100)]


# --------------------------------------------------- evaluate_records, SSD300


def _wide_bias_params(seed=0):
    """JAX SSD300 init params with conf-head biases ~ N(0, 3), so many
    candidates clear the 0.2 threshold."""
    params = jax.device_get(jax.jit(JSSD300().init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 300, 300, 3))))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed)
    for i in range(6):
        bias = params[f"conf_head_{i}"]["Conv_0"]["bias"]
        bias[...] = rng.normal(0.0, 3.0, bias.shape)
    return params


def _recording(detector, sink, pull):
    orig = detector.detect_batch

    def detect_batch(images):
        dets = orig(images)
        sink.append(pull(dets))
        return dets

    detector.detect_batch = detect_batch
    return detector


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc8"))
    jsynthetic.generate_voc(root, num_2007=8, num_2012=0,
                            image_size=(160, 120), max_objects=4, seed=4,
                            class_color_coding=True)
    records = voc.load_records(root, train=True)
    params = _wide_bias_params()
    jdets, tdets = [], []
    jdet = _recording(JDetector(JConfig(), params,
                                postprocess_config=jevaluate.
                                exact_eval_postprocess(JConfig().postprocess)),
                      jdets, jax.device_get)
    want = jevaluate.evaluate_records(JConfig(), params, records,
                                      batch_size=4, detector=jdet,
                                      iou_sweep=True)
    tdet = _recording(Detector(Config(), from_flax_params(params),
                               postprocess_config=evaluate.
                               exact_eval_postprocess(PostprocessConfig()),
                               device="cpu"),
                      tdets, lambda d: [t.numpy() for t in d])
    cache = str(tmp_path_factory.mktemp("cache") / "val")
    got = evaluate.evaluate_records(Config(), None, records, batch_size=4,
                                    detector=tdet, iou_sweep=True,
                                    image_cache=cache)
    return records, params, want, got, jdets, tdets, tdet


def test_evaluate_records_detections_match_jax(eval_pair):
    """Rank by rank, except that two detections of one class whose scores
    lie within 1e-4 may trade places (the ranks 1e-6 apart, from the conv
    summation order): each such row must find its box and score among the
    JAX rows of its image and class within 1e-4."""
    *_, jdets, tdets, _ = eval_pair
    assert len(jdets) == len(tdets) == 2
    swapped = total = 0
    for j, (boxes, scores, classes, valid) in zip(jdets, tdets):
        jv = np.asarray(j.valid)
        jb, js = np.asarray(j.boxes_xyxy), np.asarray(j.scores)
        assert jv.sum() > 50
        np.testing.assert_array_equal(valid, jv)
        np.testing.assert_array_equal(classes, np.asarray(j.classes))
        np.testing.assert_allclose(scores[jv], js[jv], rtol=0, atol=1e-4)
        for b, r in np.argwhere(jv):
            total += 1
            if np.abs(boxes[b, r] - jb[b, r]).max() <= 1e-4:
                continue
            swapped += 1
            twins = [q for q in np.flatnonzero(jv[b])
                     if classes[b, q] == classes[b, r]
                     and abs(js[b, q] - scores[b, r]) <= 1e-4
                     and np.abs(jb[b, q] - boxes[b, r]).max() <= 1e-4]
            assert twins, (b, r, scores[b, r])
    assert swapped <= 0.05 * total, (swapped, total)


def test_evaluate_records_ap_matches_jax(eval_pair):
    _, _, want, got, *_ = eval_pair
    aps, m, per_thr, sweep = got
    japs, jm, jper_thr, jsweep = want
    assert aps.keys() == japs.keys()
    for name in aps:
        assert abs(aps[name] - japs[name]) <= 1e-6, name
    assert abs(m - jm) <= 1e-6
    assert per_thr.keys() == jper_thr.keys()
    for thr in per_thr:
        assert abs(per_thr[thr] - jper_thr[thr]) <= 1e-6
    assert abs(sweep - jsweep) <= 1e-6


def test_evaluate_records_decode_equals_cache_and_writes_curves(eval_pair,
                                                                tmp_path):
    records, params, _, got, _, _, tdet = eval_pair
    path = str(tmp_path / "pr.json")
    log = logging.handlers.BufferingHandler(capacity=64)
    level = evaluate.logger.level
    evaluate.logger.addHandler(log)
    evaluate.logger.setLevel(logging.INFO)
    try:
        aps, m = evaluate.evaluate_records(Config(), from_flax_params(params),
                                           records, batch_size=4,
                                           detector=tdet, pr_curves_path=path)
    finally:
        evaluate.logger.removeHandler(log)
        evaluate.logger.setLevel(level)
    assert aps == got[0] and m == got[1]
    # The run's counts, which the chip drive reads from this line.
    assert [r.getMessage().rsplit(",", 1)[0] for r in log.buffer] == [
        "eval: 8 images in 2 batches"]
    with open(path) as f:
        curves = json.load(f)
    assert curves["iou_threshold"] == 0.5 and curves["map"] == m
    assert set(curves["classes"]) == set(aps)

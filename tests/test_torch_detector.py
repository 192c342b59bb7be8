"""The slice as a whole: the JAX `Detector.detect_batch` against the port's
`Detector(device="cpu").detect_batch`, with the same seeded weights through
the bridge, on a uint8 batch of 2.

The conf-head biases are drawn wide (N(0, 3)) so that many candidates clear
the 0.2 threshold and the NMS has overlapping boxes to suppress.

Tolerance: valid masks and classes equal; boxes and scores on the valid
rows to 1e-4 absolute — the model outputs themselves differ by ~1e-5 (conv
summation order, see test_torch_model.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from objectdetection_ssd_tpu.config import Config as JConfig
from objectdetection_ssd_tpu.infer.detector import Detector as JDetector
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_torch.config import Config
from objectdetection_ssd_torch.infer import postprocess as tpost
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.models.convert import from_flax_params

torch.set_num_threads(2)


def wide_bias_params(seed=0):
    """JAX SSD300 init params with conf-head biases ~ N(0, 3)."""
    params = jax.device_get(jax.jit(JSSD300().init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 300, 300, 3))))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed)
    for i in range(6):
        bias = params[f"conf_head_{i}"]["Conv_0"]["bias"]
        bias[...] = rng.normal(0.0, 3.0, bias.shape)
    return params


@pytest.fixture(scope="module")
def detectors():
    params = wide_bias_params()
    jdet = JDetector(JConfig(), params)
    tdet = Detector(Config(), from_flax_params(params), device="cpu")
    return jdet, tdet


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (2, 300, 300, 3),
                                             dtype=np.uint8)


def test_detect_batch_matches_jax(detectors, images):
    jdet, tdet = detectors
    want = jax.device_get(jdet.detect_batch(jnp.asarray(images)))
    got = tdet.detect_batch(images)
    assert got.boxes_xyxy.shape == (2, 200, 4)
    assert got.boxes_xyxy.device.type == "cpu"
    valid = np.asarray(want.valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid], atol=1e-4)


def test_nms_has_work_in_this_slice(detectors, images):
    _, tdet = detectors
    loc, conf = tdet.forward(images)
    cand, _, valid = tpost.select_candidates(loc, conf, tdet.priors,
                                             tdet.pp_config)
    keep = tpost.greedy_nms_mask(tpost.box_ops.pairwise_iou(cand, cand),
                                 valid, tdet.pp_config.nms_iou_threshold)
    assert valid.sum(dim=-1).max() >= 2
    assert (valid & ~keep).any()


def test_detect_images_pads_and_rescales(detectors, tmp_path):
    from PIL import Image
    from objectdetection_ssd_torch.data import pipeline

    _, tdet = detectors
    rng = np.random.default_rng(2)
    paths, sizes = [], [(320, 240), (200, 260)]
    for i, (w, h) in enumerate(sizes):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(path)
        paths.append(str(path))
    out = tdet.detect_images(paths, batch_size=3)
    assert len(out) == 2
    batch = np.stack([pipeline.quantize_uint8(pipeline.preprocess_image(
        pipeline.load_image(p), 300, normalize=False)) for p in paths])
    dets = tdet.detect_batch(batch)
    for i, (w, h) in enumerate(sizes):
        v = dets.valid[i].numpy()
        assert len(out[i]["scores"]) == v.sum() > 0
        np.testing.assert_array_equal(out[i]["classes"],
                                      dets.classes[i].numpy()[v])
        np.testing.assert_allclose(
            out[i]["boxes_xyxy"],
            dets.boxes_xyxy[i].numpy()[v] * np.array([w, h, w, h]),
            rtol=1e-6)
        assert out[i]["labels"].dtype.kind == "U"


def test_detect_images_matches_jax(detectors, tmp_path):
    """F1: `detect_images` resizes through `preprocess_image` (the native
    float resample, as the JAX package does when its library is built), so
    both packages feed the model the same pixels.  Boxes in pixels, so
    1e-4 of the image size."""
    from PIL import Image

    jdet, tdet = detectors
    rng = np.random.default_rng(3)
    paths, sizes = [], [(320, 240), (500, 375)]
    for i, (w, h) in enumerate(sizes):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(path)
        paths.append(str(path))
    want = jdet.detect_images(paths, batch_size=2)
    got = tdet.detect_images(paths, batch_size=2)
    for g, w, (width, height) in zip(got, want, sizes):
        assert len(g["scores"]) == len(w["scores"]) > 10
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g["boxes_xyxy"], w["boxes_xyxy"], rtol=0,
                                   atol=1e-4 * max(width, height))

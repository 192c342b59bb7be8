"""Priors and box ops of the PyTorch port against the JAX package.

Tolerance: the priors are a numpy copy and must be bit-equal.  The box ops
keep the JAX operation order; on f32 inputs they are bit-equal, except
where a transcendental (exp, log) comes from a different library on each
side, which is held to 2 ulp.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from objectdetection_ssd_tpu.config import PriorConfig as JPriorConfig
from objectdetection_ssd_tpu.ops import boxes as jboxes
from objectdetection_ssd_tpu.ops import priors as jpriors
from objectdetection_ssd_torch.config import ModelConfig, PriorConfig
from objectdetection_ssd_torch.ops import boxes as tboxes
from objectdetection_ssd_torch.ops import priors as tpriors

torch.set_num_threads(2)


def _rand_xyxy(rng, shape):
    lo = rng.uniform(0.0, 0.8, shape + (2,))
    wh = rng.uniform(0.01, 0.4, shape + (2,))
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _rand_cxcywh(rng, shape):
    cxy = rng.uniform(0.05, 0.95, shape + (2,))
    wh = rng.uniform(0.02, 0.6, shape + (2,))
    return np.concatenate([cxy, wh], -1).astype(np.float32)


def test_priors_bit_equal():
    got = tpriors.ssd300_priors()
    want = jpriors.ssd300_priors()
    assert got.shape == (8732, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpriors.priors_for_model(ModelConfig()),
                                  want)


def test_priors_custom_config_bit_equal():
    kw = dict(feature_map_sizes=(4, 2), scales=(0.3, 0.6),
              aspect_ratios=((1.0, 2.0), (1.0, 0.5, 3.0)))
    np.testing.assert_array_equal(
        tpriors.ssd300_priors(PriorConfig(**kw)),
        jpriors.ssd300_priors(JPriorConfig(**kw)))
    assert PriorConfig().num_priors == 8732


@pytest.mark.parametrize("name", ["cxcywh_to_xyxy", "xyxy_to_cxcywh",
                                  "area"])
def test_converters_bit_equal(name):
    x = _rand_xyxy(np.random.default_rng(1), (3, 50))
    got = getattr(tboxes, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jboxes, name)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_encode_decode_match_jax():
    rng = np.random.default_rng(2)
    priors = _rand_cxcywh(rng, (200,))
    boxes = _rand_cxcywh(rng, (2, 200))
    offsets = rng.normal(0, 1.5, (2, 200, 4)).astype(np.float32)
    got_e = tboxes.encode(torch.from_numpy(boxes),
                          torch.from_numpy(priors)).numpy()
    want_e = np.asarray(jboxes.encode(jnp.asarray(boxes),
                                      jnp.asarray(priors)))
    np.testing.assert_array_equal(got_e[..., :2], want_e[..., :2])
    np.testing.assert_array_max_ulp(got_e[..., 2:], want_e[..., 2:],
                                    maxulp=2)
    got_d = tboxes.decode(torch.from_numpy(offsets),
                          torch.from_numpy(priors)).numpy()
    want_d = np.asarray(jboxes.decode(jnp.asarray(offsets),
                                      jnp.asarray(priors)))
    np.testing.assert_array_equal(got_d[..., :2], want_d[..., :2])
    np.testing.assert_array_max_ulp(got_d[..., 2:], want_d[..., 2:],
                                    maxulp=2)


def test_pairwise_iou_bit_equal():
    rng = np.random.default_rng(3)
    a = _rand_xyxy(rng, (2, 20, 64))
    b = _rand_xyxy(rng, (2, 20, 48))
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2, 20, 64, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    got_i = tboxes.pairwise_intersection(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
    want_i = np.asarray(jboxes.pairwise_intersection(jnp.asarray(a),
                                                     jnp.asarray(b)))
    np.testing.assert_array_equal(got_i, want_i)

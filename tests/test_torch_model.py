"""SSD300 of the PyTorch port against the JAX `SSD300`, with the same
weights through `from_flax_params`.

Tolerances: the full model in f32 to rtol 1e-4 / atol 5e-5 on outputs of
magnitude ~5 — XLA and oneDNN sum the conv products (up to 4608 terms per
output, 23 convs deep) in different orders.  The layer tests at narrow
widths hold each geometry hazard to rtol 1e-5 / atol 1e-6 (max pool,
flatten and the uint8 normalization are exact).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from objectdetection_ssd_tpu.models import layers as jlayers
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.models.ssd import prepare_input as jprepare
from objectdetection_ssd_torch.config import ModelConfig
from objectdetection_ssd_torch.models import layers as tlayers
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.ssd import (SSD300, build_model,
                                                  prepare_input)

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def full_models():
    """JAX SSD300 params + outputs on one uint8 image at full width (300 px,
    8732 priors), and the port loaded from the same params."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    jmodel = JSSD300()
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3))))
    jloc, jconf = jax.device_get(jax.jit(jmodel.apply)(variables,
                                                       jnp.asarray(x)))
    model = build_model(ModelConfig(), device="cpu")
    model.load_state_dict(from_flax_params(variables), strict=True)
    return x, variables, np.asarray(jloc), np.asarray(jconf), model


def test_from_flax_params_loads_strict(full_models):
    _, variables, _, _, model = full_models
    sd = from_flax_params(variables["params"])
    assert set(sd) == set(model.state_dict())
    k = variables["params"]["trunk"]["conv_fc6"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(sd["trunk.conv_fc6.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    fresh = SSD300()
    fresh.load_state_dict(sd, strict=True)
    missing = dict(sd)
    missing.pop("conf_head_5.bias")
    with pytest.raises(RuntimeError, match="conf_head_5.bias"):
        fresh.load_state_dict(missing, strict=True)
    with pytest.raises(KeyError):
        from_flax_params({"seq8_1": {"Conv_0": {"kernel_q": np.zeros(1)}}})


def test_ssd300_forward_matches_jax_full_width(full_models):
    x, _, jloc, jconf, model = full_models
    with torch.inference_mode():
        loc, conf = model(torch.from_numpy(x))
    assert loc.shape == (1, 8732, 4) and conf.shape == (1, 8732, 21)
    assert loc.dtype == conf.dtype == torch.float32
    np.testing.assert_allclose(loc.numpy(), jloc, rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=1e-4, atol=5e-5)


def test_random_init_matches_flax_statistics():
    model = SSD300(generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(model.l2norm_4_3.scale.detach().numpy(),
                                  np.full(512, 20.0, np.float32))
    for i in range(6):
        assert not model.get_submodule(f"conf_head_{i}").bias.any()
    w = model.trunk.conv3_1.weight.detach()
    # lecun_normal: std sqrt(1/fan_in), truncated at 2 std of the base.
    assert abs(w.std().item() - (1 / (128 * 9)) ** 0.5) < 2e-3
    again = SSD300(generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, again.trunk.conv3_1.weight)


def test_prepare_input_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = prepare_input(torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 3, 5, 7)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jprepare(jnp.asarray(x), jnp.float32))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    xf = rng.normal(size=(1, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(prepare_input(torch.from_numpy(xf), torch.float32)), xf)


@pytest.mark.parametrize("size,window,stride,padding,ceil_mode", [
    (75, 2, 2, 0, True),      # pool3: 75 -> 38, ceil mode
    (7, 2, 2, 0, True),
    (38, 2, 2, 0, False),     # pool4: 38 -> 19
    (19, 3, 1, 1, False),     # pool5: 3x3/s1/p1, -inf padding
])
def test_max_pool_geometry_matches_jax(size, window, stride, padding,
                                       ceil_mode):
    rng = np.random.default_rng(size)
    x = -np.abs(rng.normal(size=(2, size, size, 5))).astype(np.float32)
    want = np.asarray(jlayers.max_pool(jnp.asarray(x), window, stride,
                                       padding=padding, ceil_mode=ceil_mode))
    got = _nhwc(tlayers.max_pool(_nchw(x), window, stride, padding=padding,
                                 ceil_mode=ceil_mode))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2norm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 6, 16)).astype(np.float32)
    scale = rng.uniform(5, 25, 16).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jlayers.L2Norm().apply({"params": {"scale": jnp.asarray(scale)}},
                                  jnp.asarray(x).astype(jdt))
    want = np.asarray(want.astype(jnp.float32))
    layer = tlayers.L2Norm(16)
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(scale))
    tdt = getattr(torch, dtype)
    got = _nhwc(layer(_nchw(x).to(tdt)).float())
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_l2norm_is_not_normalize_clamp():
    layer = tlayers.L2Norm(4, scale_init=1.0)
    with torch.no_grad():
        out = layer(torch.zeros(1, 4, 2, 2))
        tiny = layer(torch.full((1, 4, 1, 1), 1e-7))
    assert torch.equal(out, torch.zeros(1, 4, 2, 2))
    # sqrt(sum + eps), where F.normalize would divide by max(norm, eps).
    np.testing.assert_allclose(tiny.numpy().ravel(),
                               1e-7 / np.sqrt(4e-14 + 1e-12), rtol=1e-5)


def test_flatten_head_row_order_matches_jax():
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    want = np.asarray(jlayers.flatten_head(jnp.asarray(x), 4))
    got = tlayers.flatten_head(_nchw(x), 4).numpy()
    assert got.shape == (2, 3 * 4 * 3, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel,stride,padding,dilation,size", [
    (3, 1, 4, 4, 19),         # conv_fc6: atrous, dilation 4, padding 4
    (1, 1, 0, 1, 19),         # conv_fc7 / seqN_1: 1x1
    (3, 2, 1, 1, 19),         # seq8_2: 19 -> 10
    (3, 2, 1, 1, 10),         # seq9_2: 10 -> 5
    (3, 1, 0, 1, 5),          # seq10_2: VALID 5 -> 3
    (3, 1, 0, 1, 3),          # seq11_2: VALID 3 -> 1
])
def test_conv_geometry_matches_jax(kernel, stride, padding, dilation, size):
    rng = np.random.default_rng(kernel * 100 + size)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    w = rng.normal(0, 0.2, (kernel, kernel, 8, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    jconv = jlayers.TorchConv(6, kernel=kernel, stride=stride,
                              padding=padding, dilation=dilation)
    want = np.asarray(jconv.apply(
        {"params": {"Conv_0": {"kernel": jnp.asarray(w),
                               "bias": jnp.asarray(b)}}}, jnp.asarray(x)))
    conv = tlayers.TorchConv(8, 6, kernel=kernel, stride=stride,
                             padding=padding, dilation=dilation)
    sd = from_flax_params({"c": {"Conv_0": {"kernel": w, "bias": b}}})
    conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

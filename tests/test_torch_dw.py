"""Kernel K2 of the PyTorch port (`ops/dw_cuda.py`): the filter gradient of
a 3x3/stride-1/pad-1 conv, against the JAX Pallas kernel
`ops/dw_pallas.py:dw_conv3x3p1` (interpret mode on the CPU, as
`tests/test_dw_pallas.py` runs it) and against torch autograd of the plain
conv; the `TorchConv` route; and the kernel's chunk plan.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against the plain version on the card by `chip_smoke.py`.

Tolerances: K2 vs JAX in f32 to 1e-5 of max|dW| (both sum the same exact
products, in another order); the Function's forward and dX to 1e-6 / 1e-5
(the same library convs), its dW to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu.ops import dw_pallas
from objectdetection_ssd_torch.models.backbones import VGG16Trunk
from objectdetection_ssd_torch.models.layers import TorchConv
from objectdetection_ssd_torch.ops import dw_cuda

torch.set_num_threads(2)

SHAPES = [
    (2, 6, 7, 4, 8),     # the shapes of tests/test_dw_pallas.py
    (1, 4, 5, 3, 2),
    (2, 12, 10, 8, 16),
    (1, 9, 11, 3, 12),   # Cin = 3, as conv1_1: 27 tap rows
]


def _inputs(shape, seed=0):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, ci)).astype(np.float32)
    g = rng.normal(0, 1, (n, h, w, co)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("shape", SHAPES)
def test_dw_matches_jax_pallas_kernel(shape):
    x, g = _inputs(shape)
    want = np.asarray(dw_pallas.dw_conv3x3p1(jnp.asarray(x), jnp.asarray(g)))
    before = dw_cuda.launches
    got = dw_cuda.dw_conv3x3p1(torch.from_numpy(x), torch.from_numpy(g))
    assert dw_cuda.launches == before          # the CPU runs the plain version
    assert got.shape == (3, 3, shape[3], shape[4])
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_dw_bf16_inputs_accumulate_in_f32():
    x, g = _inputs((2, 6, 7, 8, 16), seed=1)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    got = dw_cuda.dw_conv3x3p1(xb, gb)
    assert got.dtype == torch.float32
    want = dw_cuda.dw_conv3x3p1_plain(xb.float(), gb.float())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("x,g,err", [
    (torch.zeros(2, 4, 4, 3), torch.zeros(2, 4, 5, 6), ValueError),
    (torch.zeros(4, 4, 3), torch.zeros(4, 4, 6), ValueError),
    (torch.zeros(2, 4, 4, 3), torch.zeros(2, 4, 4, 6, dtype=torch.bfloat16),
     TypeError),
    (torch.zeros(2, 4, 4, 3, dtype=torch.float16),
     torch.zeros(2, 4, 4, 6, dtype=torch.float16), TypeError),
    (torch.zeros(2, 3, 4, 4).permute(0, 2, 3, 1), torch.zeros(2, 4, 4, 6),
     ValueError),
])
def test_dw_rejects_what_the_kernel_does_not_take(x, g, err):
    with pytest.raises(err):
        dw_cuda.dw_conv3x3p1(x, g)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 300, 300, 3, 64), (2, 300, 300, 64, 64), (2, 150, 150, 64, 128),
    (2, 150, 150, 128, 128), (32, 300, 300, 64, 64), (3, 37, 41, 5, 7),
    (1, 1, 1, 1, 1), (1, 4, 8, 3, 2),
])
def test_chunk_plan_covers_every_pixel_once(n, h, w, cin, cout):
    chunk_pixels, chunks = dw_cuda.chunk_plan(n, h, w, cin, cout)
    pixels = n * h * w
    assert chunk_pixels % dw_cuda.CHUNK_ALIGN == 0
    assert 1 <= chunks <= dw_cuda.MAX_CHUNKS
    assert chunks * chunk_pixels >= pixels > (chunks - 1) * chunk_pixels
    assert chunk_pixels < pixels + dw_cuda.CHUNK_ALIGN
    tiles = -(-9 * cin // dw_cuda.TILE_M) * -(-cout // dw_cuda.TILE_N)
    # Enough blocks to fill the card when there are enough pixels, and a
    # scratch buffer of at most TARGET_BLOCKS tiles.
    assert tiles * chunks <= dw_cuda.TARGET_BLOCKS + tiles
    if pixels >= dw_cuda.CHUNK_ALIGN * dw_cuda.TARGET_BLOCKS:
        assert tiles * chunks >= dw_cuda.TARGET_BLOCKS // 2


@pytest.mark.parametrize("shape,needs_dx", [((2, 6, 7, 4, 8), True),
                                            ((1, 9, 11, 3, 12), False)])
def test_conv3x3p1_function_matches_autograd(shape, needs_dx):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (n, ci, h, w)).astype(np.float32))
    wk = torch.from_numpy(rng.normal(0, 0.2, (co, ci, 3, 3)).astype(
        np.float32))
    gy = torch.from_numpy(rng.normal(0, 1, (n, co, h, w)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)

    xr, wr = x.clone().requires_grad_(needs_dx), wk.clone().requires_grad_()
    ref = F.conv2d(xr, wr, None, 1, 1)
    ref.backward(gy)
    xg, wg = x.clone().requires_grad_(needs_dx), wk.clone().requires_grad_()
    out = dw_cuda.conv3x3p1(xg, wg)
    out.backward(gy)

    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wg.grad, wr.grad, rtol=1e-5, atol=1e-5)
    if needs_dx:
        torch.testing.assert_close(xg.grad, xr.grad, rtol=1e-5, atol=1e-5)
    else:
        assert xg.grad is None


def test_conv3x3p1_counts_layout_copies():
    x = torch.randn(1, 4, 5, 6, requires_grad=False)      # plain NCHW
    wk = torch.randn(3, 4, 3, 3, requires_grad=True)
    before = dw_cuda.layout_copies
    dw_cuda.conv3x3p1(x, wk).sum().backward()
    assert dw_cuda.layout_copies > before
    before = dw_cuda.layout_copies
    xc = x.contiguous(memory_format=torch.channels_last)
    y = dw_cuda.conv3x3p1(xc, wk)
    y.backward(torch.ones_like(y).contiguous(
        memory_format=torch.channels_last))
    assert dw_cuda.layout_copies == before


def test_routed_torchconv_keeps_params_and_values():
    """A routed conv has the unrouted conv's state_dict and computes the
    same forward and gradients; a stride-2 conv ignores the route (the JAX
    `test_torchconv_dw_pallas_routing_and_param_tree`)."""
    torch.manual_seed(0)
    plain = TorchConv(4, 6, kernel=3, padding=1)
    routed = TorchConv(4, 6, kernel=3, padding=1, dw_pallas=True)
    routed.load_state_dict(plain.state_dict(), strict=True)
    assert routed.dw_route and not plain.dw_route
    assert list(routed.state_dict()) == list(plain.state_dict()) == [
        "weight", "bias"]
    x = torch.randn(2, 4, 8, 8)
    yp, yr = plain(x), routed(x)
    torch.testing.assert_close(yr, yp, rtol=1e-6, atol=1e-6)
    yp.sum().backward()
    yr.sum().backward()
    for a, b in ((plain.weight, routed.weight), (plain.bias, routed.bias)):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-4, atol=1e-5)

    for geometry in (dict(stride=2, padding=1), dict(padding=4, dilation=4),
                     dict(kernel=1), dict(padding=0)):
        conv = TorchConv(4, 6, dw_pallas=True, **{"kernel": 3, **geometry})
        assert not conv.dw_route, geometry
    strided = TorchConv(4, 6, kernel=3, padding=1, stride=2, dw_pallas=True)
    assert strided(x).shape == (2, 6, 4, 4)


def test_torchconv_casts_params_to_the_input_dtype():
    conv = TorchConv(4, 6, kernel=3, padding=1, dw_pallas=True)
    x = torch.randn(1, 4, 5, 5).bfloat16()
    y = conv(x)
    assert y.dtype == torch.bfloat16
    assert conv.weight.dtype == torch.float32
    y.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32


def test_vgg_trunk_routes_exactly_the_named_convs():
    trunk = VGG16Trunk(dw_pallas_convs=("conv1_2", "conv2_1", "conv_fc6"))
    routed = {n for n, m in trunk.named_modules()
              if isinstance(m, TorchConv) and m.dw_route}
    assert routed == {"conv1_2", "conv2_1"}       # fc6 is dilated
    assert list(trunk.state_dict()) == list(VGG16Trunk().state_dict())

"""Kernel K2 of the PyTorch port (`ops/dw_cuda.py`): the filter gradient of
a 3x3/stride-1/pad-1 conv, against the JAX Pallas kernel
`ops/dw_pallas.py:dw_conv3x3p1` (interpret mode on the CPU, as
`tests/test_dw_pallas.py` runs it) and against torch autograd of the plain
conv; the `TorchConv` route; and the kernel's launch plan, whose halo
tiles are summed here in plain PyTorch as the halo kernel sums them.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against the plain version on the card by `chip_smoke.py`.

Tolerances: K2 vs JAX in f32 to 1e-5 of max|dW| (both sum the same exact
products, in another order); the Function's forward and dX to 1e-6 / 1e-5
(the same library convs), its dW to 1e-5 relative; the halo plan's tile
sums vs JAX to 1e-5 of max|dW| (the same exact products, another order).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu.ops import dw_pallas
from objectdetection_ssd_torch import cuda_build
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
    (1, 1, 1, 1, 1), (1, 4, 8, 3, 2), (32, 300, 300, 3, 64),
    (32, 150, 150, 64, 128), (32, 150, 150, 128, 128), (2, 19, 45, 24, 40),
])
def test_chunk_plan_covers_every_pixel_once(n, h, w, cin, cout):
    """Both dtypes' plans, for aligned tensors and not: the right kernel
    and instantiation, every pixel in exactly one chunk (gather) or spatial
    tile (halo), halo reads inside the tile's own image or zero-filled, and
    a partial buffer under MAX_PARTIAL_BYTES."""
    pixels = n * h * w
    for dtype, aligned in itertools.product((torch.float32, torch.bfloat16),
                                            (True, False)):
        plan = dw_cuda.plan(n, h, w, cin, cout, dtype, aligned=aligned)
        halo = (dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
                and aligned)
        assert plan.kernel == ("halo" if halo else "gather")
        assert plan.chunks * 9 * cin * cout * 4 <= dw_cuda.MAX_PARTIAL_BYTES
        assert 1 <= plan.chunks <= dw_cuda.MAX_CHUNKS
        if halo:
            _check_halo_plan(plan, n, h, w, cin, cout)
            continue
        _check_gather_instantiation(plan, cin, cout, dtype, aligned)
        chunk_pixels, chunks = plan.chunk_pixels, plan.chunks
        assert (chunk_pixels, chunks) == dw_cuda.chunk_plan(n, h, w, cin, cout)
        assert chunk_pixels % dw_cuda.CHUNK_ALIGN == 0
        assert chunks * chunk_pixels >= pixels > (chunks - 1) * chunk_pixels
        assert chunk_pixels < pixels + dw_cuda.CHUNK_ALIGN
        tiles = -(-9 * cin // dw_cuda.TILE_M) * -(-cout // dw_cuda.TILE_N)
        # Enough blocks to fill the card when there are enough pixels, and
        # a scratch buffer of at most TARGET_BLOCKS tiles.
        assert tiles * chunks <= dw_cuda.TARGET_BLOCKS + tiles
        if pixels >= dw_cuda.CHUNK_ALIGN * dw_cuda.TARGET_BLOCKS:
            assert tiles * chunks >= dw_cuda.TARGET_BLOCKS // 2


def _check_gather_instantiation(plan, cin, cout, dtype, aligned):
    """The tap-gather instantiation that `ssd_dw_conv3x3` accepts and has
    built: 16-byte loads (4 f32 or 8 bf16) of an operand only where its
    channels and the alignment allow, staged x with element loads for
    Cin <= MAX_STAGED_CIN, and never bf16 with 16-byte loads of both
    (the halo kernel's case)."""
    vec = 8 if dtype == torch.bfloat16 else 4
    assert plan.vec_a in (1, vec) and plan.vec_b in (1, vec)
    assert plan.staged == (cin <= dw_cuda.MAX_STAGED_CIN)
    assert (plan.vec_a == vec) == (aligned and cin % vec == 0
                                   and not plan.staged)
    assert (plan.vec_b == vec) == (aligned and cout % vec == 0)
    assert not (dtype == torch.bfloat16 and plan.vec_a == plan.vec_b == vec)


def _tile_origin(t, h, w, tile_h, tile_w):
    """``(image, h0, w0)`` of spatial tile ``t``: image-major, then
    row-major, the order `dw_halo_kernel` decodes."""
    tiles_w = -(-w // tile_w)
    img, rem = divmod(t, -(-h // tile_h) * tiles_w)
    tr, tc = divmod(rem, tiles_w)
    return img, tr * tile_h, tc * tile_w


def _check_halo_plan(plan, n, h, w, cin, cout):
    th, tw = plan.tile_h, plan.tile_w
    assert (th, tw) == dw_cuda.HALO_TILE and tw % 16 == 0
    tiles = n * -(-h // th) * -(-w // tw)
    per_chunk = -(-cin // dw_cuda.HALO_CI) * -(-cout // dw_cuda.HALO_CO)
    tpc = plan.tiles_per_chunk
    assert plan.chunks * tpc >= tiles > (plan.chunks - 1) * tpc
    if tiles >= dw_cuda.HALO_TARGET_BLOCKS:
        assert plan.chunks * per_chunk >= dw_cuda.HALO_TARGET_BLOCKS // 2
    origin = np.array([_tile_origin(t, h, w, th, tw)
                       for t in range(tiles)])
    img, h0, w0 = origin[:, 0, None, None], origin[:, 1, None, None], \
        origin[:, 2, None, None]
    assert (img < n).all() and (h0 < h).all() and (w0 < w).all()
    # The g tile: every pixel of every image exactly once.
    hh = h0 + np.arange(th)[None, :, None]
    ww = w0 + np.arange(tw)[None, None, :]
    inside = (hh < h) & (ww < w)
    count = np.zeros(n * h * w, np.int64)
    np.add.at(count, ((img * h + hh) * w + ww)[inside], 1)
    assert (count == 1).all()
    # The x halo: what the kernel copies lies in the tile's own image;
    # the rest (rows -1 and h, columns -1 and w) is zero-filled.
    hh = h0 - 1 + np.arange(th + 2)[None, :, None]
    ww = w0 - 1 + np.arange(tw + 2)[None, None, :]
    read = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
    flat = np.broadcast_to((img * h + hh) * w + ww, read.shape)[read]
    own = np.broadcast_to(img, read.shape)[read]
    assert (flat >= own * h * w).all() and (flat < (own + 1) * h * w).all()
    zero = ~read
    assert (zero == ((hh < 0) | (hh >= h) | (ww < 0) | (ww >= w))).all()


def _halo_plan_sum(x, g, plan):
    """The halo kernel's arithmetic in plain PyTorch: per chunk, per
    spatial tile, a zero-filled (TH+2) x (TW+2) halo of x and a TH x TW
    tile of g, nine shifted products; the chunks summed in order."""
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    th, tw = plan.tile_h, plan.tile_w
    tiles = n * -(-h // th) * -(-w // tw)
    total = torch.zeros(9, cin, cout)
    for chunk in range(plan.chunks):
        part = torch.zeros(9, cin, cout)
        first = chunk * plan.tiles_per_chunk
        for t in range(first, min(first + plan.tiles_per_chunk, tiles)):
            img, h0, w0 = _tile_origin(t, h, w, th, tw)
            hh = torch.arange(h0 - 1, h0 + th + 1)
            ww = torch.arange(w0 - 1, w0 + tw + 1)
            read = ((hh >= 0) & (hh < h))[:, None] & ((ww >= 0) & (ww < w))
            halo = x[img][hh.clamp(0, h - 1)][:, ww.clamp(0, w - 1)]
            halo = halo * read[..., None]
            tile = g[img][hh[1:-1].clamp(max=h - 1)][:, ww[1:-1].clamp(
                max=w - 1)] * read[1:-1, 1:-1, None]
            gm = tile.reshape(th * tw, cout)
            for ky in range(3):
                for kx in range(3):
                    xs = halo[ky:ky + th, kx:kx + tw].reshape(th * tw, cin)
                    part[3 * ky + kx] += xs.T @ gm
        total += part
    return total.reshape(3, 3, cin, cout)


@pytest.mark.parametrize("shape", [
    (2, 6, 7, 8, 16),      # smaller than one tile in both
    (1, 19, 45, 24, 40),   # tile 4 x 32, W and Cout not multiples of theirs
    (2, 12, 10, 8, 16),
    (1, 9, 33, 8, 8),      # one column past a whole tile
])
def test_halo_plan_tiles_sum_to_jax_dw(shape):
    n, h, w, ci, co = shape
    plan = dw_cuda.plan(n, h, w, ci, co, torch.bfloat16)
    assert plan.kernel == "halo"
    x, g = _inputs(shape, seed=4)
    want = np.asarray(dw_pallas.dw_conv3x3p1(jnp.asarray(x), jnp.asarray(g)))
    got = _halo_plan_sum(torch.from_numpy(x), torch.from_numpy(g), plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_ptxas_report_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dw_halo_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114dw_halo_kernelEPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""
    rows = cuda_build.ptxas_report(log)
    assert [r["function"] for r in rows] == [
        "_ZN12_GLOBAL__N_114dw_halo_kernelEPK13__nv_bfloat16", "_Z1kv"]
    assert [(r["registers"], r["spill_stores"], r["spill_loads"])
            for r in rows] == [(168, 0, 0), (255, 12, 16)]


@pytest.mark.parametrize("shape", [(2, 300, 300, 64, 64), (2, 19, 45, 24, 40),
                                   (2, 150, 150, 64, 128)])
def test_unaligned_bf16_takes_the_gather_with_element_loads(shape):
    """A bf16 view that does not start on a 16-byte boundary cannot take
    the halo kernel's 16-byte copies: the plan, which the wrapper makes
    from the tensors' addresses, gives it the tap gather with one-element
    loads, and the wrapper's result is still the plain version's."""
    n, h, w, ci, co = shape
    aligned = dw_cuda.plan(n, h, w, ci, co, torch.bfloat16)
    plan = dw_cuda.plan(n, h, w, ci, co, torch.bfloat16, aligned=False)
    assert aligned.kernel == "halo"
    assert (plan.kernel, plan.vec_a, plan.vec_b, plan.staged) == (
        "gather", 1, 1, False)
    x = torch.randn(2 * 5 * 7 * ci + 1).bfloat16()[1:].view(2, 5, 7, ci)
    g = torch.randn(2 * 5 * 7 * co + 1).bfloat16()[1:].view(2, 5, 7, co)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    torch.testing.assert_close(dw_cuda.dw_conv3x3p1(x, g),
                               dw_cuda.dw_conv3x3p1_plain(x, g), rtol=0,
                               atol=0)


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


@pytest.mark.parametrize("shape", [(2, 6, 7, 4, 8), (1, 9, 11, 3, 12),
                                   (2, 12, 10, 8, 16)])
def test_conv3x3p1_dx_stays_channels_last(shape):
    """dX of a channels_last x is channels_last and equals `F.conv2d`'s own
    autograd dX to 1e-6 of its largest value; dW is still K2's plain
    version.  The gradients are read with `torch.autograd.grad`, which
    hands back what the Function returned (a leaf's ``.grad`` would be
    copied into the leaf's layout)."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(3)
    cl = torch.channels_last
    x = torch.from_numpy(rng.normal(0, 1, (n, ci, h, w)).astype(
        np.float32)).contiguous(memory_format=cl).requires_grad_()
    wk = torch.from_numpy(rng.normal(0, 0.2, (co, ci, 3, 3)).astype(
        np.float32)).requires_grad_()
    gy = torch.from_numpy(rng.normal(0, 1, (n, co, h, w)).astype(
        np.float32)).contiguous(memory_format=cl)

    want_dx, = torch.autograd.grad(F.conv2d(x, wk, None, 1, 1), x, gy)
    dx, dw = torch.autograd.grad(dw_cuda.conv3x3p1(x, wk), (x, wk), gy)

    assert dx.is_contiguous(memory_format=cl)
    scale = float(want_dx.abs().max())
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=1e-6 * scale)
    want_dw = dw_cuda.dw_conv3x3p1_plain(x.detach().permute(0, 2, 3, 1),
                                         gy.permute(0, 2, 3, 1))
    torch.testing.assert_close(dw, want_dw.permute(3, 2, 0, 1), rtol=0,
                               atol=0)


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

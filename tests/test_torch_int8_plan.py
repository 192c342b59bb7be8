"""Kernel K3's launch plan and index math (`ops/int8_conv.py`), on the CPU.

The CUDA kernel (`csrc/int8_conv.cu`) runs only on the card, where
`chip_smoke.py` holds it bit for bit against `int8_conv_plain`.  These
tests cover the Python half of its indexing and numpy mirrors of the
kernel's own index arithmetic:
  * `plan` at every conv shape of SSD300 and ResNet-34 (heads included)
    at batch 2 and 32, and at ragged and unaligned shapes: the ``vec``
    path exactly for aligned tensors with Cin % 16 == 0; block tiles (for
    ``rows``, output patches mapped to rows as the kernel maps them) that
    cover every (m, cout) exactly once; shared bytes as the C entry counts
    them, within the card's 227 KB; an instantiation the source has;
  * the rows path: the input window staged as the kernel stages it (32-bit
    aligned loads realigned by a funnel shift, masked to the image, from
    tensors 0-3 bytes past a word boundary), read through `row_table`,
    reproduces `F.unfold`'s im2col bit for bit, K padded with zeros; its
    products equal XLA's int8 conv (`lax.conv_general_dilated` to int32, as
    the JAX `Int8Conv` computes it) exactly;
  * the vec path's tap walk (r, s, ci advanced by additions per K step)
    agrees with the division it replaces;
  * the epilogue's requantize shortcut (a multiply by 1 / out_scale, the
    IEEE division only next to a tie) gives the division's integers.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_torch.config import ModelConfig
from objectdetection_ssd_torch.models.layers import TorchConv
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops import int8_conv as k3

torch.set_num_threads(2)

# (N, Cin, H, W, Cout, kernel, stride, padding, dilation), as
# `chip_smoke.py` lists them: ragged shapes, unaligned ones, and the ones
# that reach each instantiation.
RAGGED = ((2, 3, 37, 41, 126, 3, 2, 1, 1), (2, 16, 13, 9, 189, 3, 1, 1, 1),
          (3, 8, 13, 7, 24, 3, 2, 1, 1), (1, 64, 5, 7, 189, 1, 1, 0, 1),
          (2, 48, 11, 11, 84, 3, 1, 4, 4), (2, 32, 9, 11, 63, 3, 1, 1, 1),
          (2, 80, 7, 9, 129, 3, 2, 1, 1), (2, 5, 29, 31, 70, 7, 2, 3, 1),
          (2, 3, 23, 27, 33, 3, 1, 2, 2))
UNALIGNED = ((2, 64, 19, 23, 40, 3, 1, 1, 1), (1, 32, 17, 15, 65, 3, 1, 4, 4))


def _model_shapes():
    """Every conv shape (Cin, H, W, Cout, k, stride, pad, dil) of one
    SSD300 and one ResNet-34 forward, heads included."""
    shapes = set()
    for cfg, size in ((ModelConfig(), 300),
                      (ModelConfig(backbone="resnet34", image_size=224), 224)):
        model = build_model(cfg, device="cpu")
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: shapes.add(
                tuple(args[0].shape[1:]) + (mod.out_channels,
                                            mod.kernel_size[0],
                                            mod.stride[0], mod.padding[0],
                                            mod.dilation[0])))
                 for m in model.modules() if isinstance(m, TorchConv)]
        with torch.inference_mode():
            model(torch.zeros((1, size, size, 3), dtype=torch.uint8))
        for h in hooks:
            h.remove()
    return sorted(shapes)


MODEL_SHAPES = _model_shapes()
PLAN_CASES = ([(n,) + s for s in MODEL_SHAPES for n in (2, 32)]
              + list(RAGGED) + list(UNALIGNED))


def _instantiations():
    """The (path id, BM, BN, WM, WN, stages) rows of `K3_TILES` in the
    CUDA source."""
    src = k3.SOURCE.read_text()
    block = src[src.index("#define K3_TILES(X)"):]
    block = block[:block.index("}  // namespace")]
    return {tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", block)}


def test_tiles_match_the_source_instantiations():
    want = {(k3.PATH_IDS[t[0]],) + t[1:] for t in k3.TILES.values()}
    assert _instantiations() == want


def _geometry(case):
    n, cin, h, w, cout, k, st, pad, dil = case
    return n, h, w, cin, cout, k, k, st, pad, dil


def _smem(p, cin, k, st, dil):
    """Dynamic shared bytes as `ssd_int8_conv` counts them."""
    bk = 64 if p.path == "vec" else 32
    ring = p.stages * (p.bm + p.bn) * (bk + 16) + p.bm * 8
    if p.path == "vec":
        return ring
    rows = (p.tile_h - 1) * st + (k - 1) * dil + 1
    cols = (p.tile_w - 1) * st + (k - 1) * dil + 1
    return ring + p.kp * 4 + rows * (-(-cols * cin // 4) * 4)


def _block_rows(p, n, ho, wo):
    """Output pixel m of every (block, tile row), -1 where masked, as the
    kernel's `row_m` table holds them: (grid.x, BM)."""
    r = np.arange(p.bm)
    b = np.arange(p.grid[0])[:, None]
    if p.path == "vec":
        m = b * p.bm + r[None, :]
        return np.where(m < n * ho * wo, m, -1)
    tiles_w = -(-wo // p.tile_w)
    tiles = -(-ho // p.tile_h) * tiles_w
    img, t = b // tiles, b % tiles
    oh0, ow0 = (t // tiles_w) * p.tile_h, (t % tiles_w) * p.tile_w
    th, tw = r[None, :] // p.tile_w, r[None, :] % p.tile_w
    oh, ow = oh0 + th, ow0 + tw
    ok = (th < p.tile_h) & (oh < ho) & (ow < wo)
    return np.where(ok, (img * ho + oh) * wo + ow, -1)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                         "unaligned"])
@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_covers_the_output_once(case, aligned):
    n, cin, h, w, cout, k, st, pad, dil = case
    if case in UNALIGNED:
        aligned = False
    p = k3.plan(*_geometry(case), aligned=aligned)
    assert p.path == ("vec" if aligned and cin % 16 == 0 else "rows")
    assert k3.TILES[p.name] == (p.path, p.bm, p.bn, p.wm, p.wn, p.stages)
    if p.path == "vec":
        assert p.name == ("vec_256x64" if cout <= 64 else "vec_128x128")
    assert p.threads == (p.bm // p.wm) * (p.bn // p.wn) * 32 <= 1024
    assert p.kp % (64 if p.path == "vec" else 32) == 0
    assert 0 <= p.kp - k * k * cin < (64 if p.path == "vec" else 32)
    assert p.smem == _smem(p, cin, k, st, dil) <= k3.MAX_SMEM
    assert p.grid[1] == math.ceil(cout / p.bn) <= 65535
    ho = k3.out_size(h, k, st, pad, dil)
    wo = k3.out_size(w, k, st, pad, dil)
    if p.path == "rows":
        assert 1 <= p.tile_h <= ho and 1 <= p.tile_w <= wo
        assert p.tile_h * p.tile_w <= p.bm
        assert p.pitch % 4 == 0 and p.pitch >= p.staged_cols * cin
    # Every output pixel in exactly one (block, row); every channel in
    # exactly one N tile.
    m = _block_rows(p, n, ho, wo)
    counts = np.bincount(m[m >= 0], minlength=n * ho * wo)
    assert counts.size == n * ho * wo and (counts == 1).all()
    c = np.arange(p.grid[1])[:, None] * p.bn + np.arange(p.bn)[None, :]
    assert (np.bincount(c[c < cout], minlength=cout) == 1).all()


def test_plan_reaches_every_instantiation():
    names = {k3.plan(*_geometry(c), aligned=c not in UNALIGNED).name
             for c in PLAN_CASES}
    assert names == set(k3.TILES)


# ------------------------------------------------------ rows path staging

def _device_memory(x_nhwc: np.ndarray, shift: int):
    """A byte image of device memory holding x's bytes from an offset
    ``shift`` (mod 4) past a word boundary, garbage around it, and the
    byte address of x."""
    raw = x_nhwc.reshape(-1).view(np.uint8)
    xa = 16 + shift
    mem = np.full(-(-(xa + raw.size + 16) // 4) * 4, 0xA5, np.uint8)
    mem[xa:xa + raw.size] = raw
    return mem, xa


def _stage_like_the_kernel(mem, xa, nbytes, p, img, oh0, ow0, h, w, cin,
                           st, pad):
    """The kernel's staging loop in numpy: for every 32-bit word j of
    every staged row, the aligned word at its first byte's address and the
    next one (only where they hold bytes of the row's valid span),
    `__funnelshift_r` by 8 * (address % 4), bytes outside the span
    cleared.  Asserts that no load touches a word without a byte of x."""
    words32 = mem.view("<u4").astype(np.uint64)
    staged = np.zeros((p.staged_rows, p.pitch), np.uint8)
    hs, ws = oh0 * st - pad, ow0 * st - pad
    lo_col, hi_col = max(ws, 0), min(ws + p.staged_cols, w)
    j = np.arange(p.pitch // 4)
    for rr in range(p.staged_rows):
        hi = hs + rr
        if not (0 <= hi < h and lo_col < hi_col):
            continue
        row = (img * h + hi) * w
        g = (row + ws) * cin + 4 * j
        ga, gb = (row + lo_col) * cin, (row + hi_col) * cin
        live = (g < gb) & (g + 4 > ga)
        addr = xa + g
        d = addr & 3
        w0 = addr - d
        va, vb = xa + ga, xa + gb
        lo_ok = live & (w0 < vb) & (w0 + 4 > va)
        up_ok = live & (d != 0) & (w0 + 4 < vb) & (w0 + 8 > va)
        for ok, wa in ((lo_ok, w0), (up_ok, w0 + 4)):
            assert ((wa[ok] + 4 > xa) & (wa[ok] < xa + nbytes)).all()
        lo = np.where(lo_ok, words32[np.where(lo_ok, w0, 0) // 4], 0)
        up = np.where(up_ok, words32[np.where(up_ok, w0 + 4, 0) // 4], 0)
        v = ((up << np.uint64(32)) | lo) >> (np.uint64(8) * d.astype(
            np.uint64))
        b = np.stack([(v >> np.uint64(8 * e)) & np.uint64(0xFF)
                      for e in range(4)], 1).astype(np.uint8)
        e = g[:, None] + np.arange(4)[None, :]
        b[(e < ga) | (e >= gb) | ~live[:, None]] = 0
        staged[rr] = b.reshape(-1)
    return staged.reshape(-1)


def _rows_im2col(x_nhwc: np.ndarray, case, shift: int):
    """The (N*Ho*Wo, Kp) A matrix the rows path builds: each block's
    window staged as the kernel stages it, each tile row read at its
    pixel's offset plus `row_table`'s offset of each k (0 where -1)."""
    n, cin, h, w, cout, k, st, pad, dil = case
    p = k3.plan(*_geometry(case), aligned=False)
    assert p.path == "rows"
    ho = k3.out_size(h, k, st, pad, dil)
    wo = k3.out_size(w, k, st, pad, dil)
    table = k3.row_table(cin, k, k, dil, p.pitch, p.kp)
    mem, xa = _device_memory(x_nhwc, shift)
    rows = _block_rows(p, n, ho, wo)
    tiles_w = -(-wo // p.tile_w)
    tiles = -(-ho // p.tile_h) * tiles_w
    r = np.arange(p.bm)
    th, tw = r // p.tile_w, r % p.tile_w
    pix = np.where(th < p.tile_h, th * st * p.pitch + tw * st * cin, 0)
    a = np.full((n * ho * wo, p.kp), 99, np.int16)
    for blk in range(p.grid[0]):
        img, t = divmod(blk, tiles)
        oh0, ow0 = (t // tiles_w) * p.tile_h, (t % tiles_w) * p.tile_w
        staged = _stage_like_the_kernel(mem, xa, x_nhwc.size, p, img, oh0,
                                        ow0, h, w, cin, st, pad)
        idx = pix[:, None] + np.maximum(table, 0)[None, :]
        tile = np.where(table[None, :] >= 0,
                        staged[idx].view(np.int8).astype(np.int16), 0)
        ok = rows[blk] >= 0
        a[rows[blk][ok]] = tile[ok]
    assert (a != 99).any(axis=1).all()
    return a, k * k * cin


# conv1_1 (300 px, 3x3/1/1, Cin 3), the ResNet-34 stem (224 px, 7x7/2/3),
# Cin 8 at stride 2, dilation 4.
ROWS_CASES = {"conv1_1": (1, 3, 300, 300, 64, 3, 1, 1, 1),
              "stem": (1, 3, 224, 224, 64, 7, 2, 3, 1),
              "cin8_stride2": (2, 8, 37, 29, 24, 3, 2, 1, 1),
              "dilation4": (2, 5, 23, 27, 33, 3, 1, 4, 4)}


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("name", list(ROWS_CASES))
def test_rows_table_reproduces_unfold(name, shift):
    case = ROWS_CASES[name]
    n, cin, h, w, cout, k, st, pad, dil = case
    rng = np.random.default_rng(len(name) + 7 * shift)
    x = rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    a, kk = _rows_im2col(x, case, shift)
    cols = F.unfold(torch.from_numpy(x).permute(0, 3, 1, 2).double(), k,
                    dilation=dil, padding=pad, stride=st)   # (N, Cin*k*k, L)
    # unfold orders K as (ci, r, s); the kernel's w rows are (r, s, ci).
    want = (cols.reshape(n, cin, k * k, -1).permute(0, 3, 2, 1)
            .reshape(-1, kk).numpy())
    np.testing.assert_array_equal(a[:, :kk], want)
    assert (a[:, kk:] == 0).all()


@pytest.mark.parametrize("name", ["cin8_stride2", "dilation4"])
def test_rows_products_equal_xla_int8_conv(name):
    case = ROWS_CASES[name]
    n, cin, h, w, cout, k, st, pad, dil = case
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    w_q = rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)
    a, kk = _rows_im2col(x, case, shift=1)
    acc = a[:, :kk].astype(np.int64) @ w_q.reshape(cout, kk).T.astype(
        np.int64)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_q.transpose(1, 2, 3, 0)), (st, st),
        [(pad, pad), (pad, pad)], rhs_dilation=(dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.reshape(np.asarray(want).shape),
                                  np.asarray(want))


@pytest.mark.parametrize("cin,kw", [(16, 1), (16, 3), (48, 3), (64, 3),
                                    (512, 3), (1024, 1)])
def test_vec_tap_walk_matches_division(cin, kw):
    """The vec loader starts each thread at k = 16 * kc and advances
    (r, s, ci) by 64 bytes per K step without dividing."""
    kh = kw
    for kc in range(4):
        kq = kc * 16
        ci, tap = kq % cin, kq // cin
        r, s = tap // kw, tap % kw
        while kq < kh * kw * cin + 64:
            want_tap, want_ci = divmod(kq, cin)
            assert (r, s, ci) == (want_tap // kw, want_tap % kw, want_ci)
            assert (r < kh) == (kq < kh * kw * cin)
            kq += 64
            ci += 64
            while ci >= cin:
                ci -= cin
                s += 1
                if s == kw:
                    s, r = 0, r + 1


def test_plan_raises_where_no_window_fits():
    with pytest.raises(ValueError, match="no output patch"):
        k3.plan(1, 19, 19, 1024, 1024, 3, 3, 1, 6, 6, aligned=False)


# The shapes of the L1 gap (a 3x3 dilation-6 conv over ~1024 channels,
# 19 x 19: no rows-path window fits in shared memory), (N, H, W, Cin,
# Cout, kh, kw, stride, pad, dil), aligned, and the Cin K3 pads them to;
# and two near the limit that still plan on the rows path as they are
# (fc6 as SSD300 builds it, and dilation 6 over 512 channels).
L1_SHAPES = (((2, 19, 19, 1024, 1024, 3, 3, 1, 6, 6), False, 1024),
             ((2, 19, 19, 1000, 1024, 3, 3, 1, 6, 6), True, 1008),
             ((2, 19, 19, 1000, 1024, 3, 3, 1, 6, 6), False, 1008))
NEAR_L1 = ((2, 19, 19, 512, 1024, 3, 3, 1, 4, 4),
           (2, 19, 19, 512, 1024, 3, 3, 1, 6, 6))


@pytest.mark.parametrize("shape,aligned,cin", L1_SHAPES, ids=str)
def test_launch_plan_pads_where_no_window_fits(shape, aligned, cin):
    with pytest.raises(ValueError, match="no output patch"):
        k3.plan(*shape, aligned=aligned)
    p, padded = k3.launch_plan(*shape, aligned=aligned)
    assert padded == cin
    want = list(shape)
    want[3] = cin
    assert p == k3.plan(*want, aligned=True)
    assert p.path == "vec" and p.smem <= k3.MAX_SMEM


@pytest.mark.parametrize("shape", NEAR_L1, ids=str)
def test_launch_plan_keeps_shapes_that_fit(shape):
    p, padded = k3.launch_plan(*shape, aligned=False)
    assert padded is None
    assert p == k3.plan(*shape, aligned=False) and p.path == "rows"


@pytest.mark.parametrize("cin", [12, 16], ids=["ragged", "whole"])
def test_padded_conv_is_the_same_bits(cin):
    """`pad_channels` to the next multiple of 16 (and one more block of
    16): the plain conv gives the same bits, int8 output too."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randint(-127, 128, (2, cin, 9, 8), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (5, 3, 3, cin), generator=g,
                      dtype=torch.int8)
    scale = torch.rand(5, generator=g) * 1e-2
    bias = torch.randn(5, generator=g)
    for to in (-(-cin // 16) * 16, -(-cin // 16) * 16 + 16):
        xp, wp = k3.pad_channels(x, w, to)
        assert xp.shape == (2, to, 9, 8) and wp.shape == (5, 3, 3, to)
        assert xp.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(xp[:, :cin], x) and not xp[:, cin:].any()
        for out_scale, dtype in ((None, torch.float32),
                                 (None, torch.bfloat16),
                                 (torch.tensor(0.3), torch.float32)):
            want = k3.int8_conv(x, w, scale, bias, 1, 6, 6, dtype,
                                out_scale)
            got = k3.int8_conv(xp, wp, scale, bias, 1, 6, 6, dtype,
                               out_scale)
            assert got.dtype == want.dtype and torch.equal(got, want)


# --------------------------------------------------- requantize shortcut

def _requantize_like_the_kernel(y: np.ndarray,
                                so: np.float32) -> np.ndarray:
    """`csrc/int8_conv.cu`'s requantize in numpy (f32 operations round to
    nearest even, as the card's _rn intrinsics; f64 where the kernel uses
    f64): the shortcut clip(rint(y * rn(1 / so))), and, where it flags an
    element as near a tie, `requantize_tie`'s decision between the
    midpoints around the half integer h."""
    f32, f64 = np.float32, np.float64
    rso = f32(1) / so
    t = y * rso
    q = np.rint(t)
    near = (np.abs(t - q) > f32(0.5) - f32(1 / 16384)) & (np.abs(t) < 127)
    out = np.clip(q, -127, 127)
    a = np.abs(y[near])
    ta = a * rso
    qa = np.rint(ta)
    h = np.where(ta > qa, qa + f32(0.5), qa - f32(0.5)).astype(f32)
    b_hi = 0.5 * (h.astype(f64) + np.nextafter(h, f32(np.inf)).astype(f64))
    b_lo = 0.5 * (h.astype(f64) + np.nextafter(h, f32(0)).astype(f64))
    r = np.rint(h)
    r = np.where(a.astype(f64) > b_hi * f64(so), h + f32(0.5), r)
    r = np.where(a.astype(f64) < b_lo * f64(so), h - f32(0.5), r)
    out[near] = np.copysign(r, y[near])
    return out, int(near.sum())


@pytest.mark.parametrize("so", [1.0, 3.0, 0.3, 0.1, 1 / 3, 7.1e-3, 0.0713,
                                1e-12, 2.5e3])
def test_requantize_shortcut_is_exact(so):
    """The kernel's requantize gives clip(rint(rn(y / so))) bit for bit:
    on random y over the int8 range and beyond, on y placed on and next
    to every half integer of the quotient (the ties it resolves without
    dividing), and on y of bf16 precision (mode 3, where the quotient
    takes few values and ties are common)."""
    so = np.float32(so)
    rng = np.random.default_rng(int(so * 1000) % 1000)
    y_rand = (rng.standard_normal(1 << 20) * 80 * so).astype(np.float32)
    y_bf16 = torch.from_numpy(y_rand).bfloat16().float().numpy()
    half = (np.arange(-260, 261, dtype=np.float32) + np.float32(0.5)) * so
    ties, up, down = [half], half, half
    for _ in range(3):          # and 1-3 ulps of y to either side
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        ties += [up, down]
    y = np.concatenate([y_rand, y_bf16] + ties).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        want = np.clip(np.rint(y / so), -127, 127)
        got, near = _requantize_like_the_kernel(y, so)
    np.testing.assert_array_equal(got, want)
    assert near > 0

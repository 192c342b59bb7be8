"""K5, the max pool over ``channels_last`` maps (`ops/max_pool.py`,
`csrc/max_pool.cu`), and the route through it in `models/layers.py:
max_pool`.

On the CPU the op ``ssd::max_pool`` is the plain version (``F.max_pool2d``,
int8 through f16); the kernel runs only on the card, where
`chip_smoke.py` holds it bit for bit against `max_pool_plain`.  Here
`kernel_rule` mirrors the kernel's scan in numpy (taps inside the map,
row-major, ``v > m or isnan(v)`` from the lowest value) and stands in for
the launcher, so that the route, the geometry and the rule are held on
the CPU.  Inputs come from numpy seeds.

Tolerances: none.  A max selects one of its inputs, so the plain version,
the mirror and JAX's ``reduce_window`` agree in value exactly (NaN at the
same places; +0.0 and -0.0 compare equal against JAX, whose max need not
keep the first of two zeros), and the mirror agrees with ``F.max_pool2d``
bit for bit, a NaN's payload aside (`_same`).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from objectdetection_ssd_tpu.models import layers as jlayers
from objectdetection_ssd_torch.config import ModelConfig
from objectdetection_ssd_torch.models import layers
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops import max_pool as k5

torch.set_num_threads(2)

# The port's pools (window, stride, padding, ceil_mode): SSD300's 2x2/s2,
# pool3's 2x2/s2 ceil (75 -> 38), pool5's 3x3/s1/p1, ResNet-34's stem
# 3x3/s2/p1.
GEOMETRIES = ((2, 2, 0, False), (2, 2, 0, True), (3, 1, 1, False),
              (3, 2, 1, False))
_IDS = ["2s2", "2s2ceil", "3s1p1", "3s2p1"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def _to_np(t: torch.Tensor) -> np.ndarray:
    """NHWC numpy of an NCHW tensor: int8 as it is, f32 and bf16 as f32
    (bf16 widened by a shift of its bits, NaN payloads kept)."""
    t = t.permute(0, 2, 3, 1).contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().astype(np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return t.numpy()


def _from_np(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of `_to_np`: NCHW in ``channels_last`` memory."""
    if dtype == torch.bfloat16:
        bits = (a.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.permute(0, 3, 1, 2)


def kernel_rule(a: np.ndarray, kernel, stride, padding,
                ceil_mode: bool) -> np.ndarray:
    """K5's scan in numpy on an NHWC array: for each output value the taps
    inside the map in row-major order, each taken when ``v > m`` or ``v``
    is NaN, from -inf (int8: -128)."""
    n, h, w, c = a.shape
    ho = k5.out_size(h, kernel[0], stride[0], padding[0], ceil_mode)
    wo = k5.out_size(w, kernel[1], stride[1], padding[1], ceil_mode)
    low = -128 if a.dtype == np.int8 else -np.inf
    m = np.full((n, ho, wo, c), low, a.dtype)
    oh = np.arange(ho) * stride[0] - padding[0]
    ow = np.arange(wo) * stride[1] - padding[1]
    for i in range(kernel[0]):
        ih = oh + i
        for j in range(kernel[1]):
            iw = ow + j
            v = a[:, np.clip(ih, 0, h - 1)][:, :, np.clip(iw, 0, w - 1)]
            take = (((ih >= 0) & (ih < h))[None, :, None, None]
                    & ((iw >= 0) & (iw < w))[None, None, :, None])
            more = v > m
            if a.dtype != np.int8:
                more |= np.isnan(v)
            m = np.where(take & more, v, m)
    return m


def rule_launch(calls: list):
    """A stand-in for `k5.launch` that runs `kernel_rule` and records each
    call's shape, dtype and geometry."""
    def launch(x, kernel, stride, padding, ceil_mode):
        calls.append((tuple(x.shape), x.dtype, kernel, stride, padding,
                      ceil_mode))
        out = _from_np(kernel_rule(_to_np(x), kernel, stride, padding,
                                   ceil_mode), x.dtype)
        return out.contiguous(memory_format=torch.channels_last)
    return launch


def _map(shape, dtype: torch.dtype, seed: int, specials: bool):
    """An (N, C, H, W) map in ``channels_last`` memory from a numpy seed;
    ``specials`` plants NaN, +-inf and +-0.0 (int8: -127 and 127, and
    whole windows of one value)."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    a = rng.normal(0.0, 2.0, (n, h, w, c)).astype(np.float32)
    if dtype == torch.int8:
        a = np.clip(np.round(a * 30), -127, 127).astype(np.int8)
        if specials:
            a[:, :2, :2] = -127
            a.reshape(-1)[rng.integers(0, a.size, 16)] = 127
    elif specials:
        flat = a.reshape(-1)
        at = rng.permutation(a.size)
        for k, value in enumerate((np.nan, np.inf, -np.inf, 0.0, -0.0)):
            flat[at[k * 8:(k + 1) * 8]] = value
        # Windows of zeros only, of both signs in turn, and of -inf.
        a[:, :3, :3] = np.where(rng.random((n, 3, 3, c)) < 0.5, 0.0, -0.0)
        a[:, -2:, -2:] = -np.inf
    t = torch.from_numpy(a).permute(0, 3, 1, 2)
    return t.to(dtype).contiguous(memory_format=torch.channels_last)


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}[t.dtype]
    return t.contiguous().view(view)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN's payload aside: NaN at the same places.  (The
    CPU's bf16 pool computes in f32 and gives every NaN the canonical
    payload; the card's pool and K5 copy the NaN they take, which
    `chip_smoke.py` holds bit for bit.)"""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.int8:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(_bits(a)[~nan], _bits(b)[~nan]))


# ------------------------------------------------------------ JAX parity

@pytest.mark.parametrize("specials", [False, True], ids=["normal", "special"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=_IDS)
@pytest.mark.parametrize("size", [(7, 9), (12, 11)], ids=["7x9", "12x11"])
def test_matches_jax_and_the_rule(size, geometry, dtype, specials):
    window, stride, padding, ceil_mode = geometry
    tdtype = DTYPES[dtype]
    x = _map((2, 16, *size), tdtype, sum(size) + window, specials)
    plain = k5.max_pool_plain(x, window, stride, padding, ceil_mode)
    routed = layers.max_pool(x, window, stride, padding, ceil_mode)
    op = k5.max_pool(x, window, stride, padding, ceil_mode)
    for got in (routed, op):
        assert got.dtype == tdtype and got.shape == plain.shape
        assert torch.equal(_bits(got), _bits(plain))
    assert op.is_contiguous(memory_format=torch.channels_last)
    # The kernel's rule gives F.max_pool2d's bits: NaN wins, the first of
    # two signed zeros stays.
    rule = kernel_rule(_to_np(x), k5.pair(window), k5.pair(stride),
                       k5.pair(padding), ceil_mode)
    assert _same(_from_np(rule, tdtype), plain)
    # JAX's pool on the same values (int8: reduce_window from INT8_MIN).
    jx = jnp.asarray(_to_np(x), dtype={"float32": jnp.float32,
                                       "bfloat16": jnp.bfloat16,
                                       "int8": jnp.int8}[dtype])
    want = np.asarray(jlayers.max_pool(jx, window, stride, padding,
                                       ceil_mode)).astype(
        np.int8 if dtype == "int8" else np.float32)
    np.testing.assert_array_equal(_to_np(plain), want)
    if specials and dtype != "int8":
        assert np.isnan(want).any() and np.isinf(want).any()
        zeros = _to_np(plain)[_to_np(plain) == 0]
        assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_pool_equals_the_f16_round_trip(dtype):
    """The kernel pools int8 natively; the plain version goes through
    f16.  Both equal the max over int8 values, and pooling commutes with
    the int8 view of a float map: every int8 value is exact in f16."""
    x = _map((3, 32, 19, 19), torch.int8, 7, specials=True)
    for window, stride, padding, ceil_mode in GEOMETRIES:
        plain = k5.max_pool_plain(x, window, stride, padding, ceil_mode)
        rule = kernel_rule(_to_np(x), k5.pair(window), k5.pair(stride),
                           k5.pair(padding), ceil_mode)
        assert plain.dtype == torch.int8
        np.testing.assert_array_equal(_to_np(plain), rule)
        wide = F.max_pool2d(x.float(), window, stride, padding,
                            ceil_mode=ceil_mode)
        assert torch.equal(plain.float(), wide)


# ------------------------------------------------------- geometry, op

@pytest.mark.parametrize("ceil_mode", [False, True], ids=["floor", "ceil"])
@pytest.mark.parametrize("geometry", [(2, 2, 0), (3, 1, 1), (3, 2, 1),
                                      (2, 1, 1), (3, 3, 0), (4, 3, 2)],
                         ids=lambda g: "k{}s{}p{}".format(*g))
def test_out_size_is_torch_arithmetic(geometry, ceil_mode):
    window, stride, padding = geometry
    for size in range(max(window - 2 * padding, 1), 41):
        x = torch.empty(1, 1, size, size)
        want = F.max_pool2d(x, window, stride, padding,
                            ceil_mode=ceil_mode).shape[2]
        assert k5.out_size(size, window, stride, padding, ceil_mode) == want


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fake_impl_shape_dtype_strides(dtype):
    tdtype = DTYPES[dtype]
    cases = (((3, 24, 75, 75), (2, 2), (2, 2), (0, 0), True, (38, 38)),
             ((3, 24, 75, 75), (2, 2), (2, 2), (0, 0), False, (37, 37)),
             ((2, 8, 19, 19), (3, 3), (1, 1), (1, 1), False, (19, 19)),
             ((2, 8, 112, 112), (3, 3), (2, 2), (1, 1), False, (56, 56)),
             ((1, 4, 9, 7), (3, 3), (2, 2), (0, 1), True, (4, 4)))
    with FakeTensorMode():
        for device in ("cpu", "cuda"):
            for shape, kernel, stride, padding, ceil_mode, hw in cases:
                x = torch.empty(shape, dtype=tdtype, device=device)
                out = torch.ops.ssd.max_pool(x, kernel, stride, padding,
                                             ceil_mode)
                n, c = shape[:2]
                assert out.shape == (n, c) + hw
                assert out.dtype == tdtype and out.device == x.device
                assert out.stride() == (hw[0] * hw[1] * c, 1, hw[1] * c, c)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=_IDS)
def test_opcheck(geometry, dtype):
    # Finite inputs: opcheck compares its runs without equal_nan.
    window, stride, padding, ceil_mode = geometry
    x = _map((2, 8, 9, 7), DTYPES[dtype], window + stride, specials=False)
    torch.library.opcheck(torch.ops.ssd.max_pool.default,
                          (x, [window] * 2, [stride] * 2, [padding] * 2,
                           ceil_mode))
    # Not channels_last: the op returns channels_last all the same.
    torch.library.opcheck(torch.ops.ssd.max_pool.default,
                          (x.contiguous(), [window] * 2, [stride] * 2,
                           [padding] * 2, ceil_mode))


def test_checked_entry_raises_and_counts_no_cpu_launch():
    x = _map((2, 8, 9, 7), torch.float32, 0, specials=False)
    k5.launches = 0
    k5.max_pool(x, 2, 2)
    assert k5.launches == 0
    with pytest.raises(ValueError, match="N, C, H, W"):
        k5.max_pool(x[0], 2, 2)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="f32, bf16 or int8"):
            k5.max_pool(x.to(dtype), 2, 2)
    with pytest.raises(ValueError, match="half the window"):
        k5.max_pool(x, 3, 1, 2)
    with pytest.raises(ValueError, match="stride"):
        k5.max_pool(x, 2, 0)
    with pytest.raises(ValueError, match="smaller than the window"):
        k5.max_pool(x[:, :, :2, :2], 3, 1)


# ----------------------------------------------------------------- route

# (case, input on CUDA, input requires grad, grad mode, K5 expected).  The
# input stands in for a CUDA tensor: the predicate reads its ``is_cuda``
# and ``requires_grad`` only.
@pytest.mark.parametrize("case,cuda,x_grad,mode,want", [
    ("inference_mode", True, False, "inference", True),
    ("no_grad, input requires grad", True, True, "no_grad", True),
    ("grad, input does not require it", True, False, "grad", True),
    ("grad, input requires it (the train step)", True, True, "grad", False),
    ("CPU tensor", False, False, "inference", False),
    ("CPU tensor, no_grad", False, False, "no_grad", False),
])
def test_route_conditions(case, cuda, x_grad, mode, want):
    x = types.SimpleNamespace(is_cuda=cuda, requires_grad=x_grad)
    ctx = {"no_grad": torch.no_grad(), "grad": torch.enable_grad(),
           "inference": torch.inference_mode()}[mode]
    with ctx:
        assert layers.pools_on_k5(x) is want, case


def test_cpu_forward_never_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(k5, "launch", lambda *a: calls.append(a))
    k5.launches = 0
    x = _map((1, 8, 9, 9), torch.float32, 1, specials=False)
    with torch.inference_mode():
        for window, stride, padding, ceil_mode in GEOMETRIES:
            layers.max_pool(x, window, stride, padding, ceil_mode)
            layers.max_pool(x.to(torch.int8), window, stride, padding,
                            ceil_mode)
    assert calls == [] and k5.launches == 0


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_routed_pool_takes_the_kernel_entry(monkeypatch, grad):
    """With the route open (as on the card), `max_pool` hands the launcher
    its map and the geometry as pairs, and returns what it returns; with
    the input requiring grad it keeps ``F.max_pool2d``, whose gradient
    flows."""
    calls = []
    monkeypatch.setattr(layers, "pools_on_k5",
                        lambda x: not (torch.is_grad_enabled()
                                       and x.requires_grad))
    monkeypatch.setattr(k5, "launch", rule_launch(calls))
    x = _map((2, 8, 75, 75), torch.bfloat16, 2, specials=True)
    x.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = layers.max_pool(x, 2, 2, ceil_mode=True)
    want = F.max_pool2d(x.detach(), 2, 2, ceil_mode=True)
    assert _same(got.detach(), want)
    if grad:
        assert calls == [] and got.requires_grad
        got.float().nan_to_num().sum().backward()
        assert x.grad is not None
    else:
        assert calls == [((2, 8, 75, 75), torch.bfloat16, (2, 2), (2, 2),
                          (0, 0), True)]


class _OneRankRows:
    """A spatial ``part`` of one rank: its rows are the whole map, so the
    extended input is the map with ``padding`` rows of ``fill`` above and
    below (`parallel/spatial.py:SpatialParallel.extend`'s contract)."""

    kind = "spatial"

    def __init__(self):
        self.fills = []

    def extend(self, x, kernel, stride, padding, dilation, ceil_mode, fill):
        self.fills.append(fill)
        ext = F.pad(x.float(), (0, 0, padding, padding), value=fill)
        rows = k5.out_size(x.shape[2], kernel, stride, padding, ceil_mode)
        return ext.to(x.dtype), rows

    def narrow_rows(self, y, start, rows):
        return y[:, :, start:start + rows]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spatial_part_keeps_its_fills(monkeypatch, dtype):
    """Under a spatial ``part`` the pool keeps the old path: the rows it
    needs, filled with -inf (int8: -128) outside the map, pooled with
    padding 0 in H; the inner pool takes the kernel's entry with the
    ``(0, p)`` padding, and the result equals the unpartitioned pool."""
    calls = []
    monkeypatch.setattr(layers, "pools_on_k5", lambda x: True)
    monkeypatch.setattr(k5, "launch", rule_launch(calls))
    x = _map((2, 8, 19, 19), DTYPES[dtype], 3, specials=False)
    part = _OneRankRows()
    for window, stride, padding, ceil_mode in GEOMETRIES:
        with torch.inference_mode():
            got = layers.max_pool(x, window, stride, padding, ceil_mode,
                                  part=part)
        want = k5.max_pool_plain(x, window, stride, padding, ceil_mode)
        assert _same(got, want)
        assert calls[-1][4] == (0, padding)
    fill = -128 if dtype == "int8" else -np.inf
    assert part.fills == [fill] * len(GEOMETRIES)


# ------------------------------------------------------------- models

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["vgg16", "resnet34"])
def test_model_forward_unchanged_through_the_kernel_entry(monkeypatch,
                                                          backbone, dtype):
    """An inference forward whose pools go through the kernel's entry (the
    rule standing in for K5) equals the plain forward bit for bit: SSD300's
    five pools, ResNet-34's stem pool, each called once."""
    size = 300 if backbone == "vgg16" else 224
    model = build_model(ModelConfig(backbone=backbone, compute_dtype=dtype,
                                    freeze_backbone=False),
                        device="cpu",
                        generator=torch.Generator().manual_seed(11))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (1, size, size, 3), dtype=np.uint8))
    with torch.inference_mode():
        plain = model(x)
    calls = []
    monkeypatch.setattr(layers, "pools_on_k5", lambda t: True)
    monkeypatch.setattr(k5, "launch", rule_launch(calls))
    with torch.inference_mode():
        routed = model(x)
    want = {"vgg16": [(2, 2, 0, False), (2, 2, 0, False), (2, 2, 0, True),
                      (2, 2, 0, False), (3, 1, 1, False)],
            "resnet34": [(3, 2, 1, False)]}[backbone]
    assert [(c[2][0], c[3][0], c[4][0], c[5]) for c in calls] == want
    assert all(c[1] == plain[0].dtype for c in calls)
    for a, b in zip(routed, plain):
        assert _same(a, b)

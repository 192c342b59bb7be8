"""K4, the fused bias add and ReLU (`ops/bias_relu.py`, `csrc/bias_relu.cu`),
and the route through it in `models/layers.py:TorchConv`.

On the CPU the op ``ssd::bias_relu`` is the plain version, and
`TorchConv(x, relu=True)` keeps the conv's own bias add (oneDNN adds it
inside its sum) followed by ``F.relu``; the kernel runs only on the card,
where `chip_smoke.py` holds it bit for bit against `bias_relu_plain`.
Inputs come from numpy seeds.

Tolerances: none.  The op is held bit for bit against ``F.relu(y + b)``
(the same two IEEE operations), and equal in value to the JAX package's
``jax.nn.relu(y + b)`` (XLA adds bf16 in f32 and rounds once, as aten
does; NaN compared as NaN); `TorchConv(x, relu=True)` on the CPU runs
the very operations of ``F.relu(TorchConv(x))``, so outputs and gradients
are equal; `calibrate` records the same inputs, so the trees are equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from objectdetection_ssd_torch.config import ModelConfig
from objectdetection_ssd_torch.infer import quant as tquant
from objectdetection_ssd_torch.models import backbones, ssd
from objectdetection_ssd_torch.models.layers import (TorchConv, flatten_head,
                                                     max_pool)
from objectdetection_ssd_torch.ops import bias_relu as k4

torch.set_num_threads(2)

_DTYPES = {"float32": (torch.float32, jnp.float32, torch.int32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16, torch.int16)}


def _inputs(c: int, dtype: torch.dtype, channels_last: bool, seed: int = 0):
    """y (2, c, 5, 7) and bias (c,) in ``dtype``, with NaN, +inf and -inf
    planted in y and in the bias."""
    rng = np.random.default_rng(seed + c)
    y = rng.normal(0.0, 3.0, (2, c, 5, 7)).astype(np.float32)
    b = rng.normal(0.0, 1.0, (c,)).astype(np.float32)
    flat = y.reshape(-1)
    for value, at in ((np.nan, 3), (np.inf, 11), (-np.inf, 17),
                      (np.inf, 40), (-np.inf, 41)):
        flat[at] = value
    b[min(1, c - 1)] = np.nan
    if c > 3:
        b[2], b[3] = np.inf, -np.inf
    yt = torch.from_numpy(y).to(dtype)
    if channels_last:
        yt = yt.contiguous(memory_format=torch.channels_last)
    return yt, torch.from_numpy(b).to(dtype)


def _bits(t: torch.Tensor, int_dtype: torch.dtype) -> torch.Tensor:
    return t.contiguous().view(int_dtype)


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["contiguous", "channels_last"])
@pytest.mark.parametrize("c", [3, 64, 126, 1024])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_op_bit_equal_to_relu_of_add(dtype, c, channels_last):
    tdtype, jdtype, int_dtype = _DTYPES[dtype]
    y, b = _inputs(c, tdtype, channels_last)
    want = F.relu(y + b[:, None, None])
    for got in (torch.ops.ssd.bias_relu(y, b), k4.bias_relu(y, b),
                k4.bias_relu_plain(y, b)):
        assert got.shape == y.shape and got.dtype == y.dtype
        assert torch.equal(_bits(got, int_dtype), _bits(want, int_dtype))
    out = torch.ops.ssd.bias_relu(y, b)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert bool(torch.isnan(out).any()) and bool(torch.isinf(out).any())
    # The JAX package's arithmetic on the same values.
    jy = jnp.asarray(y.float().numpy(), dtype=jdtype)
    jb = jnp.asarray(b.float().numpy(), dtype=jdtype)
    jwant = np.asarray(jax.nn.relu(jy + jb[:, None, None]), np.float32)
    np.testing.assert_array_equal(out.float().numpy(), jwant)


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_impl_shape_dtype_strides(dtype, channels_last):
    with FakeTensorMode():
        for device in ("cpu", "cuda"):
            y = torch.empty(3, 24, 5, 7, dtype=dtype, device=device,
                            memory_format=torch.channels_last
                            if channels_last else torch.contiguous_format)
            out = torch.ops.ssd.bias_relu(y, torch.empty(24, dtype=dtype,
                                                         device=device))
            assert out.shape == (3, 24, 5, 7)
            assert out.dtype == dtype and out.device == y.device
            assert out.stride() == (24 * 35, 1, 7 * 24, 24)


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["contiguous", "channels_last"])
def test_opcheck(channels_last):
    # Finite inputs: opcheck compares its runs without equal_nan.
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(2, 16, 5, 7, generator=gen)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    b = torch.randn(16, generator=gen)
    torch.library.opcheck(torch.ops.ssd.bias_relu.default, (y, b))


def test_wrapper_checks_and_counts_no_cpu_launch():
    y, b = _inputs(8, torch.float32, True)
    k4.launches = 0
    k4.bias_relu(y, b)
    assert k4.launches == 0
    with pytest.raises(ValueError, match="bias"):
        k4.bias_relu(y, b[:4])
    with pytest.raises(ValueError, match="bias"):
        k4.bias_relu(y[0], b)
    with pytest.raises(TypeError, match="dtype"):
        k4.bias_relu(y, b.bfloat16())
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="dtype"):
            k4.bias_relu(y.to(dtype), b.to(dtype))


# SSD300's ReLU'd conv geometries: (cin, cout, kernel, stride, padding,
# dilation) -- the VGG 3x3, fc6's atrous 3x3, fc7 / the extras' 1x1, the
# extras' strided and VALID 3x3.
_GEOMETRIES = ((5, 8, 3, 1, 1, 1), (8, 16, 3, 1, 4, 4), (16, 8, 1, 1, 0, 1),
               (8, 12, 3, 2, 1, 1), (12, 8, 3, 1, 0, 1))


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geometry", _GEOMETRIES,
                         ids=lambda g: "x".join(map(str, g)))
def test_conv_relu_equals_relu_of_conv(geometry, dtype, grad):
    cin, cout, kernel, stride, padding, dilation = geometry
    gen = torch.Generator().manual_seed(sum(geometry))
    conv = TorchConv(cin, cout, kernel, stride, padding, dilation)
    conv.reset_parameters(gen)
    with torch.no_grad():
        conv.bias.normal_(0.0, 0.5, generator=gen)
    x0 = torch.from_numpy(np.random.default_rng(sum(geometry)).normal(
        size=(2, cin, 11, 9)).astype(np.float32)).to(dtype).contiguous(
            memory_format=torch.channels_last)
    runs = []
    for fused in (True, False):
        conv.zero_grad()
        x = x0.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y = conv(x, relu=True) if fused else F.relu(conv(x))
        grads = ()
        if grad:
            y.float().square().sum().backward()
            grads = (x.grad, conv.weight.grad, conv.bias.grad)
        runs.append((y.detach(), grads))
    (y1, g1), (y0, g0) = runs
    assert torch.equal(y1, y0)
    assert bool((y1 > 0).any()) and bool((y1 == 0).any())
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_relu_false_is_the_conv():
    conv = TorchConv(4, 6, 3, padding=1)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 6, 6, generator=torch.Generator().manual_seed(1))
    assert torch.equal(conv(x), conv(x, relu=False))
    assert bool((conv(x) < 0).any())


def _frozen(conv):
    conv.requires_grad_(False)
    return conv


def _with(conv, **attrs):
    for key, value in attrs.items():
        setattr(conv, key, value)
    return conv


# (case, conv, the input requires grad, grad mode, K4 expected).  The
# input stands in for a CUDA tensor: the predicate reads its ``is_cuda``
# and ``requires_grad`` only.
@pytest.mark.parametrize("case,make,x_grad,mode,want", [
    ("inference_mode", lambda: TorchConv(4, 8, 3, padding=1), False,
     "inference", True),
    ("no_grad, input requires grad", lambda: TorchConv(4, 8, 3, padding=1),
     True, "no_grad", True),
    ("grad, nothing requires it",
     lambda: _frozen(TorchConv(4, 8, 3, padding=1)), False, "grad", True),
    ("grad, parameters require it", lambda: TorchConv(4, 8, 3, padding=1),
     False, "grad", False),
    ("grad, input requires it",
     lambda: _frozen(TorchConv(4, 8, 3, padding=1)), True, "grad", False),
    ("no bias", lambda: TorchConv(4, 8, 3, padding=1, use_bias=False),
     False, "no_grad", False),
    ("K2 route", lambda: TorchConv(4, 8, 3, padding=1, dw_pallas=True),
     False, "no_grad", False),
    ("partitioned", lambda: _with(TorchConv(4, 8, 3, padding=1),
                                  part=object()), False, "no_grad", False),
    ("quantized", lambda: _with(TorchConv(4, 8, 3, padding=1),
                                quant=object()), False, "no_grad", False),
])
def test_route_conditions(case, make, x_grad, mode, want):
    conv = make()
    x = types.SimpleNamespace(is_cuda=True, requires_grad=x_grad)
    ctx = {"no_grad": torch.no_grad(), "grad": torch.enable_grad(),
           "inference": torch.inference_mode()}[mode]
    with ctx:
        assert conv._fuses_bias_relu(x) is want, case


def test_cpu_forward_never_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(k4, "launch", lambda *a: calls.append(a))
    conv = TorchConv(4, 8, 3, padding=1)
    with torch.inference_mode():
        assert not conv._fuses_bias_relu(torch.zeros(1))
        conv(torch.zeros(1, 4, 5, 5), relu=True)
    assert calls == []


def _parent_forward(self, images, generator=None, remat=False):
    """SSD300's forward as written before ``relu=True``: each conv called
    as a module, ``F.relu`` on its output."""
    trunk = self.trunk
    x = ssd.prepare_input(images, self.dtype)
    for stage, (name, n, _) in enumerate(backbones._VGG_BLOCKS, start=1):
        if stage == 5:
            x = max_pool(x, 2, 2)
        for i in range(n):
            x = F.relu(getattr(trunk, f"{name}_{i + 1}")(x))
        if stage < 4:
            x = max_pool(x, 2, 2, ceil_mode=stage == 3)
        elif stage == 4:
            conv4_3 = x
    x = max_pool(x, 3, 1, padding=1)
    x = F.relu(trunk.conv_fc7(F.relu(trunk.conv_fc6(x))))
    taps = [self.l2norm_4_3(conv4_3), x]
    for name, *_ in ssd._EXTRAS:
        x = F.relu(getattr(self, f"{name}_2")(
            F.relu(getattr(self, f"{name}_1")(x))))
        taps.append(x)
    locs, confs = [], []
    for i, tap in enumerate(taps):
        locs.append(flatten_head(getattr(self, f"loc_head_{i}")(tap), 4))
        confs.append(flatten_head(getattr(self, f"conf_head_{i}")(tap),
                                  self.num_classes))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def test_calibrate_same_tree_as_before_the_call_site_change():
    """The convs stay module calls, so `calibrate`'s forward pre-hooks
    see every conv's input as they did when the caller applied the ReLU:
    the same SSD300 scale tree, leaf for leaf."""
    model = ssd.build_model(ModelConfig(), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
               for _ in range(2)]
    after = tquant.calibrate(model, batches)
    model.forward = types.MethodType(_parent_forward, model)
    with torch.inference_mode():
        got = model(torch.from_numpy(batches[0]))
    before = tquant.calibrate(model, batches)
    assert got[0].shape == (1, 8732, 4)
    leaves = dict(tquant._leaves(after))
    assert leaves == dict(tquant._leaves(before))
    assert len(leaves) == 35 and all(v > 0 for v in leaves.values())

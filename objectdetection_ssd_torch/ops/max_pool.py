"""A max pool over ``channels_last`` maps: the CUDA kernel `csrc/max_pool.cu`
(K5) and its plain PyTorch version.

K5 replaces no TPU kernel: the JAX package pools with
``lax.reduce_window`` (`models/layers.py:max_pool`), which XLA lowers to
one pass over the map, and pools an int8 map directly.  On the card
``F.max_pool2d`` runs ``max_pool2d_with_indices``, which also writes an
int64 index for every output value, and takes no int8, so an int8 map went
through f16.  `max_pool` takes an (N, C, H, W) map in bf16, f32 or int8
and returns ``F.max_pool2d(x, kernel, stride, padding,
ceil_mode=ceil_mode)`` without indices, in ``channels_last`` memory, bit
for bit (a NaN in the window wins, the first of two signed zeros stays);
int8 is pooled natively, equal to the f16 round trip.

On a CUDA tensor it launches the kernel (and raises if that fails); on a
CPU tensor it runs the plain version, `max_pool_plain`.  Nothing falls
back from one to the other.  Both are the custom op ``ssd::max_pool``
(registered at import), with a fake (shape) implementation, so that
`torch.export` records each pool as one node and an exported program
launches K5 where the eager model does.  Eager calls on the card launch
the kernel directly (`launch`), without the op's dispatch, which costs
more host time per call than the launch itself.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from objectdetection_ssd_torch import cuda_build

SOURCE = cuda_build.CSRC_DIR / "max_pool.cu"
# The kernel's dtype codes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# Kernel launches since the last reset (the plain CPU path does not count).
launches = 0
_lib: Optional[ctypes.CDLL] = None


def pair(v) -> Tuple[int, int]:
    """An int or a pair of ints as a pair."""
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def out_size(size: int, kernel: int, stride: int, padding: int,
             ceil_mode: bool):
    """torch's pooling output size (dilation 1): in ceil mode the last
    window must start inside the map or its left padding."""
    out = (size + 2 * padding - kernel
           + (stride - 1 if ceil_mode else 0)) // stride + 1
    if ceil_mode and (out - 1) * stride >= size + padding:
        out -= 1
    return out


def max_pool_plain(x: torch.Tensor, kernel, stride, padding=0,
                   ceil_mode: bool = False) -> torch.Tensor:
    """``F.max_pool2d``, the plain version.  An int8 map goes through f16,
    which holds every int8 value exactly (``F.max_pool2d`` takes no int8
    on the card)."""
    if x.dtype == torch.int8:
        return F.max_pool2d(x.half(), kernel, stride, padding,
                            ceil_mode=ceil_mode).to(torch.int8)
    return F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give ``lib.ssd_max_pool`` its C signature; returns ``lib``."""
    lib.ssd_max_pool.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 13
                                 + [ctypes.c_void_p])
    lib.ssd_max_pool.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = declare(cuda_build.load(SOURCE))
    return _lib


def _check(x: torch.Tensor, kernel, stride, padding, ceil_mode) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be f32, bf16 or int8, got {x.dtype}")
    for k, s, p, size in zip(kernel, stride, padding, x.shape[2:]):
        if k < 1 or s < 1 or p < 0 or 2 * p > k:
            raise ValueError(f"window {kernel}, stride {stride}, padding "
                             f"{padding}: want a window and stride >= 1 "
                             f"and padding at most half the window")
        if out_size(size, k, s, p, ceil_mode) < 1:
            raise ValueError(f"a {tuple(x.shape[2:])} map is smaller than "
                             f"the window {kernel} with padding {padding}")


def launch(x: torch.Tensor, kernel: Tuple[int, int],
           stride: Tuple[int, int], padding: Tuple[int, int],
           ceil_mode: bool) -> torch.Tensor:
    """K5 on a CUDA tensor (checked by `max_pool`; window, stride and
    padding as pairs); a ``channels_last`` x is read as it is, any other is
    copied to ``channels_last`` first.  It makes few host calls: the layer
    calls it once per pool, and at batch 1 the host sets the pace of
    serving."""
    global launches
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"K5 pools f32, bf16 or int8 maps, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous(memory_format=torch.channels_last)
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho = out_size(h, kh, sh, ph, ceil_mode)
    wo = out_size(w, kw, sw, pw, ceil_mode)
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = _lib or build()
    index = x.device.index
    args = (x.data_ptr(), out.data_ptr(), n, c, h, w, ho, wo, kh, kw, sh, sw,
            ph, pw, code, torch._C._cuda_getCurrentRawStream(index))
    # The kernel launches on the current device: switch only when the
    # tensor lives on another one.
    if index == torch.cuda.current_device():
        err = lib.ssd_max_pool(*args)
    else:
        with torch.cuda.device(index):
            err = lib.ssd_max_pool(*args)
    if err:
        cuda_build.check(lib, err, "ssd_max_pool")
    launches += 1
    return out


def max_pool(x: torch.Tensor, kernel, stride, padding=0,
             ceil_mode: bool = False) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)``
    without indices, in ``channels_last`` memory: K5 on CUDA tensors, the
    plain version on CPU tensors.  Under `torch.export` the call is the op
    ``ssd::max_pool``."""
    kernel, stride, padding = pair(kernel), pair(stride), pair(padding)
    _check(x, kernel, stride, padding, ceil_mode)
    if x.is_cuda:
        return layer_max_pool(x, kernel, stride, padding, ceil_mode)
    return torch.ops.ssd.max_pool(x, kernel, stride, padding, ceil_mode)


def layer_max_pool(x: torch.Tensor, kernel: Tuple[int, int],
                   stride: Tuple[int, int], padding: Tuple[int, int],
                   ceil_mode: bool) -> torch.Tensor:
    """`max_pool` of a model's map on the card (`models/layers.py:
    max_pool`), whose arguments hold by construction (a 4-D map in a
    kernel dtype, a geometry torch takes, as pairs): no checks, which cost
    host time on every pool, then the launcher, or the op under
    `torch.export`."""
    if torch.compiler.is_exporting():
        return torch.ops.ssd.max_pool(x, kernel, stride, padding, ceil_mode)
    return launch(x, kernel, stride, padding, ceil_mode)


@torch.library.custom_op("ssd::max_pool", mutates_args=(),
                         device_types="cpu")
def max_pool_op(x: torch.Tensor, kernel: Sequence[int],
                stride: Sequence[int], padding: Sequence[int],
                ceil_mode: bool) -> torch.Tensor:
    """The op behind `max_pool`; on the CPU, the plain version."""
    return max_pool_plain(x, list(kernel), list(stride), list(padding),
                          ceil_mode).contiguous(
                              memory_format=torch.channels_last)


@max_pool_op.register_kernel("cuda")
def _max_pool_cuda(x: torch.Tensor, kernel: Sequence[int],
                   stride: Sequence[int], padding: Sequence[int],
                   ceil_mode: bool) -> torch.Tensor:
    return launch(x, pair(kernel), pair(stride), pair(padding), ceil_mode)


@max_pool_op.register_fake
def _max_pool_fake(x: torch.Tensor, kernel: Sequence[int],
                   stride: Sequence[int], padding: Sequence[int],
                   ceil_mode: bool) -> torch.Tensor:
    n, c, h, w = x.shape
    ho = out_size(h, kernel[0], stride[0], padding[0], ceil_mode)
    wo = out_size(w, kernel[1], stride[1], padding[1], ceil_mode)
    return torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)

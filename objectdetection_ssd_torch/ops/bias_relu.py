"""A conv's bias add and ReLU in one pass: the CUDA kernel `csrc/bias_relu.cu`
(K4) and its plain PyTorch version.

K4 replaces no TPU kernel: XLA fuses the JAX package's bias add and ReLU
into the conv, where PyTorch runs cuDNN, then a separate broadcast
``add_`` of the bias and a separate ReLU, each over the whole map
(`models/layers.py:TorchConv`, the inference forward of a plain conv).
`bias_relu` takes the bias-free conv output ``y`` (N, C, H, W) in
bf16 or f32 (the port's compute dtypes) and the bias (C,) in ``y``'s
dtype, and returns
``relu(y + bias[:, None, None])`` in ``channels_last`` memory: the add in
f32 rounded once to ``y``'s dtype, then ReLU with NaN kept, which is bit
for bit what ``add_`` then ``F.relu`` give.

On a CUDA tensor it launches the kernel (and raises if that fails); on a
CPU tensor it runs the plain version, `bias_relu_plain`.  Nothing falls
back from one to the other.  Both are the custom op ``ssd::bias_relu``
(registered at import), with a fake (shape) implementation, so that
`torch.export` records each call as one node and an exported program
launches K4 where the eager model does.  Eager calls on the card launch
the kernel directly (`launch`), without the op's dispatch, which costs
more host time per call than the launch itself (`chip_smoke.py` phase
"bias-relu kernel" times both).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from objectdetection_ssd_torch import cuda_build

SOURCE = cuda_build.CSRC_DIR / "bias_relu.cu"
# The kernel's dtype codes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Kernel launches since the last reset (the plain CPU path does not count).
launches = 0
_lib: Optional[ctypes.CDLL] = None


def bias_relu_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu(y + bias[:, None, None])``, the plain version."""
    return torch.relu(y + bias[:, None, None])


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give ``lib.ssd_bias_relu`` its C signature; returns ``lib``."""
    lib.ssd_bias_relu.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.ssd_bias_relu.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = declare(cuda_build.load(SOURCE))
    return _lib


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.dim() != 4 or bias.dim() != 1 or bias.shape[0] != y.shape[1]:
        raise ValueError(f"y must be (N, C, H, W) and bias (C,), got "
                         f"{tuple(y.shape)} and {tuple(bias.shape)}")
    if y.dtype not in _DTYPES or bias.dtype != y.dtype:
        raise TypeError(f"y and bias must share a dtype, f32 or bf16, got "
                        f"{y.dtype} and {bias.dtype}")
    if y.device != bias.device:
        raise ValueError("y and bias are on different devices")


def launch(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors (checked by `bias_relu`); a ``channels_last`` y is
    read as it is, any other is copied to ``channels_last`` first.  It
    makes few host calls: the layer calls it once per conv, and at batch 1
    the host sets the pace of serving."""
    global launches
    if not y.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    if not bias.is_contiguous():
        bias = bias.contiguous()
    out = torch.empty_like(y)          # keeps y's dense channels_last strides
    n = out.numel()
    if n == 0:
        return out
    lib = _lib or build()
    index = y.device.index
    args = (y.data_ptr(), bias.data_ptr(), out.data_ptr(), n, y.shape[1],
            _DTYPES[y.dtype], torch._C._cuda_getCurrentRawStream(index))
    # The kernel launches on the current device: switch only when the
    # tensors live on another one.
    if index == torch.cuda.current_device():
        err = lib.ssd_bias_relu(*args)
    else:
        with torch.cuda.device(index):
            err = lib.ssd_bias_relu(*args)
    if err:
        cuda_build.check(lib, err, "ssd_bias_relu")
    launches += 1
    return out


def bias_relu(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu(y + bias[:, None, None])`` in ``channels_last`` memory: K4 on
    CUDA tensors, the plain version on CPU tensors.  Under `torch.export`
    the call is the op ``ssd::bias_relu``."""
    _check(y, bias)
    if y.is_cuda:
        return conv_bias_relu(y, bias)
    return torch.ops.ssd.bias_relu(y, bias)


def conv_bias_relu(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """`bias_relu` of a conv's output on the card (`models/layers.py:
    TorchConv`), whose y and bias hold by construction (a 4-D map, the
    bias of its channels in its dtype, one device): no checks, which cost
    host time on every conv, then the launcher, or the op under
    `torch.export`."""
    if torch.compiler.is_exporting():
        return torch.ops.ssd.bias_relu(y, bias)
    return launch(y, bias)


@torch.library.custom_op("ssd::bias_relu", mutates_args=(),
                         device_types="cpu")
def bias_relu_op(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The op behind `bias_relu`; on the CPU, the plain version."""
    return bias_relu_plain(y, bias).contiguous(
        memory_format=torch.channels_last)


@bias_relu_op.register_kernel("cuda")
def _bias_relu_cuda(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return launch(y, bias)


@bias_relu_op.register_fake
def _bias_relu_fake(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(y, memory_format=torch.channels_last)

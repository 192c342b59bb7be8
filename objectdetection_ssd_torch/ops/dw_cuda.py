"""Filter gradient of a 3x3 / stride-1 / pad-1 conv: the CUDA kernel
`csrc/dw_conv3x3.cu` (K2), its plain PyTorch version, and the autograd
Function that routes a conv's dW through it.

The port of `objectdetection_ssd_tpu/ops/dw_pallas.py`.
`dw_conv3x3p1(x, g)` takes NHWC tensors ``x (N, H, W, Cin)`` and
``g (N, H, W, Cout)``, both f32 or both bf16 and contiguous, and returns
``dW (3, 3, Cin, Cout)`` in f32.  On a CUDA tensor it launches the kernel
(and raises if that fails); on a CPU tensor it runs the plain version,
`dw_conv3x3p1_plain`.  Nothing falls back from one to the other.  `plan`
picks the kernel's first pass by shape, dtype and alignment (the halo-tile
kernel for bf16 with Cin and Cout multiples of 8 and 16-byte aligned
tensors, else the tap gather), its instantiation and its tiling.

`Conv3x3P1` is the port of the custom VJP `conv3x3p1`: its forward and dX
are library convs (cuDNN on the card), as the JAX package left them to XLA;
dX is `aten.convolution_backward` of the saved x, so it keeps x's memory
format (``channels_last`` in, ``channels_last`` out); only dW comes from
K2, cast to the weight's dtype as `_bwd` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from objectdetection_ssd_torch import cuda_build

SOURCE = cuda_build.CSRC_DIR / "dw_conv3x3.cu"
# The tap-gather kernel's tiling (csrc/dw_conv3x3.cu `dw_partial_kernel`):
# a block owns a TILE_M x TILE_N tile of the (9*Cin) x Cout output and a
# chunk of pixels, a whole number of CHUNK_ALIGN pixels (the kernel steps
# 128 bf16 or 32 f32 pixels at a time).
TILE_M = TILE_N = 64
CHUNK_ALIGN = 128
# Blocks to aim for: 8 per SM on the H100's 132.  The chunk plan depends
# only on the shapes, so the summation order, and with it every bit of the
# result, is the same from run to run.
TARGET_BLOCKS = 1056
MAX_CHUNKS = 65535
# Up to this Cin all 9*Cin tap rows fit one tile, and the gather kernel
# stages x in runs (`kMaxStagedCin`).
MAX_STAGED_CIN = 7
# The halo kernel's tiling (`dw_halo_kernel`): a block owns HALO_CI input
# channels, HALO_CO output channels, all nine taps and a run of spatial
# tiles of HALO_TILE (rows, columns) pixels; one block fills an SM, so one
# wave on the H100's 132 SMs is HALO_TARGET_BLOCKS.
HALO_CI = 64
HALO_CO = 64
HALO_TILE = (4, 32)
HALO_TARGET_BLOCKS = 132
# The partial buffer (chunks x 9*Cin x Cout f32) is kept under this where
# one chunk fits in it, so that pass 2 stays cheap.
MAX_PARTIAL_BYTES = 32 << 20

# Kernel launches since the last reset (the plain CPU path does not count).
launches = 0
# Times `Conv3x3P1.backward` had to copy x or the incoming gradient to get
# NHWC-contiguous operands (0 when both arrive channels_last).
layout_copies = 0
_lib: Optional[ctypes.CDLL] = None


class Plan(NamedTuple):
    """How K2 runs one call (see `plan`); the C entry points launch exactly
    this and reject what does not fit the tensors."""
    kernel: str           # "halo" or "gather"
    chunks: int           # partial slots, summed in order by pass 2
    chunk_pixels: int     # gather: flat pixels per chunk (else 0)
    vec_a: int            # gather: elements per load of x and of g, 1 or
    vec_b: int            #   16 bytes' worth (else 0)
    staged: bool          # gather: x staged in runs (Cin <= MAX_STAGED_CIN)
    tile_h: int           # halo: spatial tile rows and columns (else 0)
    tile_w: int
    tiles_per_chunk: int  # halo: spatial tiles per chunk (else 0)


def dw_conv3x3p1_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version: upcast to f32, zero-pad, and sum the 9 shifted
    products over (N, H, W).  ``(N, H, W, Cin), (N, H, W, Cout) ->
    (3, 3, Cin, Cout)`` f32."""
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))          # (N, H+2, W+2, Cin)
    gm = g.float().reshape(n * h * w, cout)
    taps = [xp[:, ky:ky + h, kx:kx + w].reshape(n * h * w, cin).T @ gm
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout)


def _max_chunks(cin: int, cout: int) -> int:
    return max(1, min(MAX_CHUNKS, MAX_PARTIAL_BYTES // (9 * cin * cout * 4)))


def chunk_plan(n: int, h: int, w: int, cin: int, cout: int
               ) -> Tuple[int, int]:
    """``(chunk_pixels, chunks)``: how the tap-gather kernel splits the
    N*H*W pixels among its blocks.  Every chunk is a whole number of
    CHUNK_ALIGN pixels and holds at least one pixel; the chunks cover all
    pixels."""
    steps = math.ceil(n * h * w / CHUNK_ALIGN)
    tiles = math.ceil(9 * cin / TILE_M) * math.ceil(cout / TILE_N)
    want = max(1, min(steps, math.ceil(TARGET_BLOCKS / tiles),
                      _max_chunks(cin, cout)))
    steps_per_chunk = math.ceil(steps / want)
    return steps_per_chunk * CHUNK_ALIGN, math.ceil(steps / steps_per_chunk)


def plan(n: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
         aligned: bool = True) -> Plan:
    """K2's launch plan for x ``(n, h, w, cin)`` and g ``(n, h, w, cout)``
    of ``dtype``, ``aligned`` when both start on a 16-byte boundary: which
    pass-1 kernel and instantiation, and how the pixels are split into
    chunks.  The halo kernel takes aligned bf16 with Cin and Cout multiples
    of 8 (its 16-byte copies), in HALO_TILE spatial tiles; everything else
    takes the tap gather, with 16-byte loads of x and of g each where its
    channels and the alignment allow."""
    vec = 8 if dtype == torch.bfloat16 else 4
    vec_a = vec if aligned and cin % vec == 0 else 1
    vec_b = vec if aligned and cout % vec == 0 else 1
    if dtype == torch.bfloat16 and vec_a == vec_b == vec:
        tile_h, tile_w = HALO_TILE
        tiles = n * math.ceil(h / tile_h) * math.ceil(w / tile_w)
        per_chunk = math.ceil(cin / HALO_CI) * math.ceil(cout / HALO_CO)
        want = max(1, min(tiles, math.ceil(HALO_TARGET_BLOCKS / per_chunk),
                          _max_chunks(cin, cout)))
        tiles_per_chunk = math.ceil(tiles / want)
        return Plan("halo", math.ceil(tiles / tiles_per_chunk), 0, 0, 0,
                    False, tile_h, tile_w, tiles_per_chunk)
    chunk_pixels, chunks = chunk_plan(n, h, w, cin, cout)
    staged = cin <= MAX_STAGED_CIN
    return Plan("gather", chunks, chunk_pixels, 1 if staged else vec_a,
                vec_b, staged, 0, 0, 0)


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.ssd_dw_conv3x3.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.ssd_dw_conv3x3.restype = ctypes.c_int
        lib.ssd_dw_conv3x3_halo.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ssd_dw_conv3x3_halo.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"x (N, H, W, Cin) and g (N, H, W, Cout) must share "
                         f"N, H, W; got {tuple(x.shape)}, {tuple(g.shape)}")
    if x.dtype != g.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x and g must both be float32 or both bfloat16, "
                        f"got {x.dtype}, {g.dtype}")
    if x.device != g.device:
        raise ValueError("x and g are on different devices")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous NHWC")


def dw_conv3x3p1(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter gradient of a 3x3/stride-1/pad-1 NHWC conv: ``x (N, H, W,
    Cin)``, ``g (N, H, W, Cout)`` -> ``dW (3, 3, Cin, Cout)`` f32.  CUDA
    tensors run K2, CPU tensors the plain version."""
    global launches
    _check(x, g)
    if x.device.type == "cpu":
        return dw_conv3x3p1_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32,
                      device=x.device)
    if x.numel() == 0 or g.numel() == 0:
        return out.zero_()
    p = plan(n, h, w, cin, cout, x.dtype,
             aligned=x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    partial = torch.empty((p.chunks, 9 * cin, cout), dtype=torch.float32,
                          device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if p.kernel == "halo":
            err = lib.ssd_dw_conv3x3_halo(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, h, w, cin, cout, p.tile_h, p.tile_w,
                p.tiles_per_chunk, p.chunks, stream)
        else:
            err = lib.ssd_dw_conv3x3(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                out.data_ptr(), 0 if x.dtype == torch.float32 else 1, n, h,
                w, cin, cout, p.vec_a, p.vec_b, int(p.staged),
                p.chunk_pixels, p.chunks, stream)
    cuda_build.check(lib, err, f"ssd_dw_conv3x3 ({p.kernel})")
    launches += 1
    return out


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW -> a contiguous NHWC view, copying (and counting the copy) only
    when ``t`` is not ``channels_last``."""
    global layout_copies
    if not t.is_contiguous(memory_format=torch.channels_last):
        layout_copies += 1
        t = t.contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1)


class Conv3x3P1(torch.autograd.Function):
    """3x3/stride-1/pad-1 NCHW conv without bias whose filter gradient is
    K2 (`dw_conv3x3p1`); forward and dX are library convs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, None, 1, 1)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                grad_out, x, weight, None, [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            taps = dw_conv3x3p1(_nhwc(x), _nhwc(grad_out))  # (3,3,Cin,Cout)
            dw = taps.permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw


def conv3x3p1(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """`Conv3x3P1` applied: ``x (N, Cin, H, W)``, ``weight (Cout, Cin, 3,
    3)`` -> ``(N, Cout, H, W)``."""
    return Conv3x3P1.apply(x, weight)

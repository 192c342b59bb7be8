"""int8 convolution: the CUDA kernel `csrc/int8_conv.cu` (K3), its plain
PyTorch version, and the weight and activation quantizers around it.

The port of the int8 path of the JAX `Int8Conv`
(`objectdetection_ssd_tpu/models/layers.py:114-138`), which XLA computes as
an int8 x int8 -> int32 `conv_general_dilated`.  `int8_conv` takes an int8
NCHW activation (``channels_last`` memory, i.e. NHWC bytes), int8 weights
``(Cout, kh, kw, Cin)``, the per-channel f32 ``scale`` (``s_a * s_w``) and
an optional f32 bias, and returns ``float(acc) * scale + bias`` rounded to
``dtype`` (f32 or bf16), or, with ``out_scale``, requantized to int8:
``clip(round(y / out_scale), -127, 127)`` with ``y`` rounded through
``dtype`` first.  On a CUDA tensor it launches the kernel (and raises if
that fails); on a CPU tensor it runs the plain version, `int8_conv_plain`.
Nothing falls back from one to the other.  Both are the custom op
``ssd::int8_conv`` (registered at import), with a fake (shape)
implementation, so that `torch.export` records each call as one node and
an exported program launches K3 where the eager model does.  `plan`
picks the kernel's path (``vec``: 16-byte copies, for aligned tensors
with Cin % 16 == 0; ``rows``: staged input rows, for the rest), its
instantiation (block and warp tiles, pipeline stages), the rows path's
output tile and the dynamic shared bytes; `row_table` is the rows path's
k -> offset table; `launch_plan` adds the Cin that x and w are
zero-padded to where no rows-path patch fits in shared memory.

Scales that divide are tensors on the data's device: on the card, PyTorch
divides by a Python number or a CPU scalar as a multiply by its reciprocal,
which is not the IEEE division the JAX package performs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from objectdetection_ssd_torch import cuda_build

SOURCE = cuda_build.CSRC_DIR / "int8_conv.cu"
QMAX = 127
# Kernel launches since the last reset (the plain CPU path does not count).
launches = 0
_lib: Optional[ctypes.CDLL] = None
# The kernel's epilogue modes by output dtype (and, for int8 output, by
# the dtype y is rounded through first).
_MODES = {torch.float32: 0, torch.bfloat16: 1}
_INT8_MODES = {torch.float32: 2, torch.bfloat16: 3}
# The kernel's instantiations (csrc/int8_conv.cu `K3_TILES`): path, block
# tile BM x BN, warp tile WM x WN, pipeline stages.  `vec` takes a 128 x
# 128 block, or 256 x 64 where Cout <= 64 (so that no N tile is half
# empty); `rows` takes 256 x 64.
TILES = {"vec_128x128": ("vec", 128, 128, 64, 32, 4),
         "vec_256x64": ("vec", 256, 64, 64, 32, 4),
         "rows_256x64": ("rows", 256, 64, 64, 32, 2)}
PATH_IDS = {"vec": 0, "rows": 1}
# Bytes of K per pipeline step, and of padding per shared-memory row.
BK = {"vec": 64, "rows": 32}
ROW_PAD = 16
# Dynamic shared memory one block may use on the H100 (227 KB).
MAX_SMEM = 232448
# The rows path's k -> offset tables on the card, by (geometry, pitch,
# device).
_tables: Dict[tuple, torch.Tensor] = {}


class Plan(NamedTuple):
    """How K3 runs one call (see `plan`); `ssd_int8_conv` launches exactly
    this instantiation and rejects a plan that does not fit the tensors."""
    name: str          # a key of TILES
    path: str          # "vec" or "rows"
    bm: int            # block tile: output pixels x channels
    bn: int
    wm: int            # warp tile
    wn: int
    stages: int        # shared-memory buffers of the K pipeline
    threads: int
    kp: int            # K padded to the K step
    grid: Tuple[int, int]
    smem: int          # dynamic shared bytes
    tile_h: int        # rows: the block's output patch (else 0)
    tile_w: int
    staged_rows: int   # rows: the staged input window (else 0)
    staged_cols: int
    pitch: int         # rows: bytes per staged row (staged_cols * Cin,
                       #   rounded up to a word)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a f32 scalar tensor on ``like``'s device (a fill, not a
    copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def weight_scale(weight: torch.Tensor) -> torch.Tensor:
    """``s_w = max(max|w[c]| / 127, 1e-12)`` per output channel of OIHW
    weights, in f32 and without gradient (`layers.py:98-99`)."""
    w = weight.detach().float()
    return torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / scalar(QMAX, w),
                           1e-12)


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """OIHW float weights -> (``w_q`` int8 (Cout, kh, kw, Cin) contiguous,
    ``s_w`` f32 (Cout,)): ``w_q = clip(round(w / s_w), -127, 127)`` in f32
    (`layers.py:115`)."""
    w = weight.detach().float()
    s_w = weight_scale(w)
    w_q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -QMAX, QMAX)
    return w_q.to(torch.int8).permute(0, 2, 3, 1).contiguous(), s_w


def quantize_activation(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s_a), -127, 127)`` as int8, in f32 (round half to
    even, as `jnp.round`); ``s_a`` a f32 scalar tensor on x's device."""
    return torch.clamp(torch.round(x.float() / s_a), -QMAX, QMAX).to(
        torch.int8)


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int, padding: int, dilation: int,
                    dtype: torch.dtype,
                    out_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """K3's function in plain PyTorch: the conv in f64 on the int8 values
    (exact: every partial sum is an integer below 2^31), cast to int32, then
    the same epilogue in f32 operations.  The result has the kernel's
    layout: an NHWC buffer viewed NCHW (``channels_last`` strides)."""
    acc = F.conv2d(x_q.double(), w_q.permute(0, 3, 1, 2).double(), None,
                   stride, padding, dilation).to(torch.int32)
    y = acc.float() * scale[:, None, None]
    if bias is not None:
        y = y + bias[:, None, None]
    y = y.to(dtype)
    if out_scale is not None:
        y = quantize_activation(y, out_scale)
    n, c, h, w = y.shape
    out = torch.empty((n, h, w, c), dtype=y.dtype, device=y.device)
    return out.copy_(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _rows_tile(ho: int, wo: int, cin: int, kh: int, kw: int, stride: int,
               dil: int, bm: int, fixed: int, kp: int
               ) -> Optional[Tuple[int, int, int, int, int, int]]:
    """The rows path's output patch: (tile_h, tile_w, staged_rows,
    staged_cols, pitch, smem) with tile_h * tile_w <= bm and the fewest
    patches per image, then the fewest staged bytes; None if no patch's
    window fits in shared memory."""
    best = None
    for tile_w in range(1, min(wo, bm) + 1):
        cols = (tile_w - 1) * stride + (kw - 1) * dil + 1
        pitch = -(-cols * cin // 4) * 4
        for tile_h in range(min(bm // tile_w, ho), 0, -1):
            rows = (tile_h - 1) * stride + (kh - 1) * dil + 1
            smem = fixed + kp * 4 + rows * pitch
            if smem <= MAX_SMEM:
                break
        else:
            continue
        key = (math.ceil(ho / tile_h) * math.ceil(wo / tile_w), rows * pitch)
        if best is None or key < best[0]:
            best = (key, (tile_h, tile_w, rows, cols, pitch, smem))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
         stride: int, pad: int, dil: int, aligned: bool = True) -> Plan:
    """K3's launch plan for x ``(n, h, w, cin)`` and w ``(cout, kh, kw,
    cin)``, ``aligned`` when both start on a 16-byte boundary: the ``vec``
    path for aligned tensors with Cin % 16 == 0 (128 x 128 blocks, 256 x
    64 where Cout <= 64), else the ``rows`` path with the output patch
    that needs the fewest blocks.  Raises ValueError if no rows patch fits
    in shared memory."""
    ho = out_size(h, kh, stride, pad, dil)
    wo = out_size(w, kw, stride, pad, dil)
    k = kh * kw * cin
    if aligned and cin % 16 == 0:
        name = "vec_256x64" if cout <= 64 else "vec_128x128"
    else:
        name = "rows_256x64"
    path, bm, bn, wm, wn, stages = TILES[name]
    threads = (bm // wm) * (bn // wn) * 32
    kp = -(-k // BK[path]) * BK[path]
    fixed = stages * (bm + bn) * (BK[path] + ROW_PAD) + bm * 8
    gy = -(-cout // bn)
    if path == "vec":
        return Plan(name, path, bm, bn, wm, wn, stages, threads, kp,
                    (-(-n * ho * wo // bm), gy), fixed, 0, 0, 0, 0, 0)
    tile = _rows_tile(ho, wo, cin, kh, kw, stride, dil, bm, fixed, kp)
    if tile is None:
        raise ValueError(f"K3's rows path: no output patch of a {kh}x{kw} "
                         f"dilation-{dil} conv over {cin} channels fits in "
                         f"{MAX_SMEM} bytes of shared memory")
    tile_h, tile_w, rows, cols, pitch, smem = tile
    tiles = math.ceil(ho / tile_h) * math.ceil(wo / tile_w)
    return Plan(name, path, bm, bn, wm, wn, stages, threads, kp,
                (n * tiles, gy), smem, tile_h, tile_w, rows, cols, pitch)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, h: int, w: int, cin: int, cout: int, kh: int,
                kw: int, stride: int, pad: int, dil: int,
                aligned: bool = True) -> Tuple[Plan, Optional[int]]:
    """(`plan`, None), or, where the rows path has no output patch whose
    window fits in shared memory, (the vec path's plan, Cin rounded up to
    a multiple of 16): K3 then runs on fresh (so 16-byte aligned) copies
    of x and w zero-padded to that Cin (`pad_channels`).  The zero
    channels add nothing to the int32 sums, so the result is the same
    bits."""
    try:
        return plan(n, h, w, cin, cout, kh, kw, stride, pad, dil,
                    aligned), None
    except ValueError:
        cin16 = -(-cin // 16) * 16
        return plan(n, h, w, cin16, cout, kh, kw, stride, pad, dil,
                    True), cin16


def pad_channels(x_q: torch.Tensor, w_q: torch.Tensor, cin: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_q (N, Cin, H, W) and w_q (Cout, kh, kw, Cin) copied into fresh
    zero buffers with ``cin`` channels (x in NHWC memory)."""
    n, c, h, w = x_q.shape
    x_pad = x_q.new_zeros((n, h, w, cin))
    x_pad[..., :c] = x_q.permute(0, 2, 3, 1)
    w_pad = w_q.new_zeros((*w_q.shape[:3], cin))
    w_pad[..., :c] = w_q
    return x_pad.permute(0, 3, 1, 2), w_pad


def row_table(cin: int, kh: int, kw: int, dil: int, pitch: int,
              kp: int) -> np.ndarray:
    """The rows path's k -> offset table, int32 (kp,): for k = (r, s, ci)
    < K, the offset of tap (r, s), channel ci in the staged rows from the
    top-left byte of an output pixel's window (row offset r * dil, column
    offset s * dil, then ci: ``r*dil*pitch + s*dil*cin + ci``); -1 for the
    zero padding of K up to kp."""
    r, s, ci = np.meshgrid(np.arange(kh), np.arange(kw), np.arange(cin),
                           indexing="ij")
    offs = (r * dil * pitch + s * dil * cin + ci).reshape(-1)
    table = np.full(kp, -1, np.int32)
    table[:offs.size] = offs
    return table


def _device_table(p: Plan, cin: int, kh: int, kw: int, dil: int,
                  device: torch.device) -> torch.Tensor:
    key = (cin, kh, kw, dil, p.pitch, p.kp, device)
    if key not in _tables:
        _tables[key] = torch.from_numpy(
            row_table(cin, kh, kw, dil, p.pitch, p.kp)).to(device)
    return _tables[key]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give ``lib.ssd_int8_conv`` its C signature; returns ``lib``."""
    lib.ssd_int8_conv.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 22
                                  + [ctypes.c_void_p])
    lib.ssd_int8_conv.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = declare(cuda_build.load(SOURCE))
    return _lib


def out_size(size: int, kernel: int, stride: int, padding: int,
             dilation: int) -> int:
    return (size + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def _check(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype,
           out_scale: Optional[torch.Tensor]) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4 or x_q.shape[1] != w_q.shape[3]:
        raise ValueError(f"x_q (N, Cin, H, W) {tuple(x_q.shape)} does not "
                         f"match w_q (Cout, kh, kw, Cin) "
                         f"{tuple(w_q.shape)}")
    cout = w_q.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (cout,)):
            raise ValueError(f"{name} must be f32 ({cout},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out_scale is not None and (out_scale.dtype != torch.float32
                                  or out_scale.numel() != 1):
        raise ValueError("out_scale must be one f32 value")
    if dtype not in _MODES:
        raise ValueError(f"output dtype must be f32 or bf16, got {dtype}")
    tensors = [x_q, w_q, scale] + [t for t in (bias, out_scale)
                                   if t is not None]
    if any(t.device != x_q.device for t in tensors):
        raise ValueError("int8_conv's tensors are on different devices")
    if w_q.shape[1] * w_q.shape[2] * w_q.shape[3] * QMAX * QMAX >= 2 ** 31:
        raise ValueError("kh*kw*Cin too large for an exact int32 sum")


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int, padding: int,
              dilation: int, dtype: torch.dtype,
              out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 conv with the fused rescale/bias/requantize epilogue.  ``x_q``
    int8 (N, Cin, H, W), ``w_q`` int8 (Cout, kh, kw, Cin), ``scale`` and
    ``bias`` f32 (Cout,), ``out_scale`` a f32 scalar tensor (>= 1e-12).
    Returns (N, Cout, Ho, Wo) in ``dtype``, or int8 with ``out_scale``, in
    ``channels_last`` memory.  CUDA tensors run K3 as `launch_plan` says,
    CPU tensors the plain version."""
    _check(x_q, w_q, scale, bias, dtype, out_scale)
    return torch.ops.ssd.int8_conv(x_q, w_q, scale, bias, stride, padding,
                                   dilation, dtype, out_scale)


@torch.library.custom_op("ssd::int8_conv", mutates_args=(),
                         device_types="cpu")
def int8_conv_op(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], stride: int, padding: int,
                 dilation: int, dtype: torch.dtype,
                 out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The op behind `int8_conv`; on the CPU, the plain version."""
    return int8_conv_plain(x_q, w_q, scale, bias, stride, padding, dilation,
                           dtype, out_scale)


@int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int, padding: int, dilation: int,
                    dtype: torch.dtype, out_scale: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    global launches
    device = x_q.device
    n, cin, h, w = x_q.shape
    cout, kh, kw, _ = w_q.shape
    ho = out_size(h, kh, stride, padding, dilation)
    wo = out_size(w, kw, stride, padding, dilation)
    out_dtype = torch.int8 if out_scale is not None else dtype
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out.permute(0, 3, 1, 2)
    x_q = x_q.contiguous(memory_format=torch.channels_last)
    w_q = w_q.contiguous()
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    mode = (_INT8_MODES if out_scale is not None else _MODES)[dtype]
    p, padded = launch_plan(
        n, h, w, cin, cout, kh, kw, stride, padding, dilation,
        aligned=x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    if padded is not None:
        x_q, w_q = pad_channels(x_q, w_q, padded)
    table = (None if p.path == "vec"
             else _device_table(p, cin, kh, kw, dilation, device))
    lib = _lib or build()
    args = (x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if out_scale is None else out_scale.data_ptr(),
            None if table is None else table.data_ptr(),
            out.data_ptr(), n, h, w, x_q.shape[1], cout, kh, kw, stride,
            padding, dilation, ho, wo, mode, PATH_IDS[p.path], p.bm, p.bn,
            p.wm, p.wn, p.stages, p.tile_h, p.tile_w, p.smem,
            torch.cuda.current_stream(device).cuda_stream)
    if device.index == torch.cuda.current_device():
        err = lib.ssd_int8_conv(*args)
    else:
        with torch.cuda.device(device):
            err = lib.ssd_int8_conv(*args)
    cuda_build.check(lib, err, f"ssd_int8_conv ({p.name})")
    launches += 1
    return out.permute(0, 3, 1, 2)


@int8_conv_op.register_fake
def _int8_conv_fake(x_q: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int, padding: int, dilation: int,
                    dtype: torch.dtype, out_scale: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    n, _, h, w = x_q.shape
    cout, kh, kw, _ = w_q.shape
    out = x_q.new_empty((n, out_size(h, kh, stride, padding, dilation),
                         out_size(w, kw, stride, padding, dilation), cout),
                        dtype=torch.int8 if out_scale is not None else dtype)
    return out.permute(0, 3, 1, 2)

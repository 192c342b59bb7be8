"""Greedy-NMS suppression: the CUDA kernel `csrc/nms.cu` and its plain
PyTorch version.

The port of the retired Pallas kernel `infer/nms_pallas.py` (git
``eb1d1b7``).  `greedy_nms_keep` takes score-sorted candidate sets
``(..., K, 4)`` f32 xyxy and their validity ``(..., K)`` bool and returns the
keep mask ``(..., K)`` bool.  On a CUDA tensor it launches the kernel (and
raises if that fails); on a CPU tensor it runs the plain version,
`greedy_nms_mask` over `pairwise_iou`.  Nothing falls back from one to the
other.

Both are the custom op ``ssd::nms_keep`` (registered at import): the CPU
implementation is the plain version, the CUDA one the kernel, and a fake
(shape) implementation lets `torch.export` record the op as one node, so
an exported program launches the kernel where the eager `postprocess`
does.

The kernel is built by `cuda_build` (``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``) on its first use.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from objectdetection_ssd_torch import cuda_build
from objectdetection_ssd_torch.ops.boxes import pairwise_iou

SOURCE = cuda_build.CSRC_DIR / "nms.cu"
MAX_K = 256

# Kernel launches since the last reset (the plain CPU path does not count).
launches = 0
_lib: Optional[ctypes.CDLL] = None


def greedy_nms_mask(iou: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates, batched — the plain
    version, a transcription of `infer/postprocess.py:greedy_nms_mask`.

    iou: (..., K, K) pairwise IoU; valid: (..., K).  Returns (..., K) keep:
    a candidate is kept iff it is valid and no earlier kept candidate
    overlaps it >= threshold (reference `Losses.py:44-56`).
    """
    over = iou >= iou_threshold
    suppress = torch.zeros_like(valid)
    for i in range(iou.shape[-1]):
        prev = suppress[..., i].clone()
        active = ~prev & valid[..., i]
        suppress = torch.where(active[..., None], suppress | over[..., i, :],
                               suppress)
        suppress[..., i] = prev            # a box never suppresses itself
    return valid & ~suppress


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give ``lib.ssd_nms_keep`` its C signature; returns ``lib``."""
    lib.ssd_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p]
    lib.ssd_nms_keep.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = declare(cuda_build.load(SOURCE))
    return _lib


def _check(cand_boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if cand_boxes.dim() < 2 or cand_boxes.shape[-1] != 4:
        raise ValueError(f"cand_boxes must be (..., K, 4), got "
                         f"{tuple(cand_boxes.shape)}")
    if tuple(valid.shape) != tuple(cand_boxes.shape[:-1]):
        raise ValueError(f"valid {tuple(valid.shape)} does not match "
                         f"cand_boxes {tuple(cand_boxes.shape)}")
    if cand_boxes.dtype != torch.float32:
        raise TypeError(f"cand_boxes must be float32, got {cand_boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if not 1 <= cand_boxes.shape[-2] <= MAX_K:
        raise ValueError(f"K = {cand_boxes.shape[-2]} outside the kernel's "
                         f"range 1..{MAX_K}")
    if cand_boxes.device != valid.device:
        raise ValueError("cand_boxes and valid are on different devices")
    if not (cand_boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("cand_boxes and valid must be contiguous")


def greedy_nms_keep(cand_boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """(..., K, 4) f32 xyxy boxes sorted by score + (..., K) validity ->
    (..., K) keep mask.  CUDA tensors run the kernel, CPU tensors the plain
    version; both take the same inputs (1 <= K <= 256, contiguous)."""
    _check(cand_boxes, valid)
    return torch.ops.ssd.nms_keep(cand_boxes, valid, float(iou_threshold))


@torch.library.custom_op("ssd::nms_keep", mutates_args=(),
                         device_types="cpu")
def nms_keep(cand_boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """The op behind `greedy_nms_keep`; on the CPU, the plain version."""
    return greedy_nms_mask(pairwise_iou(cand_boxes, cand_boxes), valid,
                           iou_threshold)


@nms_keep.register_kernel("cuda")
def _nms_keep_cuda(cand_boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    global launches
    device = cand_boxes.device
    keep = torch.empty_like(valid)
    k = cand_boxes.shape[-2]
    num_sets = valid.numel() // k
    if num_sets == 0:
        return keep
    lib = _lib or build()
    args = (cand_boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            num_sets, k, iou_threshold,
            torch.cuda.current_stream(device).cuda_stream)
    # The kernel launches on the current device: switch only when the
    # tensors live on another one.
    if device.index == torch.cuda.current_device():
        err = lib.ssd_nms_keep(*args)
    else:
        with torch.cuda.device(device):
            err = lib.ssd_nms_keep(*args)
    cuda_build.check(lib, err, "ssd_nms_keep")
    launches += 1
    return keep


@nms_keep.register_fake
def _nms_keep_fake(cand_boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    return torch.empty_like(valid)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`objectdetection_ssd_torch`) on one CUDA
card: builds every hand kernel (K1 greedy NMS, K2 the 3x3 filter
gradient, K3 the int8 conv, K4 the fused bias add and ReLU, K5 the max
pool), holds each
against its plain PyTorch version, serves SSD300
requests through `Detector`, takes SSD300 train steps with K2 on the
routed convs, times both paths, and drives the training entry point
(Loader, Trainer, checkpoints and resume, `cli eval`, `Detector.
from_checkpoint`) on a synthetic VOC fixture held in packed caches.

    python3 chip_smoke.py          # from the repo root, one card, nvcc

    python3 chip_smoke.py --k1-baseline OLD.cu   # also time other K1
                                                 # sources (repeatable) on
                                                 # the same inputs
    python3 chip_smoke.py --k3-baseline OLD.cu   # the same for K3, through
                                                 # the first K3's C entry

Phases, one line each: device, build (each kernel's registers and
spills; a spill fails), K1 vs plain, K2 vs plain, the bias-relu kernel
(K4 bit-equal to its plain version at every SSD300 and ResNet-34 shape it
serves, ragged, unaligned and NaN / inf cases; the Detectors' inference
forward bit-equal to the grad-enabled one; per shape at batch 256 its
time against its byte bound, the plain version, the add_ + relu pair it
replaces, the bias-free cuDNN conv and torch.cudnn_convolution_relu;
host time per call of the op, the launcher, the layer's entry, the
checked entry and the pair), the max-pool kernel (K5 bit-equal to its
plain version at every pool the port serves at batch 256 in bf16, f32 and
int8, ragged, odd, unaligned and sliced maps, NaN / inf / signed-zero
cases; per pool at batch 256 its
time against its byte bound, the plain version (int8: the f16 round trip
it replaces) and F.max_pool2d; host time per call of the op, the
launcher, the layer's entry, the checked entry and F.max_pool2d), the
serving slice (K4 23 and K5 5 launches per SSD300 request, 4 and 1 per
ResNet-34 one),
serving timing (K1 at the serving and the exact-eval shape: device time
per launch from torch.profiler, host time per call, CUDA-event time,
valid counts, bounds), the train slice (with the routed conv's dX
layout), the frozen-conv1 step, train timing (with a bf16
routed-vs-unrouted gradient check and a profile of both steps), the
trainer slice (the Loader alone, three epochs of `Trainer.fit`, resume,
`cli eval` with K1 launched for every batch, detect from the checkpoint,
no fall-through from the native data library), then the ResNet-34
family: its serving slice (bf16 `detect_batch`, f32 card vs CPU with
non-trivial BN statistics, Soft-NMS and flip TTA card vs CPU), its train
steps (card vs CPU with dropout 0, dropout masks from the seed), the CLI
(`train --backbone resnet34`, `--resume`, `eval` with K1 at K = 189,
`detect` hard and with TTA + Soft-NMS), a remat step against the plain
one with the peak memory of each, and ResNet-34 serving, Soft-NMS, TTA,
K1 and train-step timing.  Then int8: K3 bit-equal to its plain version
at every SSD300 and ResNet-34 conv shape, ragged ones that reach every
instantiation of its plan, and requantize ties; int8 serving
of both families calibrated on the card (K3 and K5 counted per forward,
chained == unchained, card vs CPU, flip TTA); int8 serving at batch 256 beside
bf16 and K3 per conv shape at batch 32 against its bound, cuDNN's bf16
conv, `torch._int_mm` and any `--k3-baseline`; QAT steps card vs CPU and
`cli train --qat` -> `eval` / `detect --int8` with the fingerprint
binding enforced.  Then the serving artifact (`infer/export.py`): SSD300
bf16, SSD300 int8 as `cli export --latency-profile` builds it and
ResNet-34 with flip TTA, each exported on the card, loaded and served
through `ExportedDetector` (== the live `detect_batch`, K1 once, K3 23
times, K4 23 (bf16 SSD300) or 8 (ResNet-34 with TTA) and K5 5 (SSD300) or
2 (ResNet-34 with TTA) times per chunk, one ``ssd.max_pool`` node per
pool), reloaded, moved to the CPU, and timed against the live
Detector with and without a CUDA graph; `torch.library.opcheck` of the
four custom ops; the MicroBatcher over 16 concurrent requests.  Then data
parallelism (`parallel/`): a two-rank DDP step over gloo with both ranks
on the one card against the single-process step; under a one-rank NCCL
group joined through `distributed.initialize` (NCCL takes one rank per
card), f32 DDP and FSDP2 steps against the unwrapped step (K2 counted),
bf16 batch-32 wrapped and unwrapped steps timed in turns (the wrappers'
overhead), `cli train --eval-map-every 1 --profile-dir` and `cli eval
--data-parallel 1` on the trainer slice's fixture (multi-rank mAP == the
plain path's, K1 once per batch); the ResNet-34 step's host time split
under `profiler_trace`; `cli doctor --json`.  Then tensor and spatial
parallelism (`parallel/tensor_parallel.py`, `parallel/spatial.py`): two
gloo ranks sharing the one card on a (1, 2) data x model and a (1, 2)
data x spatial mesh, the f32 routed SSD300 step against the
single-process card step (K2 counted), QAT steps under data, tensor and
spatial parallelism against the single-process card QAT step, the
ResNet-34 train-mode step under SP, bf16 and int8 `Detector(mesh=)`
serving (K1 per batch, K3 23 per forward per rank, every K3 call
bit-equal to its slice of the single-process call), one `Trainer.fit`
epoch and one `evaluate_records` under SP on the trainer fixture (the
checkpoint reloaded at world size 1), and the bytes SSD300's gathers and
halos move per step.  Then pipeline parallelism (`parallel/pipeline.py`)
with every stage on the one card: the 2-stage step against the
monolithic one (M = 1), against gradient accumulation (M = 2), the 3-
and 4-stage forwards, dp = 2 against dp = 1, a routed step (K2 counted,
4 per microbatch), the bf16 batch-32 step's time and peak memory beside
the monolithic step's, a `Trainer.fit` epoch whose checkpoint a
monolithic Trainer resumes, and `cli train --pp 2` refused on one card.
Phase "api" runs before the parallel phases: the package-level names,
each legacy box op (`mixed_class_nms`, `decode_tanh`, the (y, x, y, x)
shuffles, `pairwise_iou_rescaled`) on the card against the CPU,
`create_global_mesh` with no process group, and the two-stage
`build_ssd300_pipeline` bit-equal to the monolithic f32 forward.
Phase "quality" follows it: the three learnability recipes of
`tests/test_torch_learnability.py` on the card with JAX's thresholds (K1
counted in each hard-NMS measurement, K3 in each int8 one, the QAT steps
on the card), then SSD300 trained through `cli train` on a 1200 + 200
image colour-coded VOC at 400x300 (`benchmarks/quality_ab.py`'s recipe)
and the val mAP of seven inference variants (f32 exact, bf16, int8 with
heads f32 and chained, int8 with heads quantized, flip TTA, Soft-NMS,
int8 after `train --qat`), each within its margin of the f32 base.
Then one JSON line with each kernel's
numbers, the card's name and power limit as nvidia-smi gives them, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before that line.  Without CUDA it exits 1 at once.  It
imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 0
# The VOC fixture of the runs after the trainer slice (the ResNet-34
# trainer, `cli train` under the one-rank group, the SP epoch): half the
# trainer slice's (448, 192), which keeps the script inside its time as
# phase "quality" joins it.
CUT_FIXTURE = (224, 96)
SERVE_BATCHES = (1, 8, 256)     # detect_batch request sizes in the slice
# Images of the largest request whose f32 loc/conf are also computed on
# the CPU.
CPU_CHECK_BATCH = 2
TIMING_BATCH = 256
# K1 vs plain on random (non-prefix) validity masks: the serving K, the
# exact-eval K, and K across the word and warp boundaries.
NMS_SHAPES = ((256, 20, 64), (8, 20, 200), (256, 20, 200), (4, 20, 1),
              (4, 20, 33), (4, 20, 65), (4, 20, 189), (4, 20, 256))
# The plain version is also run on the CPU for sets up to this many
# candidate pairs (sets * K * K).
NMS_CPU_PAIRS = 1 << 23
THR = 0.45
# K1's timed launches per measurement.
K1_CALLS = 200
# Routed conv dX vs autograd's, relative to max|dX|, f32 on the card: the
# same library call on the same operands.
DX_TOL = 1e-6
# K2 shapes (N, H, W, Cin, Cout): conv1_1, conv1_2, conv2_1, conv2_2 of
# SSD300 at the train slice's batch, one ragged shape (the tap-gather
# kernel in both dtypes), and one whose W is not a multiple of the halo
# tile's 32 and whose Cin, Cout are multiples of 8 but not of 64 (the halo
# kernel in bf16).
ROUTED = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
TRAIN_BATCH = 2
TRAIN_STEPS = 3
TIMING_TRAIN_BATCH = 32
MAX_BOXES = 24


def dw_shapes(batch: int) -> tuple:
    return ((batch, 300, 300, 3, 64), (batch, 300, 300, 64, 64),
            (batch, 150, 150, 64, 128), (batch, 150, 150, 128, 128))


DW_SHAPES = dw_shapes(TRAIN_BATCH) + ((3, 37, 41, 5, 7), (2, 19, 45, 24, 40))
# bf16 shapes that K2 also gets as views one element past a 16-byte
# boundary: the plan then takes the tap gather with one-element loads.
DW_UNALIGNED = ((2, 19, 45, 24, 40),)
# K2 vs its plain version, relative to max|dW|.  The products are exact in
# both (f32 x f32 in f32 FMAs, bf16 x bf16 exact in the tensor cores' f32
# accumulators); only the order of the f32 sums differs, which leaves
# about 1e-6 at these sizes: 1e-4 in both types.
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
# Card vs CPU after TRAIN_STEPS f32 steps (TF32 off).  The losses to 1e-4
# relative: cuDNN and oneDNN sum conv products in another order.  That
# noise also flips a few discrete choices (a hard-negative top-k boundary,
# a max-pool near-tie, a ReLU input at ~0), each of which moves one
# position's gradient, and momentum carries it into the later steps.  So
# each parameter tensor's change is held as a whole, by the norm of its
# difference, to 1e-2 of the norm of the CPU's change, and element by
# element to 5e-2 of its largest change (measured by this script on an
# H100 80GB HBM3 at 700 W: 6.0e-3 and 1.5e-2 at worst;
# tests/test_torch_train.py measures 3.4e-3 element-wise between the CPU
# port and JAX after one step).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_DELTA_NORM_TOL = 1e-2
TRAIN_DELTA_TOL = 5e-2
# K2 vs cuDNN's wgrad in the same f32 step on the card: the same forward
# and upstream gradients, another order of the f32 sums.
WGRAD_TOL = 1e-4
# The same comparison in one bf16 step at the timing batch: both dW are
# rounded to bf16 (the Function casts K2's f32 dW to the weight's dtype,
# cuDNN writes bf16), 2^-9 of max|dW| each, and the forward differs by the
# routed convs' separate bias add: 1e-2 of max|dW| (measured by this
# script on an H100 80GB HBM3 at 700 W: 1.4e-3 at conv1_1 to 6.4e-3 at
# conv2_2).
BF16_WGRAD_TOL = 1e-2
PROFILE_STEPS = 3
# The ResNet-34 family: 224 px, 189 priors; its f32 train steps card vs
# CPU run at batch 8, so that each BN at the 1x1 taps normalizes 8 values
# per channel (at batch 2 a BN over two values multiplies its input's
# rounding by up to 1/sqrt(eps) ~ 316, tests/test_torch_resnet.py).
RESNET_SIZE = 224
RESNET_TRAIN_BATCH = 8
# Soft-NMS on the card vs the CPU on the same loc/conf: the same f32
# expressions, exp rounded by another library (a few ulp of scores <= 1).
SOFT_NMS_ATOL = 1e-5
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, non-tensor f32,
# dense bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def random_nms_sets(b: int, c: int, k: int, gen: torch.Generator,
                    device) -> tuple:
    """Clustered xyxy boxes (many overlapping pairs) and ~20% invalid."""
    centers = torch.rand(b, c, 4, 2, generator=gen) * 0.6 + 0.2
    pick = torch.randint(0, 4, (b, c, k), generator=gen)
    cxy = torch.gather(centers, 2, pick[..., None].expand(b, c, k, 2))
    cxy = cxy + torch.randn(b, c, k, 2, generator=gen) * 0.04
    wh = torch.rand(b, c, k, 2, generator=gen) * 0.2 + 0.1
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
    valid = torch.rand(b, c, k, generator=gen) >= 0.2
    return boxes.to(device), valid.to(device)


def crafted_nms_sets(device) -> list:
    """(name, boxes (1, K, 4), valid (1, K), expected keep) edge cases."""
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=device)
    dup = [[0.2, 0.2, 0.6, 0.7]] * 6
    return [
        # IoU exactly 0.45 in f32 (inter 0.45, union 1.45 - 0.45).
        ("iou_exactly_thr", t([[[0, 0, 1, 1], [0, 0, 0.45, 1]]]),
         t([[True, True]], torch.bool), [True, False]),
        # A suppressed box must not suppress.
        ("chain", t([[[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0],
                      [0.5, 0.0, 1.5, 1.0]]]),
         t([[True, True, True]], torch.bool), [True, False, True]),
        ("all_invalid", t([[[0.1, 0.1, 0.5, 0.5]] * 8]),
         t([[False] * 8], torch.bool), [False] * 8),
        ("duplicates", t([dup]),
         t([[False, True, True, False, True, True]], torch.bool),
         [False, True, False, False, False, False]),
        # Zero-area boxes: two equal ones give union 0 and IoU 0/0 = NaN,
        # which suppresses nothing; the last box repeats the third.
        ("zero_area", t([[[0.2, 0.2, 0.2, 0.5], [0.2, 0.2, 0.2, 0.5],
                          [0.1, 0.1, 0.4, 0.4], [0.3, 0.3, 0.3, 0.3],
                          [0.1, 0.1, 0.4, 0.4]]]),
         t([[True] * 5], torch.bool), [True, True, True, True, False]),
    ]


def plain_keep(boxes, valid):
    from objectdetection_ssd_torch.infer.nms_cuda import greedy_nms_mask
    from objectdetection_ssd_torch.ops.boxes import pairwise_iou
    return greedy_nms_mask(pairwise_iou(boxes, boxes), valid, THR)


def phase_kernel_vs_plain(device, shapes=NMS_SHAPES) -> int:
    """K1 against the plain version: bit-equal keep masks.  Returns the
    largest |kernel - plain| over every compared element (0 or 1)."""
    from objectdetection_ssd_torch.infer.nms_cuda import greedy_nms_keep
    gen = torch.Generator().manual_seed(SEED)
    cases = [(f"random{tuple(s)}",) + random_nms_sets(*s, gen, device)
             + (None,) for s in shapes] + crafted_nms_sets(device)
    worst = 0
    for name, boxes, valid, expected in cases:
        kern = greedy_nms_keep(boxes, valid, THR)
        plain = plain_keep(boxes, valid)
        err = int((kern.int() - plain.int()).abs().max().item())
        worst = max(worst, err)
        if not torch.equal(kern, plain):
            fail(f"K1 keep mask differs from the plain version on {name}")
        if expected is not None and kern[0].tolist() != expected:
            fail(f"K1 keep mask {kern[0].tolist()} != {expected} on {name}")
        if (expected is None and boxes.shape[-2] > 1
                and not (valid & ~kern).any()):
            fail(f"nothing suppressed in {name}: the check is vacuous")
        if valid.numel() * boxes.shape[-2] <= NMS_CPU_PAIRS:
            if not torch.equal(plain.cpu(),
                               plain_keep(boxes.cpu(), valid.cpu())):
                fail(f"plain version differs between card and CPU on {name}")
    return worst


def seeded_state_dict(seed: int = SEED) -> dict:
    """Random SSD300 weights from ``seed``; conf-head biases ~ N(0, 3) so
    that many candidates clear the 0.2 threshold and NMS has work."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.models.ssd import build_model
    gen = torch.Generator().manual_seed(seed)
    model = build_model(ModelConfig(), device="cpu", generator=gen)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(6):
        bias = sd[f"conf_head_{i}.bias"]
        bias.copy_(torch.randn(bias.shape, generator=gen) * 3.0)
    return sd


def same_detections(a, b, atol: float) -> bool:
    if not (torch.equal(a.valid, b.valid) and torch.equal(a.classes,
                                                          b.classes)):
        return False
    v = a.valid
    return bool(torch.allclose(a.scores[v], b.scores[v], atol=atol, rtol=0)
                and torch.allclose(a.boxes_xyxy[v], b.boxes_xyxy[v],
                                   atol=atol, rtol=0))


def serve_requests(det, images: dict, what: str) -> tuple:
    """The serving main path: ``det.detect_batch`` on each batch of
    ``images`` (K1's and K3's counts set to 0 just before, read just
    after), each result well formed, and the kernel path's detections
    equal to the plain-NMS path's on the same loc/conf.  Returns (K1
    launches, valid detections per batch, candidates suppressed, K3
    launches, K4 launches, K5 launches)."""
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer import postprocess as pp
    from objectdetection_ssd_torch.ops import bias_relu, int8_conv, max_pool
    nms_cuda.launches = 0
    int8_conv.launches = 0
    bias_relu.launches = 0
    max_pool.launches = 0
    served = {b: det.detect_batch(x) for b, x in images.items()}
    if det.device.type == "cuda":
        torch.cuda.synchronize()
    launches, k3_launches = nms_cuda.launches, int8_conv.launches
    k4_launches, k5_launches = bias_relu.launches, max_pool.launches

    n_valid, n_suppressed = {}, 0
    for b, d in served.items():
        if d.boxes_xyxy.shape != (b, 200, 4) or not torch.isfinite(
                d.boxes_xyxy).all() or not torch.isfinite(d.scores).all():
            fail(f"{what} detect_batch({b}) gave malformed detections")
        n_valid[b] = int(d.valid.sum())
        # Kernel path vs plain NMS on the same loc/conf.
        loc, conf = det.forward(images[b])
        kern = pp.postprocess(loc, conf, det.priors, det.pp_config)
        cand, scores, valid = pp.select_candidates(loc, conf, det.priors,
                                                   det.pp_config)
        keep = plain_keep(cand, valid)
        n_suppressed += int((valid & ~keep).sum())
        plain = pp.finalize(cand, scores, keep, det.pp_config.top_k)
        if not same_detections(kern, plain, atol=1e-6):
            fail(f"{what} batch {b}: kernel-path detections != plain-NMS "
                 f"path")
    if n_suppressed == 0 or min(n_valid.values()) == 0:
        fail(f"the {what} slice gave NMS no work ({n_valid}, "
             f"{n_suppressed})")
    return (launches, n_valid, n_suppressed, k3_launches, k4_launches,
            k5_launches)


def rel_diff(got, want) -> float:
    """The largest |got - want| of each pair of tensors over that of
    ``want`` (on the CPU), the worst pair."""
    return max(float((g.cpu() - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def phase_slice(device, state_dict, batches=SERVE_BATCHES) -> dict:
    """Serve detect_batch requests in f32 (TF32 off) and check them."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.models.ssd import build_model

    det = Detector(Config(), state_dict, device=device)
    gen = torch.Generator().manual_seed(SEED + 1)
    images = {b: torch.randint(0, 256, (b, 300, 300, 3), generator=gen,
                               dtype=torch.uint8).to(device)
              for b in batches}

    launches, n_valid, n_suppressed, _, k4, k5 = serve_requests(
        det, images, "SSD300")
    if device.type == "cuda" and k4 != K4_PER_FORWARD["ssd300"] * len(
            batches):
        fail(f"K4 launched {k4} times for {len(batches)} SSD300 requests")
    if device.type == "cuda" and k5 != K5_PER_FORWARD["ssd300"] * len(
            batches):
        fail(f"K5 launched {k5} times for {len(batches)} SSD300 requests")

    # The card's loc/conf against the same model on the CPU.
    x = images[max(batches)][:CPU_CHECK_BATCH]
    cpu_model = build_model(ModelConfig(), device="cpu")
    cpu_model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        rel = rel_diff(det.forward(x), cpu_model(x.cpu()))
    # Conv algorithms sum in another order on the card (and may use
    # Winograd/FFT); 1e-3 of each output's largest magnitude.
    if not rel <= 1e-3:
        fail(f"card vs CPU loc/conf differ by {rel:.3e} of their scale")
    return {"launches": launches, "valid": n_valid,
            "suppressed": n_suppressed, "card_vs_cpu_rel": rel, "k4": k4,
            "k5": k5}


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past the start
    of its storage."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def phase_dw_vs_plain(device, shapes=DW_SHAPES, unaligned=DW_UNALIGNED,
                      seed: int = SEED) -> list:
    """K2 against its plain version on the same card tensors, in f32 and
    bf16, at ``shapes``, and in bf16 on unaligned views at ``unaligned``;
    fails past `DW_TOL`, or if a second run does not give the same bits."""
    from objectdetection_ssd_torch.ops import dw_cuda
    gen = torch.Generator().manual_seed(seed + 3)
    rows = []
    cases = [(dtype, shape, True)
             for dtype in (torch.float32, torch.bfloat16) for shape in shapes]
    cases += [(torch.bfloat16, shape, False) for shape in unaligned]
    for dtype, (n, h, w, cin, cout), aligned in cases:
        x = torch.randn(n, h, w, cin, generator=gen).relu()
        g = torch.randn(n, h, w, cout, generator=gen) * 1e-3
        x, g = x.to(device, dtype), g.to(device, dtype)
        if not aligned:
            x, g = unaligned_copy(x), unaligned_copy(g)
        kern = dw_cuda.dw_conv3x3p1(x, g)
        if not torch.equal(kern, dw_cuda.dw_conv3x3p1(x, g)):
            fail(f"K2 {dtype} {(n, h, w, cin, cout)}: two runs differ")
        plain = dw_cuda.dw_conv3x3p1_plain(x, g)
        err = float((kern - plain).abs().max())
        scale = float(plain.abs().max())
        rel = err / scale
        if not (scale > 0 and math.isfinite(err) and rel <= DW_TOL[dtype]):
            fail(f"K2 {dtype} {(n, h, w, cin, cout)}: {rel:.3e} of "
                 f"max|dW| {scale:.3e} differs from the plain version")
        rows.append({"dtype": str(dtype).replace("torch.", ""),
                     "kernel": dw_cuda.plan(n, h, w, cin, cout, dtype,
                                            aligned).kernel,
                     "aligned": aligned,
                     "shape": [n, h, w, cin, cout], "max_abs_err": err,
                     "scale": scale, "rel": rel, "tol": DW_TOL[dtype]})
    return rows


# ------------------------------------------------------------ K4

K4_CHECK_BATCH = 32
K4_TIMING_BATCH = 256
K4_HOST_CALLS = 200
K4_DETECTOR_BATCH = 8
K4_B1_REQUESTS = 20
# K4 launches per forward: SSD300's 23 ReLU'd convs (13 VGG, fc6, fc7, 8
# extra), ResNet-34's 4 neck convs (one module called twice).
K4_PER_FORWARD = {"ssd300": 23, "resnet34": 4}
# Ragged and edge cases beside the models' shapes (N, C, H, W): C not a
# multiple of the bf16 vector (8 values) nor of the f32 one (4), and the
# map one element past a 16-byte boundary.
K4_RAGGED = ((3, 126, 7, 9), (2, 3, 11, 5))
K4_UNALIGNED = ((2, 64, 9, 11),)
K4_DTYPES = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def relu_conv_shapes(device) -> list:
    """Every conv call that K4 serves in one batch-1 inference forward of
    SSD300 (300 px) and ResNet-34 (224 px) on ``device``: those called
    with ``relu=True`` that have a bias, as forward hooks see them (model,
    conv, input and output shape, weight shape, geometry)."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.models.layers import TorchConv
    from objectdetection_ssd_torch.models.ssd import build_model
    rows = []
    for model_name, cfg, size in (
            ("ssd300", ModelConfig(), 300),
            ("resnet34", resnet_config(), RESNET_SIZE)):
        model = build_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))

        def hook(name):
            def record(mod, args, kwargs, out):
                if kwargs.get("relu") and mod.bias is not None:
                    rows.append({
                        "model": model_name, "conv": name,
                        "in": tuple(args[0].shape),
                        "out": tuple(out.shape),
                        "weight": tuple(mod.weight.shape),
                        "geometry": (mod.stride[0], mod.padding[0],
                                     mod.dilation[0])})
            return record

        handles = [m.register_forward_hook(hook(n), with_kwargs=True)
                   for n, m in model.named_modules()
                   if isinstance(m, TorchConv)]
        with torch.inference_mode():
            model(torch.zeros(1, size, size, 3, dtype=torch.uint8,
                              device=device))
        for h in handles:
            h.remove()
        got = sum(r["model"] == model_name for r in rows)
        if got != K4_PER_FORWARD[model_name]:
            fail(f"{model_name}: {got} ReLU'd convs with a bias, want "
                 f"{K4_PER_FORWARD[model_name]}")
    return rows


def k4_operands(shape, dtype, gen, device, aligned=True, specials=False):
    """y (N, C, H, W) in channels_last memory and bias (C,) in ``dtype``:
    normal values (y scaled by 3); ``specials`` plants NaN, +-inf and -0.0
    in both; ``aligned=False`` puts y one element past a 16-byte
    boundary."""
    n, c, h, w = shape
    y = torch.randn(n, h, w, c, generator=gen, device=device) * 3
    b = torch.randn(c, generator=gen, device=device)
    if specials:
        flat = y.view(-1)
        idx = torch.randint(0, flat.numel(), (64,), generator=gen,
                            device=device)
        for i, value in enumerate((math.nan, math.inf, -math.inf, -0.0)):
            flat[idx[i::4]] = value
        b[0], b[-1] = math.nan, -0.0
        if c > 3:
            b[1], b[2] = math.inf, -math.inf
    y, b = y.to(dtype), b.to(dtype)
    if not aligned:
        y = unaligned_copy(y)
    return y.permute(0, 3, 1, 2), b


def k4_equal(got, want, int_dtype) -> bool:
    """Bit for bit, whatever the two tensors' strides."""
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.view(int_dtype), want.view(int_dtype)))


def k4_bound_ms(shape, dtype) -> float:
    """Least time for K4's work: y read once, out written once and the
    bias read once, over HBM rate; its 2 operations a value (add, max)
    over the non-tensor f32 peak take less on every shape here."""
    n, c, h, w = shape
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * n * c * h * w + c) * size / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * c * h * w / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops)


def k4_detector_check(device, state_dict, resnet_state_dict,
                      batch: int = K4_DETECTOR_BATCH) -> dict:
    """SSD300's and ResNet-34's bf16 loc/conf under ``inference_mode`` (K4
    on the card) against the same forward with grad enabled and the input
    requiring grad (the conv's own bias add, then ``F.relu``), on the
    same inputs, cuDNN deterministic: bit for bit.  K4's launches in the
    first are counted."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.ops import bias_relu as k4
    out = {}
    gen = torch.Generator().manual_seed(SEED + 41)
    for name, cfg, sd, size in (
            ("ssd300", ModelConfig(compute_dtype="bfloat16"), state_dict,
             300),
            ("resnet34", resnet_config(compute_dtype="bfloat16"),
             resnet_state_dict, RESNET_SIZE)):
        det = Detector(Config(model=cfg), sd, device=device)
        x = torch.randn(batch, size, size, 3, generator=gen).to(device)
        with deterministic_cudnn():
            k4.launches = 0
            with torch.inference_mode():
                fused = det.model(x)
            if device.type == "cuda":
                torch.cuda.synchronize()
            launches = k4.launches
            with torch.enable_grad():
                plain = det.model(x.clone().requires_grad_(True))
        plain = tuple(t.detach() for t in plain)
        want = K4_PER_FORWARD[name] if device.type == "cuda" else 0
        if launches != want:
            fail(f"K4 {name}: {launches} launches in one inference forward, "
                 f"want {want}")
        for a, b in zip(fused, plain):
            if not k4_equal(a, b, torch.int16):
                fail(f"K4 {name}: inference loc/conf differ from the "
                     f"grad-enabled forward's by "
                     f"{float((a.float() - b.float()).abs().max()):.3e}")
        out[name] = {"launches": launches, "batch": batch}
    return out


@contextlib.contextmanager
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def phase_bias_relu(device, state_dict, resnet_state_dict,
                    check_batch: int = K4_CHECK_BATCH,
                    timing_batch: int = K4_TIMING_BATCH,
                    detector_batch: int = K4_DETECTOR_BATCH) -> dict:
    """K4 (`ops/bias_relu.py`) against its plain version on the same card
    tensors, bit for bit: every SSD300 and ResNet-34 shape it serves at
    ``check_batch`` in bf16 and f32, ragged C, an unaligned map, NaN /
    +-inf / -0.0 in y and the bias; then the Detectors' inference forward
    (K4) bit-equal to the grad-enabled one.  On the card also: per SSD300
    and ResNet-34 shape at ``timing_batch`` (bf16, CUDA graph replay): K4,
    its byte bound, the plain version, the ``add_`` + ``relu`` pair that
    the conv ran before, the bias-free cuDNN conv and
    ``torch.cudnn_convolution_relu`` (conv, bias and ReLU in one cuDNN
    call) as a reference; and the host time per call of the op, the
    direct launcher, the layer's entry, the checked entry and the pair."""
    from objectdetection_ssd_torch.ops import bias_relu as k4
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    shapes = relu_conv_shapes(device)
    cases = []
    for dtype in K4_DTYPES:
        seen = set()
        for r in shapes:
            shape = (check_batch,) + r["out"][1:]
            if shape not in seen:
                seen.add(shape)
                cases.append((dtype, shape, True, False))
        cases += [(dtype, s, True, False) for s in K4_RAGGED]
        cases += [(dtype, s, False, False) for s in K4_UNALIGNED]
        cases += [(dtype, s, True, True)
                  for s in K4_RAGGED + K4_UNALIGNED + ((4, 64, 19, 19),)]
        cases += [(dtype, s, False, True) for s in K4_UNALIGNED]
    for dtype, shape, aligned, specials in cases:
        y, b = k4_operands(shape, dtype, gen, device, aligned, specials)
        got = k4.bias_relu(y, b)
        want = k4.bias_relu_plain(y, b)
        if not k4_equal(got, want, K4_DTYPES[dtype]):
            bits = K4_DTYPES[dtype]
            fail(f"K4 {dtype} {shape} aligned={aligned} specials="
                 f"{specials}: {int((got.view(bits) != want.view(bits)).sum())}"
                 f" values differ from the plain version's bits")
        if not got.is_contiguous(memory_format=torch.channels_last):
            fail(f"K4 {dtype} {shape}: output not channels_last")
    out = {"compared": len(cases), "shapes": len(shapes),
           "max_abs_err": 0.0,
           "detector": k4_detector_check(device, state_dict,
                                         resnet_state_dict, detector_batch)}
    if not on_card:
        return out

    # Timing at the serving batch, one shape at a time.
    rows = []
    for r in shapes:
        shape = (timing_batch,) + r["out"][1:]
        y, b = k4_operands(shape, torch.bfloat16, gen, device)
        scratch = y.clone()
        reps = 3 if y.numel() > 1 << 26 else 10
        row = {"model": r["model"], "conv": r["conv"], "shape": list(shape),
               "ms": graph_ms(lambda: k4.bias_relu(y, b), reps=reps),
               "plain_ms": graph_ms(lambda: k4.bias_relu_plain(y, b),
                                    reps=reps),
               # What the conv ran before: aten's in-place bias add after
               # cuDNN, then F.relu.
               "pair_ms": graph_ms(lambda: torch.relu(
                   scratch.add_(b[None, :, None, None])), reps=reps),
               "bound_ms": k4_bound_ms(shape, torch.bfloat16),
               "bound_by": "bytes"}
        del y, scratch
        # The conv's input and weight at this shape; both cuDNN calls timed
        # eagerly between CUDA events (no graph capture of a fused call
        # that may be refused).
        cin = r["in"][1]
        x = torch.randn((timing_batch, r["in"][2], r["in"][3], cin),
                        generator=gen, device=device).to(torch.bfloat16)
        x = x.permute(0, 3, 1, 2)
        w = (torch.randn(r["weight"], generator=gen, device=device)
             * 0.05).to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last)
        stride, padding, dilation = r["geometry"]
        iters = 3 * reps
        row["conv_ms"] = cuda_ms(lambda: torch.nn.functional.conv2d(
            x, w, None, stride, padding, dilation), iters)
        try:
            fused = lambda: torch.cudnn_convolution_relu(  # noqa: E731
                x, w, b, (stride, stride), (padding, padding),
                (dilation, dilation), 1)
            fused()
            row["cudnn_relu_ms"] = cuda_ms(fused, iters)
        except (RuntimeError, AttributeError) as e:
            row["cudnn_relu_ms"] = None
            row["cudnn_relu_error"] = str(e).splitlines()[0][:120]
        del x, w
        torch.cuda.empty_cache()
        row["share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    out["rows"] = rows

    # One batch-1 bf16 SSD300 request: its device operations (K4's 23
    # among them) and their device time.
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer.detector import Detector
    det = Detector(Config(model=ModelConfig(compute_dtype="bfloat16")),
                   state_dict, device=device)
    x1 = torch.randint(0, 256, (1, 300, 300, 3), dtype=torch.uint8,
                       generator=gen, device=device)
    ms, kernels = device_ms_per_call(lambda: det.detect_batch(x1),
                                     K4_B1_REQUESTS)
    out["b1"] = {"device_ms": ms,
                 "ops": sum(kernels.values()) / K4_B1_REQUESTS,
                 "k4": sum(v for k, v in kernels.items()
                           if "bias_relu" in k) / K4_B1_REQUESTS}
    del det

    # Host time per call at the smallest SSD300 map at batch 1, in turns.
    small = min((r for r in shapes if r["model"] == "ssd300"),
                key=lambda r: math.prod(r["out"]))
    y, b = k4_operands((1,) + small["out"][1:], torch.bfloat16, gen, device)
    scratch = y.clone()
    calls = {"op": lambda: torch.ops.ssd.bias_relu(y, b),
             "launcher": lambda: k4.launch(y, b),
             "conv_bias_relu": lambda: k4.conv_bias_relu(y, b),
             "bias_relu": lambda: k4.bias_relu(y, b),
             "pair": lambda: torch.relu(scratch.add_(b[None, :, None,
                                                       None]))}
    host = {key: [] for key in calls}
    for _ in range(2):
        for key, fn in calls.items():
            host[key].append(host_ms_per_call(fn, K4_HOST_CALLS))
    out["host_shape"] = [1] + list(small["out"][1:])
    out["host_ms"] = {key: min(v) for key, v in host.items()}
    return out


# ------------------------------------------------------------ K5

K5_TIMING_BATCH = 256
K5_HOST_CALLS = 200
# K5 launches per inference forward on the card: SSD300's pools 1-5, the
# ResNet-34 stem's pool.
K5_PER_FORWARD = {"ssd300": 5, "resnet34": 1}
# Every pool the port serves, per image (C, H, W) with (window, stride,
# padding, ceil_mode): SSD300's five (`models/backbones.py:VGG16Trunk`),
# pool3 in ceil mode (75 -> 38), pool5 3x3/s1/p1; the ResNet-34 stem's
# 3x3/s2/p1.  The int8 cell pools 1, 2, 3 and 5 in int8: conv4_3, which
# also feeds the L2Norm, is no chained producer, so pool4 stays bf16.
K5_POOLS = (("ssd300", "pool1", (64, 300, 300), (2, 2, 0, False)),
            ("ssd300", "pool2", (128, 150, 150), (2, 2, 0, False)),
            ("ssd300", "pool3", (256, 75, 75), (2, 2, 0, True)),
            ("ssd300", "pool4", (512, 38, 38), (2, 2, 0, False)),
            ("ssd300", "pool5", (512, 19, 19), (3, 1, 1, False)),
            ("resnet34", "stem", (64, 112, 112), (3, 2, 1, False)))
K5_INT8_POOLS = ("pool1", "pool2", "pool3", "pool5")
# Cases beside the models' shapes (N, C, H, W): C not a multiple of the
# vector width (8 bf16, 4 f32, 16 int8 values), and odd maps; each at
# every geometry of K5_POOLS, the stem's in ceil mode, and a window that
# no model uses (4x4/s3/p2, which the scalar kernel takes).
K5_RAGGED = ((3, 126, 7, 9), (2, 3, 11, 5))
K5_EXTRA_GEOMETRIES = ((3, 2, 1, True), (4, 3, 2, False), (4, 3, 2, True))
K5_DTYPES = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
             torch.int8: torch.int8}


def k5_map(shape, dtype, gen, device, specials=False):
    """An (N, C, H, W) map in ``channels_last`` memory: normal values (x3;
    int8 in [-127, 127]); ``specials`` plants NaN, +-inf, +-0.0, windows
    of zeros of both signs and of -inf (int8: -128 and 127, and windows of
    one value)."""
    n, c, h, w = shape
    x = torch.randn(n, h, w, c, generator=gen, device=device) * 3
    if dtype == torch.int8:
        x = (x * 10).round().clamp(-127, 127)
    if specials:
        flat = x.view(-1)
        idx = torch.randint(0, flat.numel(), (80,), generator=gen,
                            device=device)
        values = ((-128.0, 127.0) if dtype == torch.int8
                  else (math.nan, math.inf, -math.inf, 0.0, -0.0))
        for i, value in enumerate(values):
            flat[idx[i::len(values)]] = value
        if dtype == torch.int8:
            x[:, :3, :3] = -128.0
        else:
            sign = torch.rand(n, 3, 3, c, generator=gen, device=device) < 0.5
            x[:, :3, :3] = torch.where(sign, 0.0, -0.0)
            x[:, -2:, -2:] = -math.inf
    return x.to(dtype).permute(0, 3, 1, 2)


def k5_bound_ms(shape, geometry, dtype) -> tuple:
    """Least time for K5's work on an (N, C, H, W) map: the input read once
    and the output written once over HBM rate, against one compare a
    value per tap over the non-tensor f32 peak; (ms, "bytes" or
    "operations")."""
    from objectdetection_ssd_torch.ops import max_pool as k5
    n, c, h, w = shape
    window, stride, padding, ceil_mode = geometry
    ho = k5.out_size(h, window, stride, padding, ceil_mode)
    wo = k5.out_size(w, window, stride, padding, ceil_mode)
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = n * c * (h * w + ho * wo) * size / HBM_BYTES_PER_S * 1e3
    t_ops = n * c * ho * wo * window * window / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_max_pool(device, check_batch: int = K5_TIMING_BATCH,
                   timing_batch: int = K5_TIMING_BATCH) -> dict:
    """K5 (`ops/max_pool.py`) against its plain version on the same card
    tensors, bit for bit: every pool the port serves at ``check_batch`` in
    bf16, f32 and int8; ragged C and odd maps at every geometry and three
    more; an unaligned map and sliced inputs (a batch slice read in place,
    an H slice and a channel slice copied to ``channels_last``); NaN /
    +-inf / +-0.0 cases (int8: -128 and 127).  (The serving slices count
    K5's launches per request.)  On the card also: per pool
    at ``timing_batch`` (bf16; int8 at the int8 cell's pools), as a CUDA
    graph: K5, its byte bound, the plain version (int8: the f16 round trip
    it replaces) and ``F.max_pool2d`` (bf16; no PyTorch call pools int8
    on the card); and the host time per call of the op, the launcher, the
    layer's entry, the checked entry and ``F.max_pool2d``."""
    from objectdetection_ssd_torch.ops import max_pool as k5
    F = torch.nn.functional
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    cases = []
    for dtype in K5_DTYPES:
        for _, _, chw, geometry in K5_POOLS:
            cases.append((dtype, (check_batch,) + chw, geometry, "model"))
        geometries = list(dict.fromkeys(
            [g for _, _, _, g in K5_POOLS] + list(K5_EXTRA_GEOMETRIES)))
        for shape in K5_RAGGED + ((4, 64, 19, 19),):
            for geometry in geometries:
                cases.append((dtype, shape, geometry, "ragged"))
                cases.append((dtype, shape, geometry, "specials"))
        for geometry in geometries[:4]:
            for layout in ("unaligned", "batch slice", "row slice",
                           "channel slice"):
                cases.append((dtype, (3, 64, 9, 11), geometry, layout))
    for dtype, shape, geometry, kind in cases:
        x = k5_map(shape, dtype, gen, device, specials=kind == "specials")
        if kind == "unaligned":
            x = unaligned_copy(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        elif kind == "batch slice":
            x = x[1:]
        elif kind == "row slice":
            x = x[:, :, 1:]
        elif kind == "channel slice":
            x = x[:, 8:]
        window, stride, padding, ceil_mode = geometry
        got = k5.max_pool(x, window, stride, padding, ceil_mode)
        want = k5.max_pool_plain(x, window, stride, padding, ceil_mode)
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"K5 {dtype} {tuple(x.shape)} {geometry} {kind}: "
                 f"{tuple(got.shape)} {got.dtype}, plain "
                 f"{tuple(want.shape)} {want.dtype}")
        bits = K5_DTYPES[dtype]
        differ = int((got.contiguous().view(bits)
                      != want.contiguous().view(bits)).sum())
        if differ:
            fail(f"K5 {dtype} {tuple(x.shape)} {geometry} {kind}: {differ} "
                 f"values differ from the plain version's bits")
        if not got.is_contiguous(memory_format=torch.channels_last):
            fail(f"K5 {dtype} {tuple(x.shape)}: output not channels_last")
        del x, got, want
    if on_card:
        torch.cuda.empty_cache()
    out = {"compared": len(cases), "max_abs_err": 0.0}
    if not on_card:
        return out

    # Timing at the serving batch, one pool at a time.
    rows = []
    for model, pool, chw, geometry in K5_POOLS:
        dtypes = [torch.bfloat16]
        if pool in K5_INT8_POOLS:
            dtypes.append(torch.int8)
        for dtype in dtypes:
            shape = (timing_batch,) + chw
            x = k5_map(shape, dtype, gen, device)
            window, stride, padding, ceil_mode = geometry
            bound, by = k5_bound_ms(shape, geometry, dtype)
            row = {"model": model, "pool": pool, "dtype": str(dtype),
                   "shape": list(shape), "geometry": list(geometry),
                   "ms": graph_ms(lambda: k5.max_pool(
                       x, window, stride, padding, ceil_mode)),
                   "plain_ms": graph_ms(lambda: k5.max_pool_plain(
                       x, window, stride, padding, ceil_mode)),
                   "library_ms": None if dtype == torch.int8 else graph_ms(
                       lambda: F.max_pool2d(x, window, stride, padding,
                                            ceil_mode=ceil_mode)),
                   "bound_ms": bound, "bound_by": by}
            row["share"] = bound / row["ms"]
            rows.append(row)
            del x
            torch.cuda.empty_cache()
    out["rows"] = rows

    # Host time per call at the smallest SSD300 map at batch 1, in turns.
    _, _, chw, geometry = K5_POOLS[4]
    x = k5_map((1,) + chw, torch.bfloat16, gen, device)
    window, stride, padding, ceil_mode = geometry
    pairs = (k5.pair(window), k5.pair(stride), k5.pair(padding), ceil_mode)
    calls = {"op": lambda: torch.ops.ssd.max_pool(x, *pairs),
             "launcher": lambda: k5.launch(x, *pairs),
             "layer_max_pool": lambda: k5.layer_max_pool(x, *pairs),
             "max_pool": lambda: k5.max_pool(x, window, stride, padding,
                                             ceil_mode),
             "F.max_pool2d": lambda: F.max_pool2d(x, window, stride, padding,
                                                  ceil_mode=ceil_mode)}
    host = {key: [] for key in calls}
    for _ in range(2):
        for key, fn in calls.items():
            host[key].append(host_ms_per_call(fn, K5_HOST_CALLS))
    out["host_shape"] = [1] + list(chw)
    out["host_ms"] = {key: min(v) for key, v in host.items()}
    return out


def synthetic_batch(batch: int, gen: torch.Generator,
                    size: int = 300) -> dict:
    """A dense train batch: uint8 images of ``size`` px and 1..MAX_BOXES
    boxes per image (normalized xyxy, classes 0..19), the rest padded
    rows."""
    images = torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                           dtype=torch.uint8)
    boxes = torch.zeros(batch, MAX_BOXES, 4)
    classes = torch.zeros(batch, MAX_BOXES, dtype=torch.int32)
    mask = torch.zeros(batch, MAX_BOXES, dtype=torch.bool)
    for i in range(batch):
        n = int(torch.randint(1, MAX_BOXES + 1, (), generator=gen))
        lo = torch.rand(n, 2, generator=gen) * 0.7
        wh = torch.rand(n, 2, generator=gen) * 0.3 + 0.05
        boxes[i, :n] = torch.cat([lo, (lo + wh).clamp(max=1.0)], dim=1)
        classes[i, :n] = torch.randint(0, 20, (n,), generator=gen,
                                       dtype=torch.int32)
        mask[i, :n] = True
    return {"images": images, "boxes": boxes, "classes": classes,
            "mask": mask}


def train_init_state_dict(seed: int = SEED) -> dict:
    """Random SSD300 train weights (f32, flax init) from ``seed``."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.models.ssd import build_model
    model = build_model(ModelConfig(), device="cpu", train=True,
                        generator=torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _train_run(device, model_config, init_sd, batches, priors,
               seed: int = 0, quant_ste=None, conv_noise=None, mesh=None):
    """``conv_noise``: a generator; every conv output is then moved by one
    ulp up or down at random (a model of another summation order).
    ``mesh``: train data-parallel on it (`parallel/data_parallel.py`)."""
    from objectdetection_ssd_torch.config import OptimConfig
    from objectdetection_ssd_torch.models.layers import TorchConv
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state
    state = create_train_state(model_config, OptimConfig(), device=device,
                               state_dict=init_sd, mesh=mesh)
    if conv_noise is not None:
        def ulp(module, args, out):
            sign = torch.randint(0, 2, out.shape, generator=conv_noise,
                                 device=out.device) * 2 - 1
            return out * (1 + 2.0 ** -23 * sign)
        for m in state.model.modules():
            if isinstance(m, TorchConv):
                m.register_forward_hook(ulp)
    losses = []
    for batch in batches:
        state, metrics = train_step(state, batch, priors, seed=seed,
                                    quant_ste=quant_ste)
        losses.append(float(metrics["loss"]))
    return state, losses


def phase_train_slice(device, steps: int = TRAIN_STEPS,
                      batch: int = TRAIN_BATCH) -> dict:
    """`train_step` f32 with the four conv1/conv2 convs routed through K2:
    the main path (launch counts read around it), then the same steps on
    the CPU, and one step against the cuDNN-wgrad route."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors

    gen = torch.Generator().manual_seed(SEED + 4)
    batches = [synthetic_batch(batch, gen) for _ in range(steps)]
    priors = torch.tensor(ssd300_priors())
    init_sd = train_init_state_dict()
    routed = ModelConfig(dw_pallas_convs=ROUTED)

    # The main path: counts set to 0 just before, read just after.
    dw_cuda.launches = 0
    dw_cuda.layout_copies = 0
    state, losses = _train_run(device, routed, init_sd, batches, priors)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches, copies = dw_cuda.launches, dw_cuda.layout_copies
    if not all(math.isfinite(x) for x in losses):
        fail(f"train losses not finite: {losses}")
    if device.type == "cuda" and launches != 4 * steps:
        fail(f"K2 launched {launches} times in {steps} routed steps")
    if device.type == "cuda" and copies != 0:
        fail(f"{copies} gradient layout copies in {steps} routed steps: a "
             f"routed conv's dX left channels_last")
    out = {"losses": losses, "launches": launches, "layout_copies": copies,
           "dx_rel": routed_dx_check(device, batch)}

    cpu_state, cpu_losses = _train_run(torch.device("cpu"), routed, init_sd,
                                       batches, priors)
    out["loss_rel"] = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, cpu_losses))
    if not out["loss_rel"] <= TRAIN_LOSS_RTOL:
        fail(f"card vs CPU losses {losses} vs {cpu_losses}")
    rows = change_rows(dict(state.model.named_parameters()),
                       dict(cpu_state.model.named_parameters()), init_sd)
    worst, _, worst_name = rows[0]
    out["delta_rel"], out["delta_worst"] = worst, worst_name
    out["delta_norm_rel"] = max(r[1] for r in rows)
    print("train slice: card vs CPU parameter changes, worst tensors "
          "(max-abs rel, norm rel): " + "; ".join(
              f"{n} {a:.3e} {b:.3e}" for a, b, n in rows[:4]))
    if not (worst <= TRAIN_DELTA_TOL
            and out["delta_norm_rel"] <= TRAIN_DELTA_NORM_TOL):
        fail(f"card vs CPU parameter changes differ: {worst:.3e} of the "
             f"largest ({worst_name}), {out['delta_norm_rel']:.3e} in norm")

    # One step from the same weights, routed (K2) and unrouted (cuDNN).
    grads = {}
    for key, cfg in (("k2", routed), ("cudnn", ModelConfig())):
        st, _ = _train_run(device, cfg, init_sd, batches[:1], priors)
        grads[key] = {n: st.model.trunk.get_submodule(n).weight.grad
                      for n in ROUTED}
    out["wgrad_rel"] = max(
        float((grads["k2"][n] - grads["cudnn"][n]).abs().max()
              / grads["cudnn"][n].abs().max()) for n in ROUTED)
    if not out["wgrad_rel"] <= WGRAD_TOL:
        fail(f"K2 vs cuDNN wgrad differ by {out['wgrad_rel']:.3e}")
    return out


def change_rows(card: dict, cpu: dict, init_sd: dict) -> list:
    """(max-abs rel, norm rel, name) per tensor of ``card``: its change
    from ``init_sd`` against the CPU's change, relative to the CPU's
    largest change and in norm; the worst first.  A tensor that did not
    move on the CPU must not move on the card."""
    rows = []
    for name, t in card.items():
        want = cpu[name].detach().float() - init_sd[name].float()
        got = t.detach().cpu().float() - init_sd[name].float()
        diff, scale = float((got - want).abs().max()), float(
            want.abs().max())
        norm = float((got - want).norm() / want.norm()) if scale > 0 else 0.0
        rel = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
        rows.append((rel, norm, name))
    rows.sort(key=lambda r: -r[0] if math.isfinite(r[0]) else -math.inf)
    return rows


def routed_dx_check(device, batch: int = TRAIN_BATCH) -> float:
    """dX of `Conv3x3P1` at each routed conv's shape, f32, channels_last x
    and upstream gradient: fails unless it is ``channels_last`` and within
    `DX_TOL` of max|dX| of `F.conv2d`'s autograd dX.  Returns the largest
    relative difference."""
    import torch.nn.functional as F
    from objectdetection_ssd_torch.ops import dw_cuda
    gen = torch.Generator().manual_seed(SEED + 8)
    cl = torch.channels_last
    worst = 0.0
    for conv, (n, h, w, cin, cout) in zip(ROUTED, dw_shapes(batch)):
        x = torch.randn(n, cin, h, w, generator=gen).to(
            device, memory_format=cl).requires_grad_()
        wk = (torch.randn(cout, cin, 3, 3, generator=gen) * 0.05).to(
            device).requires_grad_()
        gy = torch.randn(n, cout, h, w, generator=gen).to(
            device, memory_format=cl)
        want, = torch.autograd.grad(F.conv2d(x, wk, None, 1, 1), x, gy)
        dx, = torch.autograd.grad(dw_cuda.conv3x3p1(x, wk), x, gy)
        if not dx.is_contiguous(memory_format=cl):
            fail(f"{conv}: the routed conv's dX is not channels_last")
        rel = float((dx - want).abs().max() / want.abs().max())
        if not rel <= DX_TOL:
            fail(f"{conv}: routed dX differs from autograd's by {rel:.3e}")
        worst = max(worst, rel)
        del x, wk, gy, want, dx
    return worst


def phase_frozen_step(device, batch: int = TRAIN_BATCH) -> dict:
    """One routed step with freeze_stages=1: K2 runs for conv2_x only."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors

    gen = torch.Generator().manual_seed(SEED + 5)
    cfg = ModelConfig(dw_pallas_convs=ROUTED, freeze_stages=1)
    dw_cuda.launches = 0
    state, losses = _train_run(device, cfg, train_init_state_dict(),
                               [synthetic_batch(batch, gen)],
                               torch.tensor(ssd300_priors()))
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dw_cuda.launches
    trunk = state.model.trunk
    if any(trunk.get_submodule(n).weight.grad is not None
           for n in ("conv1_1", "conv1_2")):
        fail("a frozen conv1 weight got a gradient")
    if any(trunk.get_submodule(n).weight.grad is None
           for n in ("conv2_1", "conv2_2")):
        fail("a conv2 weight got no gradient")
    if device.type == "cuda" and launches != 2:
        fail(f"K2 launched {launches} times in the freeze_stages=1 step")
    if not math.isfinite(losses[0]):
        fail(f"frozen-step loss not finite: {losses}")
    return {"launches": launches}


def dw_bound_ms(n: int, h: int, w: int, cin: int, cout: int,
                itemsize: int) -> tuple:
    """Least time for K2's work at one shape: the larger of its tensor-core
    operations over the bf16 peak and the bytes of x and g (read once) and
    dW (f32, written once) over HBM rate.  Returns (bound_ms, bound_by,
    ops_ms, bytes_ms, flop, bytes)."""
    flop = 2 * n * h * w * 9 * cin * cout
    nbytes = n * h * w * (cin + cout) * itemsize + 9 * cin * cout * 4
    ops_ms = flop / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")
    return bound + (ops_ms, bytes_ms, flop, nbytes)


def ptxas_rows(source) -> list:
    """`cuda_build.ptxas_report` of ``source``'s build log."""
    from objectdetection_ssd_torch import cuda_build
    return cuda_build.ptxas_report(cuda_build.library_path(
        source).with_suffix(".log").read_text())


def short_name(function: str) -> str:
    """A mangled kernel name without its namespace and parameter list:
    ``dw_partial_kernelI13__nv_bfloat16Li1ELi8ELb1EE``."""
    m = re.search(r"(?:dw|nms|int8_conv)_[a-z_]*kernel(?:I\w*?EE)?",
                  function)
    return m.group(0) if m else function


def kernel_ptxas(rows: list, plan, dtype) -> dict:
    """The build log's row of the pass-1 kernel that ``plan`` launches: the
    halo kernel, or the tap-gather instantiation
    ``dw_partial_kernel<T, vec_a, vec_b, staged>`` by its mangled name."""
    if plan.kernel == "halo":
        symbol = "dw_halo_kernel"
    else:
        ctype = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
        symbol = (f"dw_partial_kernelI{ctype}Li{plan.vec_a}ELi{plan.vec_b}"
                  f"ELb{int(plan.staged)}EE")
    found = [r for r in rows if symbol in r["function"]]
    if len(found) != 1:
        fail(f"{len(found)} kernels named {symbol} in the build log")
    return found[0]


def bf16_wgrad_check(dev, batch: dict, priors, init_sd) -> dict:
    """One bf16 step from ``init_sd`` on ``batch``, routed through K2 and
    unrouted (cuDNN's wgrad): each routed conv's weight gradient, K2's
    against cuDNN's, relative to cuDNN's max|dW|; fails past
    `BF16_WGRAD_TOL`."""
    from objectdetection_ssd_torch.config import ModelConfig
    grads = {}
    for key, convs in (("k2", ROUTED), ("cudnn", ())):
        cfg = ModelConfig(compute_dtype="bfloat16", dw_pallas_convs=convs)
        st, _ = _train_run(dev, cfg, init_sd, [batch], priors)
        grads[key] = {n: st.model.trunk.get_submodule(n).weight.grad.clone()
                      for n in ROUTED}
        del st
    rel = {n: float((grads["k2"][n] - grads["cudnn"][n]).abs().max()
                    / grads["cudnn"][n].abs().max()) for n in ROUTED}
    if not max(rel.values()) <= BF16_WGRAD_TOL:
        fail(f"bf16 step: K2 vs cuDNN wgrad differ by {rel}")
    return rel


def profile_steps(states: dict, batch: dict, priors,
                  steps: int = PROFILE_STEPS) -> dict:
    """One `torch.profiler` pass over ``steps`` train steps of each state
    in turn.  Per configuration: device ms per step of each device
    operation (kernel, copy or set) by name, their sum, the device ms per
    step under each aten operator (nested operators each count their
    children's), and the host's ms per step under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from objectdetection_ssd_torch.train.loop import train_step
    out = {}
    for key, state in states.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                train_step(state, batch, priors)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = prof.key_averages()
        ops = {e.key: e.self_device_time_total / steps / 1e3
               for e in events if e.device_type != DeviceType.CPU
               and e.self_device_time_total > 0}
        aten = {e.key: e.device_time_total / steps / 1e3 for e in events
                if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::") and e.device_time_total > 0}
        out[key] = {"ops": ops, "aten": aten, "device_ms": sum(ops.values()),
                    "wall_ms": wall_s / steps * 1e3}
    return out


def print_profile(key: str, p: dict) -> None:
    """One line of `profile_steps`' numbers for configuration ``key``: the
    device and host ms per step and the 10 costliest device operations,
    then the 8 costliest aten operators (device ms, children included)."""
    top = sorted(p["ops"].items(), key=lambda kv: -kv[1])[:10]
    aten = sorted(p["aten"].items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: {key} bf16 step ({PROFILE_STEPS} steps, "
          f"torch.profiler): device ops {p['device_ms']:.3f} ms/step, "
          f"host {p['wall_ms']:.3f} ms/step under the profiler; top 10: "
          + "; ".join(f"{ms:.3f} ms {name[:90]}" for name, ms in top)
          + "; top aten: " + "; ".join(f"{ms:.3f} ms {name}"
                                       for name, ms in aten))


def phase_train_timing(batch: int = TIMING_TRAIN_BATCH) -> dict:
    """bf16 train steps at ``batch`` with the four convs routed and with
    dw_pallas_convs=(): 4 windows of 10 steps each, in turns (routed,
    plain, plain, routed, twice), the median window per configuration;
    a profile of both; one step of each from the same weights, whose
    routed weight gradients are held against cuDNN's; then K2, its plain
    version and cuDNN's wgrad at each routed conv's shape."""
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    b = {k: v.to(dev) for k, v in synthetic_batch(batch, gen).items()}
    priors = torch.tensor(ssd300_priors(), device=dev)
    init_sd = train_init_state_dict()
    states = {
        key: create_train_state(ModelConfig(compute_dtype="bfloat16",
                                            dw_pallas_convs=convs),
                                OptimConfig(), device=dev, state_dict=init_sd)
        for key, convs in (("routed", ROUTED), ("plain", ()))}
    for state in states.values():
        for _ in range(2):
            train_step(state, b, priors)
    torch.cuda.synchronize()
    n_iters, step_s = 10, {"routed": [], "plain": []}
    dw_cuda.launches = 0
    for key in ("routed", "plain", "plain", "routed") * 2:
        t0 = time.perf_counter()
        for _ in range(n_iters):
            train_step(states[key], b, priors)
        torch.cuda.synchronize()
        step_s[key].append((time.perf_counter() - t0) / n_iters)
    launches_per_step = dw_cuda.launches / (len(step_s["routed"]) * n_iters)
    prof = profile_steps(states, b, priors)
    del states
    wgrad_rel = bf16_wgrad_check(dev, b, priors, init_sd)
    k2_ptxas = ptxas_rows(dw_cuda.SOURCE)

    rows = []
    k2gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for conv, (n, h, w, cin, cout) in zip(ROUTED, dw_shapes(batch)):
        x = torch.randn(n, h, w, cin, generator=k2gen, device=dev).relu()
        x = x.to(torch.bfloat16)
        g = (torch.randn(n, h, w, cout, generator=k2gen, device=dev)
             * 1e-3).to(torch.bfloat16)
        kern = dw_cuda.dw_conv3x3p1(x, g)
        plain = dw_cuda.dw_conv3x3p1_plain(x, g)
        rel = float((kern - plain).abs().max() / plain.abs().max())
        if not rel <= DW_TOL[torch.bfloat16]:
            fail(f"K2 at {(n, h, w, cin, cout)} bf16: {rel:.3e} of max|dW|")
        del kern, plain
        ms = cuda_ms(lambda: dw_cuda.dw_conv3x3p1(x, g), iters=20)
        plain_ms = cuda_ms(lambda: dw_cuda.dw_conv3x3p1_plain(x, g),
                           iters=3, warmup=1)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            xn, (cout, cin, 3, 3), gn, padding=1), iters=20)
        bound_ms, bound_by, ops_ms, bytes_ms, flop, nbytes = dw_bound_ms(
            n, h, w, cin, cout, 2)
        plan = dw_cuda.plan(n, h, w, cin, cout, torch.bfloat16)
        rows.append({"conv": conv, "shape": [n, h, w, cin, cout],
                     "kernel": plan.kernel, "plan": plan._asdict(),
                     "ptxas": kernel_ptxas(k2_ptxas, plan, torch.bfloat16),
                     "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                     "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
                     "rel": rel})
        del x, g, xn, gn
    mid = {key: statistics.median(v) for key, v in step_s.items()}
    return {"routed_images_per_s": batch / mid["routed"],
            "routed_step_ms": mid["routed"] * 1e3,
            "plain_images_per_s": batch / mid["plain"],
            "plain_step_ms": mid["plain"] * 1e3,
            "step_ms_range": {key: [min(v) * 1e3, max(v) * 1e3]
                              for key, v in step_s.items()},
            "launches_per_step": launches_per_step, "k2": rows,
            "profile": prof, "bf16_wgrad_rel": wgrad_rel}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_bound_ms(valid: torch.Tensor) -> dict:
    """Least time for K1's work on these inputs: the larger of the bytes it
    must move (every valid flag and each valid candidate's box read once,
    every keep flag written once) over HBM rate and the f32 operations of
    the pairwise tests among valid candidates (13 per pair, 3 per box
    area) over the non-tensor f32 peak.  Beside it, the figure that
    counts every box read and all K(K-1)/2 pairs of every set."""
    k = valid.shape[-1]
    sets = valid.numel() // k
    n_v = valid.reshape(sets, k).sum(-1).double()
    out = {}
    for key, boxes, pairs in (
            ("valid", float(n_v.sum()), float((n_v * (n_v - 1) / 2).sum())),
            ("all_pairs", sets * k, sets * k * (k - 1) / 2)):
        t_bytes = (boxes * 16 + sets * k * 2) / HBM_BYTES_PER_S * 1e3
        t_ops = (pairs * 13 + boxes * 3) / F32_OPS_PER_S * 1e3
        out[key] = ((t_bytes, "bytes") if t_bytes >= t_ops
                    else (t_ops, "operations"))
    return out


def device_ms_per_call(fn, calls: int) -> tuple:
    """Device time per call of ``fn`` from `torch.profiler`: the device
    operations of ``calls`` calls, summed, over ``calls``; and their names
    with their launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in ops)
    return total_us / calls / 1e3, {e.key: e.count for e in ops}


def host_ms_per_call(fn, calls: int) -> float:
    """Host clock around ``calls`` calls of ``fn`` with no synchronize
    inside, over ``calls``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / calls * 1e3


def k1_library_launcher(source: Path):
    """``fn(boxes, valid) -> keep`` that launches ``ssd_nms_keep`` of
    another K1 source (the same C interface) on the current stream."""
    from objectdetection_ssd_torch import cuda_build
    from objectdetection_ssd_torch.infer import nms_cuda
    lib = nms_cuda.declare(cuda_build.load(source))

    def run(boxes, valid):
        keep = torch.empty(valid.shape, dtype=torch.bool,
                           device=valid.device)
        k = valid.shape[-1]
        err = lib.ssd_nms_keep(boxes.data_ptr(), valid.data_ptr(),
                               keep.data_ptr(), valid.numel() // k, k, THR,
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, err, f"ssd_nms_keep ({source.name})")
        return keep
    return run


def k1_timing(cand, valid, baselines: dict) -> dict:
    """K1 on one main-path input: bit-equal to the plain version (and each
    of the ``baselines`` launchers' keep masks too), then its device time
    per launch, host time per call and CUDA-event time, each baseline's,
    the plain version's, the valid counts per set and both bounds."""
    from objectdetection_ssd_torch.infer import nms_cuda
    kern = nms_cuda.greedy_nms_keep(cand, valid, THR)
    if not torch.equal(kern, plain_keep(cand, valid)):
        fail(f"K1 differs from the plain version at {tuple(valid.shape)}")
    runs = {"k1": lambda: nms_cuda.greedy_nms_keep(cand, valid, THR)}
    for name, launch in baselines.items():
        if not torch.equal(launch(cand, valid), kern):
            fail(f"the K1 baseline {name} differs at {tuple(valid.shape)}")
        runs[name] = lambda launch=launch: launch(cand, valid)
    n_v = valid.reshape(-1, valid.shape[-1]).sum(-1).float()
    bounds = nms_bound_ms(valid)
    row = {"shape": [*valid.shape], "valid_mean": float(n_v.mean()),
           "valid_max": int(n_v.max()),
           "suppressed": int((valid & ~kern).sum()),
           "bound_ms": bounds["valid"][0], "bound_by": bounds["valid"][1],
           "all_pairs_bound_ms": bounds["all_pairs"][0],
           "all_pairs_bound_by": bounds["all_pairs"][1],
           "runs": list(runs)}
    for key, fn in runs.items():
        dev_ms, names = device_ms_per_call(fn, K1_CALLS)
        if not any("nms" in n for n in names):
            fail(f"{key}: no NMS kernel in the profile ({names})")
        row[key] = {"device_ms": dev_ms, "kernels": names,
                    "host_ms": host_ms_per_call(fn, K1_CALLS),
                    "event_ms": cuda_ms(fn, iters=K1_CALLS)}
    row["plain_ms"] = cuda_ms(lambda: plain_keep(cand, valid), iters=3,
                              warmup=1)
    return row


def conv_flops_per_image(model, image) -> int:
    """2 * MACs of every conv in one forward of ``image`` (1, S, S, 3)."""
    total = 0

    def hook(mod, inp, out):
        nonlocal total
        kh, kw = mod.kernel_size
        total += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(image)
    finally:
        for h in handles:
            h.remove()
    return total


def chained_step_s(det, x: torch.Tensor) -> float:
    """Seconds per ``det.detect_batch`` step on ``x``: the best of 3
    windows of 10 steps after 3 warm-up steps.  Each step's input
    depends on the last step's detections (``x + 0 * sum(scores)``), so
    steps cannot overlap or be skipped (bench.py:100-118)."""

    def step(x):
        dets = det.detect_batch(x)
        return x + (dets.scores.sum() * 0).to(x.dtype)

    for _ in range(3):
        x = step(x)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            x = step(x)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    return best


def phase_timing(state_dict, k1_baselines=None) -> dict:
    """bf16, channels_last, batch 256: end to end with bench.py's chained
    dependency, forward alone, postprocess alone, and K1 alone on the
    candidates of the serving path (K = 64) and of the exact evaluation
    path (K = 200, `eval/evaluate.py:exact_eval_postprocess`'s settings),
    beside each of the ``k1_baselines`` launchers (by name)."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer import postprocess as pp
    from objectdetection_ssd_torch.infer.detector import Detector

    cfg = Config(model=ModelConfig(compute_dtype="bfloat16"))
    det = Detector(cfg, state_dict, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(TIMING_BATCH, 300, 300, 3, generator=gen,
                    device="cuda").to(torch.bfloat16)

    best = chained_step_s(det, x)
    exact = dataclasses.replace(det.pp_config, use_approx_top_k=False,
                                anchor_prefilter=0, per_class_top_k=200)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: det.forward(x), iters=10)
        loc, conf = det.forward(x)
        pp_ms = cuda_ms(lambda: pp.postprocess(loc, conf, det.priors,
                                               det.pp_config), iters=20)
        k1 = []
        for pp_config in (det.pp_config, exact):
            cand, _, valid = pp.select_candidates(loc, conf, det.priors,
                                                  pp_config)
            k1.append(k1_timing(cand, valid, k1_baselines or {}))
            del cand, valid
    flops = conv_flops_per_image(det.model, x[:1]) * TIMING_BATCH
    return {"images_per_s": TIMING_BATCH / best, "step_ms": best * 1e3,
            "forward_ms": fwd_ms, "postprocess_ms": pp_ms,
            "forward_tflops": flops / (fwd_ms * 1e-3) / 1e12,
            "gflop_per_image": flops / TIMING_BATCH / 1e9, "k1": k1}


def host_cpus() -> str:
    """What the host gives this process: os.cpu_count(), the CPUs it may
    run on, and the cgroup's CPU quota where one is readable."""
    import os
    quota = "none readable"
    for path in ("/sys/fs/cgroup/cpu.max",
                 "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"):
        try:
            with open(path) as f:
                quota = f"{path} = {f.read().strip()}"
            break
        except OSError:
            continue
    return (f"os.cpu_count() {os.cpu_count()}, affinity "
            f"{len(os.sched_getaffinity(0))}, cgroup quota {quota}")


def write_fixture(root: str, cache_prefix: str, num_2007: int,
                  num_2012: int, image_size=(500, 375), max_objects: int = 8,
                  num_classes: int = 20, seed: int = SEED,
                  difficult_fraction: float = 0.1, split: bool = True
                  ) -> tuple:
    """A synthetic VOCdevkit (XML and ImageSets as `generate_voc` writes
    them, up to ``max_objects`` objects of the first ``num_classes``
    classes, class-colour coded) whose pixels go straight into packed
    caches instead of JPEG files: ``cache_prefix`` over the train split's
    paths in order and ``cache_prefix.val`` over the val split's, the split
    the CLI takes.  No PIL, no decode.  Returns (train records, val
    records).  ``split=False``: one cache at ``cache_prefix`` over every
    record in `voc.load_records` order, returned as (records, [])."""
    from objectdetection_ssd_torch.config import DataConfig
    from objectdetection_ssd_torch.data import cache, synthetic, voc
    pixels = {}
    synthetic.generate_voc(root, num_2007=num_2007, num_2012=num_2012,
                           image_size=image_size, max_objects=max_objects,
                           seed=seed, difficult_fraction=difficult_fraction,
                           num_classes=num_classes, class_color_coding=True,
                           image_sink=pixels.__setitem__)
    records = voc.load_records(root, train=True)
    if split:
        data = DataConfig()
        train_ids, val_ids = voc.train_val_split(
            len(records), data.val_fraction, data.split_seed)
        splits = ([records[i] for i in train_ids],
                  [records[i] for i in val_ids])
        prefixes = (cache_prefix, cache_prefix + ".val")
    else:
        splits, prefixes = (records, []), (cache_prefix,)
    for recs, prefix in zip(splits, prefixes):
        paths = [r.image_path for r in recs]
        cache.write(paths, prefix, lambda paths=paths: (pixels[p]
                                                        for p in paths))
        if not cache.is_current(paths, prefix):
            fail(f"the fixture cache {prefix} is not current")
    return splits


@contextlib.contextmanager
def watch_copy_stage(trainer):
    """While open, keep every host batch that enters ``trainer``'s copy
    stage and a clone of what each `train_step` or `eval_step` reads,
    taken on the step's stream as its first work (after the copy's event
    wait, before the step).  On close, every batch the steps read must be
    bit-equal to the host arrays it was copied from, and every copy must
    have run on the side stream: a step that read a batch still being
    copied fails.  Yields a dict that gets the number of steps checked."""
    from objectdetection_ssd_torch.train import loop as loop_lib
    host, read, checked = [], [], {}
    to_device = trainer._to_device
    steps = {name: getattr(loop_lib, name)
             for name in ("train_step", "eval_step")}

    def tapped(host_iter, batch_size, side):
        if side is None:
            fail("device_prefetch ran without its copy stream")

        def tap():
            for batch in host_iter:
                host.append(batch)
                yield batch
        return to_device(tap(), batch_size, side)

    def reading(step):
        def reading_step(state, batch, *args, **kwargs):
            read.append({k: t.clone() for k, t in batch.items()})
            return step(state, batch, *args, **kwargs)
        return reading_step

    trainer._to_device = tapped
    for name, step in steps.items():
        setattr(loop_lib, name, reading(step))
    try:
        yield checked
    finally:
        del trainer._to_device
        for name, step in steps.items():
            setattr(loop_lib, name, step)
    if not read or len(read) != len(host):
        fail(f"copy stage: {len(read)} steps for {len(host)} host batches")
    for i, (want, got) in enumerate(zip(host, read)):
        n = len(want["images"])
        for key, t in got.items():
            if not torch.equal(t[:n].cpu(), torch.from_numpy(want[key])):
                fail(f"copy stage: step {i} read {key} that differs from "
                     f"its host batch")
    checked["steps"] = len(read)


def phase_trainer_slice(device, num_2007: int = 448, num_2012: int = 192,
                        batch: int = TIMING_TRAIN_BATCH,
                        workers: int = 0) -> dict:
    """The training entry point: a synthetic VOC fixture in packed caches,
    the Loader timed alone, `Trainer.fit` (bf16, default OptimConfig) for
    two epochs with device_prefetch (every batch a train step read held
    against its host arrays) and one without, resume in a fresh Trainer,
    `cli eval` in-process, `Detector.from_checkpoint` on cached val images;
    the native library must serve every image (no fall-through, here or in
    the Loader's workers)."""
    import io
    import logging.handlers
    import os
    import tempfile

    import numpy as np

    from objectdetection_ssd_torch import cli, native
    from objectdetection_ssd_torch.config import (Config, DataConfig,
                                                  ModelConfig, TrainConfig)
    from objectdetection_ssd_torch.data import cache
    from objectdetection_ssd_torch.data.pipeline import (Loader,
                                                         preprocess_image,
                                                         quantize_uint8)
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.train.trainer import Trainer
    from objectdetection_ssd_torch.utils.metrics import logger, setup_logging

    cuda = device.type == "cuda"
    if not native.available():
        fail("the native data library did not build")
    native.fallbacks = 0
    workers = workers or min(8, os.cpu_count() or 1)
    out = {"cpu_count": os.cpu_count(), "workers": workers}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        prefix = os.path.join(tmp, "cache")
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        train_recs, val_recs = write_fixture(root, prefix, num_2007,
                                             num_2012)
        out["fixture_s"] = time.perf_counter() - t0
        out["train_images"], out["val_images"] = (len(train_recs),
                                                  len(val_recs))
        cfg = Config(
            model=ModelConfig(compute_dtype="bfloat16"),
            data=DataConfig(voc_root=root, batch_size=batch,
                            num_workers=workers, image_cache=prefix),
            train=TrainConfig(checkpoint_dir=ckpt, device_prefetch=True,
                              log_every_steps=0, seed=SEED))
        train_loader = Loader(train_recs, cfg.data, 300, train=True,
                              seed=cfg.train.seed, cache_path=prefix)
        eval_loader = Loader(val_recs, cfg.data, 300, train=False,
                             drop_last=False, cache_path=prefix + ".val")
        try:
            out["cpus"] = host_cpus()
            # The Loader alone, host only: epoch 0 starts the workers.
            loader_s = []
            for epoch in range(2):
                busy = train_loader.worker_seconds
                t0 = time.perf_counter()
                n = sum(len(b["images"]) for b in train_loader.epoch(epoch))
                loader_s.append(time.perf_counter() - t0)
            out["loader_images_per_s"] = n / loader_s[1]
            out["loader_cold_images_per_s"] = n / loader_s[0]
            out["loader_worker_ms"] = (train_loader.worker_seconds
                                       - busy) / n * 1e3

            trainer = Trainer(cfg, train_loader, eval_loader, device=device)
            save_ms = []
            save = trainer.ckpt.save

            def timed_save(*args, **kwargs):
                t = time.perf_counter()
                save(*args, **kwargs)
                save_ms.append((time.perf_counter() - t) * 1e3)

            trainer.ckpt.save = timed_save
            stats = {}
            watch = (watch_copy_stage(trainer) if cuda
                     else contextlib.nullcontext({}))
            with watch as copied:
                trainer.fit(2)
            out["copy_stage_steps"] = copied.get("steps", 0)
            stats["prefetch"] = dict(trainer.phase_stats["train"])
            out["val_loss"] = trainer.history["test"][-1]
            if not all(math.isfinite(x) for v in trainer.history.values()
                       for x in v):
                fail(f"trainer history not finite: {trainer.history}")

            # Resume: a fresh Trainer picks up epoch 1's checkpoint.
            fresh = Trainer(cfg, train_loader, eval_loader, device=device)
            if not fresh.maybe_resume() or fresh.start_epoch != 2:
                fail(f"resume gave start_epoch {fresh.start_epoch}")
            if fresh.history != trainer.history:
                fail("resumed history differs")
            want = trainer.state.model.state_dict()
            for name, t in fresh.state.model.state_dict().items():
                if not torch.equal(t, want[name]):
                    fail(f"resumed parameter {name} differs")
            del fresh

            # One more epoch without the copy stage.
            trainer.config = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, device_prefetch=False))
            trainer.start_epoch = 2
            trainer.fit(3)
            stats["no_prefetch"] = dict(trainer.phase_stats["train"])
            for s in stats.values():
                s["images_per_s"] = s["images"] / s["seconds"]
                s["input_wait_ms_per_step"] = (s["input_wait_s"] / s["steps"]
                                               * 1e3)
            out["train"] = stats
            out["save_ms"] = save_ms
            del trainer
        finally:
            train_loader.close()
            eval_loader.close()

        # Eval through the CLI: the val split from its cache.
        argv = ["eval", "--voc-root", root, "--checkpoint-dir", ckpt,
                "--image-cache", prefix, "--batch-size", str(batch)]
        if not cuda:
            argv += ["--device", "cpu"]
        text = io.StringIO()
        # evaluate_records logs its images, batches and seconds (prep,
        # device and host pulls; the mAP arithmetic excluded).
        setup_logging()
        log = logging.handlers.BufferingHandler(capacity=1 << 16)
        logger.addHandler(log)
        nms_cuda.launches = 0
        try:
            with contextlib.redirect_stdout(text):
                rc = cli.main(argv)
        finally:
            logger.removeHandler(log)
        if cuda:
            torch.cuda.synchronize()
        launches = nms_cuda.launches
        m = re.search(r"mAP = ([-+0-9.eEnaif]+)", text.getvalue())
        if rc != 0 or m is None or not math.isfinite(float(m.group(1))):
            fail(f"cli eval rc {rc}: {text.getvalue()[-300:]}")
        runs = [re.fullmatch(r"eval: (\d+) images in (\d+) batches, "
                             r"([0-9.]+) s", r.getMessage())
                for r in log.buffer]
        runs = [r for r in runs if r]
        if len(runs) != 1:
            fail(f"cli eval logged {len(runs)} evaluation runs")
        images, batches = int(runs[0].group(1)), int(runs[0].group(2))
        if cuda and launches < batches:
            fail(f"K1 launched {launches} times in {batches} eval batches")
        out["eval"] = {"map": float(m.group(1)), "launches": launches,
                       "batches": batches, "images": images,
                       "images_per_s": images / float(runs[0].group(3))}

        # Detect from the checkpoint on cached val images.
        det = Detector.from_checkpoint(cfg, device=device)
        imgs = np.stack([quantize_uint8(preprocess_image(
            cache.get_image(prefix + ".val", i % len(val_recs)), 300,
            normalize=False)) for i in range(8)])
        nms_cuda.launches = 0
        dets = det.detect_batch(imgs)
        if cuda:
            torch.cuda.synchronize()
        out["detect_launches"] = nms_cuda.launches
        if (dets.boxes_xyxy.shape != (8, 200, 4)
                or not torch.isfinite(dets.boxes_xyxy).all()
                or not torch.isfinite(dets.scores).all()):
            fail("detect_batch from the checkpoint gave malformed output")
        if cuda and out["detect_launches"] < 1:
            fail("K1 was not launched by detect_batch")
        try:
            Detector.from_checkpoint(cfg, os.path.join(tmp, "empty"),
                                     device=device)
            fail("from_checkpoint on an empty directory did not raise")
        except FileNotFoundError:
            pass
    if native.fallbacks:
        fail(f"{native.fallbacks} fall-throughs from the native library "
             f"to numpy / PIL")
    return out


def resnet_config(**kw):
    from objectdetection_ssd_torch.config import ModelConfig
    return ModelConfig(backbone="resnet34", image_size=RESNET_SIZE, **kw)


def seeded_resnet_state_dict(seed: int = SEED) -> dict:
    """Random SSD-ResNet34 weights (flax init) from ``seed``, with every
    BN's scale, bias and running statistics drawn away from their init
    (scale U(0.5, 1.5), bias N(0, 0.2), mean N(0, 0.2), var U(0.5, 2)) and
    the conf biases ~ N(0, 3), so that NMS has work."""
    from objectdetection_ssd_torch.models.layers import BatchNorm
    from objectdetection_ssd_torch.models.ssd import build_model
    gen = torch.Generator().manual_seed(seed)
    model = build_model(resnet_config(), device="cpu", generator=gen,
                        train=True)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
        for tap in ("t4", "t2", "t1"):
            bias = model.get_submodule(f"conf_{tap}").bias
            bias.copy_(torch.randn(bias.shape, generator=gen) * 3.0)
    return {k: v.clone() for k, v in model.state_dict().items()}


def phase_resnet_slice(device, state_dict, batches=SERVE_BATCHES) -> dict:
    """ResNet-34 serving.  The main path: `detect_batch` in bf16 at
    ``batches`` (K1 counted around it), each held against the plain-NMS
    path on the same loc/conf.  Then f32: the card's loc/conf against the
    CPU's, and Soft-NMS (both methods) and flip TTA on the card against
    the CPU on the same inputs."""
    from objectdetection_ssd_torch.config import Config
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer import postprocess as pp
    from objectdetection_ssd_torch.infer.detector import (
        Detector, forward_for_postprocess)

    det = Detector(Config(model=resnet_config(compute_dtype="bfloat16")),
                   state_dict, device=device)
    gen = torch.Generator().manual_seed(SEED + 11)
    images = {b: torch.randint(0, 256, (b, RESNET_SIZE, RESNET_SIZE, 3),
                               generator=gen, dtype=torch.uint8).to(device)
              for b in batches}

    launches, n_valid, n_suppressed, _, k4, k5 = serve_requests(
        det, images, "ResNet-34")
    if device.type == "cuda" and launches != len(batches):
        fail(f"K1 launched {launches} times for {len(batches)} ResNet-34 "
             f"requests")
    if device.type == "cuda" and k4 != K4_PER_FORWARD["resnet34"] * len(
            batches):
        fail(f"K4 launched {k4} times for {len(batches)} ResNet-34 "
             f"requests")
    if device.type == "cuda" and k5 != K5_PER_FORWARD["resnet34"] * len(
            batches):
        fail(f"K5 launched {k5} times for {len(batches)} ResNet-34 "
             f"requests")

    # f32: the card's loc/conf against the CPU's.
    cfg32 = Config(model=resnet_config())
    det32 = Detector(cfg32, state_dict, device=device)
    cpu32 = Detector(cfg32, state_dict, device="cpu")
    x = images[max(batches)][:CPU_CHECK_BATCH]
    rel = rel_diff(det32.forward(x), cpu32.forward(x.cpu()))
    # Conv algorithms sum in another order on the card; 1e-3 of each
    # output's largest magnitude, as for SSD300.
    if not rel <= 1e-3:
        fail(f"ResNet-34 card vs CPU loc/conf differ by {rel:.3e}")

    # Soft-NMS and TTA: the merged loc/conf card vs CPU, then the
    # postprocess on the card against the CPU's on the card's numbers.
    out = {"launches": launches, "valid": n_valid,
           "suppressed": n_suppressed, "card_vs_cpu_rel": rel, "opt_in": {},
           "k4": k4, "k5": k5}
    for name, kw in (("soft_gaussian", {"nms_method": "soft_gaussian"}),
                     ("soft_linear", {"nms_method": "soft_linear"}),
                     ("tta_flip", {"tta_flip": True}),
                     ("tta_flip+soft_gaussian", {"tta_flip": True,
                                                 "nms_method":
                                                 "soft_gaussian"})):
        cfg = dataclasses.replace(cfg32.postprocess, **kw)
        card = Detector(cfg32, state_dict, postprocess_config=cfg,
                        device=device)
        cpu = Detector(cfg32, state_dict, postprocess_config=cfg,
                       device="cpu")
        with torch.inference_mode():
            merged = forward_for_postprocess(card.model, x, card.priors, cfg,
                                             card.mirror_perm)
            cpu_merged = forward_for_postprocess(cpu.model, x.cpu(),
                                                 cpu.priors, cfg,
                                                 cpu.mirror_perm)
        merged_rel = rel_diff(merged[:2], cpu_merged[:2])
        if not merged_rel <= 1e-3:
            fail(f"{name}: card vs CPU merged loc/conf differ by "
                 f"{merged_rel:.3e}")
        nms_cuda.launches = 0
        got = pp.postprocess(*merged, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize()
        k1 = nms_cuda.launches
        want = pp.postprocess(*(t.cpu() for t in merged), cfg)
        if not same_detections(pp.Detections(*(t.cpu() for t in got)), want,
                               atol=SOFT_NMS_ATOL):
            fail(f"{name}: card detections differ from the CPU's")
        if int(got.valid.sum()) == 0:
            fail(f"{name}: no detections, the check is vacuous")
        if cfg.nms_method != "hard" and k1:
            fail(f"{name}: Soft-NMS launched K1")
        if cfg.tta_flip and card.mirror_perm is None:
            fail(f"{name}: the ResNet-34 priors found no mirror pairing")
        out["opt_in"][name] = {"valid": int(got.valid.sum()),
                               "merged_rel": merged_rel, "k1": k1}
    return out


def phase_resnet_train(device, steps: int = TRAIN_STEPS,
                       batch: int = RESNET_TRAIN_BATCH) -> dict:
    """ResNet-34 `train_step` in f32 (frozen trunk).  Dropout 0: the card
    against the CPU, losses and the change of every parameter and running
    statistic; the trunk bit-unchanged.  Dropout 0.4: finite losses, the
    same first loss from the same seed, another from another seed, and a
    mask that repeats from (seed, step) and changes with the step."""
    from objectdetection_ssd_torch.ops.priors import resnet34_priors
    from objectdetection_ssd_torch.train.loop import dropout_generator

    gen = torch.Generator().manual_seed(SEED + 12)
    batches = [synthetic_batch(batch, gen, RESNET_SIZE)
               for _ in range(steps)]
    priors = torch.tensor(resnet34_priors())
    init_sd = seeded_resnet_state_dict()
    no_drop = resnet_config(dropout_rate=0.0)

    state, losses = _train_run(device, no_drop, init_sd, batches, priors)
    if not all(math.isfinite(x) for x in losses):
        fail(f"ResNet-34 train losses not finite: {losses}")
    card_sd = state.model.state_dict()
    for name, t in card_sd.items():
        if name.startswith("trunk.") and not torch.equal(t.cpu(),
                                                         init_sd[name]):
            fail(f"the frozen trunk's {name} changed")
    out = {"losses": losses}
    cpu_state, cpu_losses = _train_run(torch.device("cpu"), no_drop,
                                       init_sd, batches, priors)
    out["loss_rel"] = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, cpu_losses))
    if not out["loss_rel"] <= TRAIN_LOSS_RTOL:
        fail(f"ResNet-34 card vs CPU losses {losses} vs {cpu_losses}")
    cpu_sd = cpu_state.model.state_dict()
    # A loc head's conv bias feeds a train-mode BN, which removes it: its
    # gradient is 0 up to rounding on both sides, so its change is noise
    # against noise and is left out.
    moving = {n: t for n, t in card_sd.items()
              if not n.startswith("trunk.")
              and not re.fullmatch(r"loc_t\d\.conv\.bias", n)}
    rows = change_rows(moving, cpu_sd, init_sd)
    worst, _, worst_name = rows[0]
    out["delta_rel"], out["delta_worst"] = worst, worst_name
    out["delta_norm_rel"] = max(r[1] for r in rows)
    out["stats_rel"] = max(r[0] for r in rows if "running" in r[2])
    print("resnet34 train: card vs CPU changes of parameters and running "
          "statistics, worst tensors (max-abs rel, norm rel): "
          + "; ".join(f"{n} {a:.3e} {b:.3e}" for a, b, n in rows[:4]))
    if not (worst <= TRAIN_DELTA_TOL
            and out["delta_norm_rel"] <= TRAIN_DELTA_NORM_TOL):
        fail(f"ResNet-34 card vs CPU changes differ: {worst:.3e} of the "
             f"largest ({worst_name}), {out['delta_norm_rel']:.3e} in norm")

    runs = {}
    for key, seed in (("a", SEED), ("b", SEED), ("c", SEED + 1)):
        state, runs[key] = _train_run(device, resnet_config(), init_sd,
                                      batches, priors, seed=seed)
    if not all(math.isfinite(x) for v in runs.values() for x in v):
        fail(f"ResNet-34 dropout losses not finite: {runs}")
    if not (abs(runs["a"][0] - runs["b"][0]) <= 1e-6 * abs(runs["b"][0])
            and abs(runs["a"][0] - runs["c"][0]) > 1e-4 * abs(runs["c"][0])):
        fail(f"ResNet-34 dropout losses do not follow the seed: {runs}")
    state.step = 7
    drop = state.model.neck_down.drop
    drop.train()
    ones = torch.ones(2, 256, 4, 4, device=next(
        state.model.parameters()).device)
    masks = [drop(ones, dropout_generator(state, SEED)) != 0
             for _ in range(2)]
    state.step = 8
    masks.append(drop(ones, dropout_generator(state, SEED)) != 0)
    if not (torch.equal(masks[0], masks[1])
            and not torch.equal(masks[0], masks[2])):
        fail("ResNet-34 dropout masks do not follow (seed, step)")
    out["dropout_losses"] = runs
    return out


def phase_resnet_trainer(device, num_2007: int = 448, num_2012: int = 192,
                         batch: int = TIMING_TRAIN_BATCH,
                         workers: int = 0) -> dict:
    """The ResNet-34 family through the CLI on the trainer slice's
    `write_fixture` VOCdevkit (packed caches, 224 px): `cli train
    --backbone resnet34 --bf16` for two epochs, resume into a fresh
    Trainer (bit-equal), `cli train --resume` for a third epoch (the frozen
    trunk bit-unchanged), `cli eval` (exact postprocess, K1 at K = 189 per
    batch) and `cli detect` hard and with `--tta-flip --nms-method
    soft_gaussian`.  Each `cli train` run's last train phase gives its
    images/s and input wait (`Trainer.phase_stats`): epoch 1 with the
    Loader's workers warm, and the resumed epoch 2 with workers starting.
    The card's machine has no PIL, so `cli detect` reads its images'
    pixels from the val cache."""
    import io
    import os
    import tempfile

    from objectdetection_ssd_torch import cli, native
    from objectdetection_ssd_torch.config import (Config, DataConfig,
                                                  TrainConfig)
    from objectdetection_ssd_torch.data import cache
    from objectdetection_ssd_torch.data import pipeline as data_pipeline
    from objectdetection_ssd_torch.data.pipeline import Loader
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
    from objectdetection_ssd_torch.train.trainer import Trainer

    cuda = device.type == "cuda"
    native.fallbacks = 0
    workers = workers or min(8, os.cpu_count() or 1)
    out = {"workers": workers}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_r34_") as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        prefix = os.path.join(tmp, "cache")
        ckpt = os.path.join(tmp, "ckpt")
        train_recs, val_recs = write_fixture(root, prefix, num_2007,
                                             num_2012)
        out["train_images"], out["val_images"] = (len(train_recs),
                                                  len(val_recs))
        common = ["--voc-root", root, "--checkpoint-dir", ckpt,
                  "--backbone", "resnet34"] + ([] if cuda
                                               else ["--device", "cpu"])
        train_argv = ["train", "--bf16", "--image-cache", prefix,
                      "--batch-size", str(batch), "--num-workers",
                      str(workers)] + common

        def run(argv) -> str:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main(argv)
            if rc != 0:
                fail(f"cli {argv[0]} rc {rc}: {text.getvalue()[-300:]}")
            return text.getvalue()

        # The train phase of each `cli train` run's last epoch.
        phases = []
        fit = Trainer.fit

        def recording_fit(self, *args, **kwargs):
            state = fit(self, *args, **kwargs)
            s = dict(self.phase_stats["train"])
            s["images_per_s"] = s["images"] / s["seconds"]
            s["input_wait_ms_per_step"] = s["input_wait_s"] / s["steps"] * 1e3
            phases.append(s)
            return state

        Trainer.fit = recording_fit
        try:
            t0 = time.perf_counter()
            run(train_argv + ["--epochs", "2"])
            out["train_s"] = time.perf_counter() - t0
        finally:
            Trainer.fit = fit
        mgr = CheckpointManager(ckpt)
        saved1, _, _ = mgr.load(1)

        # Resume into a fresh Trainer, as `--resume` builds it.
        cfg = Config(model=resnet_config(compute_dtype="bfloat16"),
                     data=DataConfig(voc_root=root, batch_size=batch,
                                     num_workers=0, image_cache=prefix),
                     train=TrainConfig(checkpoint_dir=ckpt))
        loader = Loader(train_recs, cfg.data, RESNET_SIZE, train=True,
                        seed=cfg.train.seed, cache_path=prefix)
        try:
            fresh = Trainer(cfg, loader, device=device)
            if not fresh.maybe_resume() or fresh.start_epoch != 2:
                fail(f"ResNet-34 resume gave start_epoch {fresh.start_epoch}")
            for name, t in fresh.state.model.state_dict().items():
                if not torch.equal(t.cpu(), saved1["model"][name]):
                    fail(f"resumed ResNet-34 entry {name} differs")
            del fresh
        finally:
            loader.close()

        Trainer.fit = recording_fit
        try:
            t0 = time.perf_counter()
            run(train_argv + ["--epochs", "3", "--resume"])
            out["resume_s"] = time.perf_counter() - t0
        finally:
            Trainer.fit = fit
        if len(phases) != 2:
            fail(f"{len(phases)} Trainer.fit calls in two cli train runs")
        out["warm"], out["resumed"] = phases
        saved2, meta, _ = mgr.load(2)
        moved = {name for name, t in saved2["model"].items()
                 if not torch.equal(t, saved1["model"][name])}
        if any(n.startswith("trunk.") for n in moved) or not moved:
            fail(f"epoch 2 moved {sorted(moved)[:4]}...: the frozen trunk "
                 f"must stay, the rest must train")
        out["train_loss"] = meta["history"]["train"]

        nms_cuda.launches = 0
        text = run(["eval", "--image-cache", prefix, "--batch-size",
                    str(batch)] + common)
        if cuda:
            torch.cuda.synchronize()
        m = re.search(r"mAP = ([-+0-9.eEnaif]+)", text)
        batches = -(-len(val_recs) // batch)
        if m is None or not math.isfinite(float(m.group(1))):
            fail(f"ResNet-34 cli eval: {text[-300:]}")
        if cuda and nms_cuda.launches != batches:
            fail(f"K1 launched {nms_cuda.launches} times in {batches} "
                 f"ResNet-34 eval batches")
        out["eval"] = {"map": float(m.group(1)), "batches": batches,
                       "launches": nms_cuda.launches}

        paths = [r.image_path for r in val_recs[:8]]
        index = {p: i for i, p in enumerate(r.image_path for r in val_recs)}
        load_image = data_pipeline.load_image
        data_pipeline.load_image = lambda p: cache.get_image(
            prefix + ".val", index[p])
        try:
            out["detect"] = {}
            for key, extra in (("hard", []),
                               ("tta_flip+soft_gaussian",
                                ["--tta-flip", "--nms-method",
                                 "soft_gaussian"])):
                nms_cuda.launches = 0
                text = run(["detect", *paths] + extra + common)
                if cuda:
                    torch.cuda.synchronize()
                lines = text.splitlines()
                if [ln for ln in lines if not ln.startswith(" ")] != paths:
                    fail(f"ResNet-34 cli detect {key}: {text[-300:]}")
                want = 0 if extra else 1
                if cuda and nms_cuda.launches != want:
                    fail(f"cli detect {key}: K1 launched "
                         f"{nms_cuda.launches} times")
                out["detect"][key] = {"lines": len(lines) - len(paths),
                                      "launches": nms_cuda.launches}
        finally:
            data_pipeline.load_image = load_image
    if native.fallbacks:
        fail(f"{native.fallbacks} fall-throughs from the native library")
    return out


def phase_remat_step(device, batch: int = TIMING_TRAIN_BATCH) -> dict:
    """One bf16 SSD300 step with the conv1/conv2 convs routed through K2,
    without and with remat, from the same weights and batch, cuDNN set
    deterministic: the loss and every gradient equal to 1e-6 of its
    largest (the recomputed forward is the same computation), K2 launched
    4 times in each, and on the card the peak memory of each step above
    the state's, which remat must lower."""
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    cuda = device.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 13)
    b = {k: v.to(device) for k, v in synthetic_batch(batch, gen).items()}
    priors = torch.tensor(ssd300_priors(), device=device)
    init_sd = train_init_state_dict()
    cfg = ModelConfig(compute_dtype="bfloat16", dw_pallas_convs=ROUTED)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for remat in (False, True):
            state = create_train_state(cfg, OptimConfig(), device=device,
                                       state_dict=init_sd)
            train_step(state, b, priors, remat=remat)      # warm-up
            state.model.load_state_dict(init_sd)
            state.optimizer.zero_grad(set_to_none=True)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            dw_cuda.launches = 0
            t0 = time.perf_counter()
            _, metrics = train_step(state, b, priors, remat=remat)
            if cuda:
                torch.cuda.synchronize()
            row = {"loss": float(metrics["loss"]),
                   "step_ms": (time.perf_counter() - t0) * 1e3,
                   "launches": dw_cuda.launches,
                   "peak_mb": ((torch.cuda.max_memory_allocated() - base)
                               / 2**20 if cuda else None),
                   "grads": {n: p.grad.float().cpu() for n, p in
                             state.model.named_parameters()}}
            runs[remat] = row
            del state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, remat = runs[False], runs[True]
    rel = max(float((remat["grads"][n] - g).abs().max() / g.abs().max())
              for n, g in plain["grads"].items() if g.abs().max() > 0)
    loss_rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    if not (rel <= 1e-6 and loss_rel <= 1e-6):
        fail(f"remat step differs from the plain step: loss {loss_rel:.3e}, "
             f"gradients {rel:.3e}")
    if cuda and (plain["launches"], remat["launches"]) != (4, 4):
        fail(f"K2 launched {plain['launches']} / {remat['launches']} times "
             f"in the plain / remat steps")
    if cuda and not remat["peak_mb"] < plain["peak_mb"]:
        fail(f"remat did not lower the step's peak memory "
             f"({remat['peak_mb']:.1f} vs {plain['peak_mb']:.1f} MiB)")
    return {"grad_rel": rel, "loss_rel": loss_rel,
            "launches": plain["launches"] + remat["launches"],
            **{f"{key}_{k}": row[k] for key, row in (("plain", plain),
                                                     ("remat", remat))
               for k in ("peak_mb", "step_ms", "loss")}}


def phase_resnet_timing(state_dict) -> dict:
    """ResNet-34 serving, bf16, batch 256: end to end with the chained
    dependency of `phase_timing`, the forward, the postprocess (hard,
    Soft-NMS gaussian and linear), `detect_batch` with and without flip
    TTA, and K1 on the candidates of the serving path (K = 64) and of the
    exact-eval path (K = 189)."""
    from objectdetection_ssd_torch.config import Config
    from objectdetection_ssd_torch.infer import postprocess as pp
    from objectdetection_ssd_torch.infer.detector import Detector

    cfg = Config(model=resnet_config(compute_dtype="bfloat16"))
    det = Detector(cfg, state_dict, device="cuda")
    tta = Detector(cfg, state_dict, postprocess_config=dataclasses.replace(
        cfg.postprocess, tta_flip=True), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randint(0, 256, (TIMING_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                      generator=gen, device="cuda", dtype=torch.uint8)

    best = chained_step_s(det, x)
    exact = dataclasses.replace(det.pp_config, use_approx_top_k=False,
                                anchor_prefilter=0, per_class_top_k=200)
    out = {"images_per_s": TIMING_BATCH / best, "step_ms": best * 1e3}
    with torch.inference_mode():
        out["forward_ms"] = cuda_ms(lambda: det.forward(x), iters=10)
        loc, conf = det.forward(x)
        for method in ("hard", "soft_gaussian", "soft_linear"):
            c = dataclasses.replace(det.pp_config, nms_method=method)
            out[f"postprocess_{method}_ms"] = cuda_ms(
                lambda c=c: pp.postprocess(loc, conf, det.priors, c),
                iters=5 if method != "hard" else 20, warmup=1)
        out["detect_ms"] = cuda_ms(lambda: det.detect_batch(x), iters=5)
        out["detect_tta_ms"] = cuda_ms(lambda: tta.detect_batch(x), iters=5)
        k1 = []
        for pp_config in (det.pp_config, exact):
            cand, _, valid = pp.select_candidates(loc, conf, det.priors,
                                                  pp_config)
            k1.append(k1_timing(cand, valid, {}))
            del cand, valid
    flops = conv_flops_per_image(det.model, x[:1]) * TIMING_BATCH
    out.update(k1=k1, gflop_per_image=flops / TIMING_BATCH / 1e9,
               forward_tflops=flops / (out["forward_ms"] * 1e-3) / 1e12)
    return out


def phase_resnet_train_timing(batch: int = TIMING_TRAIN_BATCH) -> dict:
    """ResNet-34 `train_step` alone, bf16, batch 32, dropout 0.4, frozen
    trunk: 4 windows of 10 steps, the median; then `profile_steps` over
    the same state."""
    from objectdetection_ssd_torch.config import OptimConfig
    from objectdetection_ssd_torch.ops.priors import resnet34_priors
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 15)
    b = {k: v.to(dev) for k, v in
         synthetic_batch(batch, gen, RESNET_SIZE).items()}
    priors = torch.tensor(resnet34_priors(), device=dev)
    state = create_train_state(resnet_config(compute_dtype="bfloat16"),
                               OptimConfig(), device=dev,
                               state_dict=seeded_resnet_state_dict())
    for _ in range(2):
        train_step(state, b, priors, seed=SEED)
    torch.cuda.synchronize()
    windows = []
    for _ in range(4):
        t0 = time.perf_counter()
        for _ in range(10):
            train_step(state, b, priors, seed=SEED)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 10)
    mid = statistics.median(windows)
    return {"images_per_s": batch / mid, "step_ms": mid * 1e3,
            "windows_ms": [w * 1e3 for w in windows],
            "profile": profile_steps({"resnet34": state}, b, priors)}

# ------------------------------------------------------------- int8 (K3)

# K3 vs its plain version at every conv shape of SSD300 and ResNet-34 (the
# heads included, as --int8-quantize-heads quantizes them) at this batch,
# and at ragged shapes (N, Cin, H, W, Cout, kernel, stride, padding,
# dilation): Cin 3, 5 and 8 (the rows path), Cout 24, 33, 63, 70, 84, 126,
# 129 and 189, odd maps, dilation 2 and 4, K not a multiple of the K step
# (48, 720 on vec), the 7x7/2 rows path beside the stem; together they
# reach every instantiation of `ops/int8_conv.py:TILES`.
INT8_CHECK_BATCH = 2
INT8_RAGGED = ((2, 3, 37, 41, 126, 3, 2, 1, 1),
               (2, 16, 13, 9, 189, 3, 1, 1, 1),
               (3, 8, 13, 7, 24, 3, 2, 1, 1),
               (1, 64, 5, 7, 189, 1, 1, 0, 1),
               (2, 48, 11, 11, 84, 3, 1, 4, 4),
               (2, 32, 9, 11, 63, 3, 1, 1, 1),
               (2, 48, 10, 12, 130, 1, 1, 0, 1),
               (2, 80, 7, 9, 129, 3, 2, 1, 1),
               (2, 5, 29, 31, 70, 7, 2, 3, 1),
               (2, 3, 23, 27, 33, 3, 1, 2, 2))
# Given to K3 one byte past a 16-byte boundary: the rows path although
# Cin % 16 == 0.
INT8_UNALIGNED = ((2, 64, 19, 23, 40, 3, 1, 1, 1),
                  (1, 32, 17, 15, 65, 3, 1, 4, 4))
# The L1 shapes (a 3x3 dilation-6 conv over ~1024 channels at 19 x 19):
# no rows-path window fits in shared memory, so K3 runs on copies with
# Cin zero-padded to a multiple of 16 (`ops/int8_conv.py:launch_plan`);
# (shape, aligned).
INT8_L1 = (((2, 1024, 19, 19, 1024, 3, 1, 6, 6), False),
           ((2, 1000, 19, 19, 1024, 3, 1, 6, 6), True),
           ((2, 1000, 19, 19, 1024, 3, 1, 6, 6), False))
# Requantize ties: operands in {-1, 0, 1} and scale 0.5 make y a small
# multiple of 0.5, so y / out_scale falls on half integers, exactly (out
# scales 1 and 3) or within an ulp (0.3); K3's requantize takes a
# multiply by 1 / out_scale except near such ties (`csrc/int8_conv.cu:
# requantize`, `requantize_tie`).  One vec shape and one rows shape.
INT8_TIE_SHAPES = ((2, 64, 9, 11, 70, 3, 1, 1, 1),
                   (2, 3, 13, 15, 33, 3, 1, 1, 1))
INT8_TIE_OUT_SCALES = (1.0, 3.0, 0.3)
INT8_SERVE_BATCHES = (1, 8)
INT8_CALIB_IMAGES = 16
INT8_TIMING_BATCH = 32
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet).
INT8_OPS_PER_S = 1979e12
# SSD300's quantized convs, and ResNet-34's calls of its quantized convs
# (39 convs, neck_down twice), per forward.
SSD300_INT8_CONVS = 23
RESNET_INT8_CALLS = 40
# int8 ResNet-34 card vs CPU: BN between the convs rounds differently by
# an ulp on the two (cuDNN / native), a quantizer can round such a value
# to the other int8 step, and 36 quantized convs in a row spread the
# steps; so the card's outputs are held to the CPU's by the quantization
# noise: a mean difference of at most 1.5 times the CPU's int8-vs-float
# one, correlation above 0.999 (tests/test_torch_quant.py, against JAX).
INT8_NOISE_RATIO = 1.5
QAT_FIXTURE = (96, 32)
QAT_FLOOR_FACTOR = 4.0


def conv_calls(model, images) -> list:
    """Every `TorchConv` call of one forward of ``model`` on ``images``:
    its name, input shape and dtype, geometry and quantization."""
    from objectdetection_ssd_torch.models.layers import TorchConv
    calls = []

    def hook(name):
        def record(mod, args):
            q = mod.quant
            calls.append({
                "conv": name, "shape": tuple(args[0].shape),
                "in_dtype": args[0].dtype, "cout": mod.out_channels,
                "geometry": (mod.kernel_size[0], mod.stride[0],
                             mod.padding[0], mod.dilation[0]),
                "bias": mod.bias is not None, "quantized": q is not None,
                "int8_out": q is not None and q.out_scale is not None})
        return record

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules() if isinstance(m, TorchConv)]
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for h in handles:
            h.remove()
    return calls


def int8_operands(n, cin, h, w, cout, k, gen, device, aligned=True):
    """Random int8 ``x_q`` (channels_last; ``aligned=False``: one byte past
    a 16-byte boundary), ``w_q`` (Cout, k, k, Cin), f32 scale and bias."""
    x = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                      dtype=torch.int8)
    x = x.to(device) if aligned else unaligned_nhwc(x, device)
    w_q = torch.randint(-127, 128, (cout, k, k, cin), generator=gen,
                        dtype=torch.int8).to(device)
    scale = (torch.rand(cout, generator=gen) * 1e-3 + 1e-4).to(device)
    bias = torch.randn(cout, generator=gen).to(device)
    return x.permute(0, 3, 1, 2), w_q, scale, bias


def unaligned_nhwc(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` in a buffer that starts one byte past an
    allocation's start."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    return buf[1:].view(x.shape).copy_(x)


def phase_int8_vs_plain(device, batch: int = INT8_CHECK_BATCH,
                        ragged=INT8_RAGGED,
                        unaligned=INT8_UNALIGNED, l1=INT8_L1) -> dict:
    """K3 against `int8_conv_plain` on the same inputs, bit-equal: every
    conv shape of SSD300 and ResNet-34 (heads included) at ``batch``, the
    ``ragged`` shapes, the ``unaligned`` ones (from a misaligned buffer)
    and the ``l1`` ones (Cin padded), each with f32 and bf16 output, int8
    output (requantized through f32 and through bf16), with and without
    bias; on the card, fails unless the shapes reached every
    instantiation of K3's plan and the padding.  Returns the shape count,
    the largest |K3 - plain| (0 when bit-equal), the shapes per
    instantiation and the padded ones."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.models.ssd import build_model
    from objectdetection_ssd_torch.ops import int8_conv as k3

    gen = torch.Generator().manual_seed(SEED + 20)
    keys = set()
    for cfg, size in ((ModelConfig(), 300), (resnet_config(), RESNET_SIZE)):
        model = build_model(cfg, device=device)
        images = torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                               dtype=torch.uint8).to(device)
        for c in conv_calls(model, images):
            n, cin, h, w = c["shape"]
            keys.add((n, cin, h, w, c["cout"]) + c["geometry"])
        del model
    shapes = ([(key, True) for key in sorted(keys) + list(ragged)]
              + [(key, False) for key in unaligned] + list(l1))
    worst, compared, padded = 0.0, 0, 0
    plans = {name: 0 for name in k3.TILES}
    for (n, cin, h, w, cout, k, st, pad, dil), aligned in shapes:
        x_q, w_q, scale, bias = int8_operands(n, cin, h, w, cout, k, gen,
                                              device, aligned)
        p, pad_to = k3.launch_plan(n, h, w, cin, cout, k, k, st, pad, dil,
                                   aligned=x_q.data_ptr() % 16 == 0)
        plans[p.name] += 1
        padded += pad_to is not None
        geo = (st, pad, dil)
        y = k3.int8_conv_plain(x_q, w_q, scale, bias, *geo, torch.float32)
        out_scale = torch.clamp_min(y.float().std() / 40, 1e-12).to(device)
        for dtype, b, o in itertools.product(
                (torch.float32, torch.bfloat16), (bias, None),
                (None, out_scale)):
            kern = k3.int8_conv(x_q, w_q, scale, b, *geo, dtype, o)
            plain = k3.int8_conv_plain(x_q, w_q, scale, b, *geo, dtype, o)
            err = float((kern.float() - plain.float()).abs().max())
            worst = max(worst, err)
            compared += 1
            if not torch.equal(kern, plain):
                fail(f"K3 differs from its plain version by {err} at "
                     f"{(n, cin, h, w, cout, k, st, pad, dil)} {dtype} "
                     f"bias={b is not None} int8_out={o is not None}")
    for n, cin, h, w, cout, k, st, pad, dil in INT8_TIE_SHAPES:
        x_q = torch.randint(-1, 2, (n, h, w, cin), generator=gen,
                            dtype=torch.int8).to(device).permute(0, 3, 1, 2)
        w_q = torch.randint(-1, 2, (cout, k, k, cin), generator=gen,
                            dtype=torch.int8).to(device)
        scale = torch.full((cout,), 0.5, device=device)
        for o, dtype in itertools.product(INT8_TIE_OUT_SCALES,
                                          (torch.float32, torch.bfloat16)):
            args = (x_q, w_q, scale, None, st, pad, dil, dtype,
                    torch.tensor(o, device=device))
            kern, plain = k3.int8_conv(*args), k3.int8_conv_plain(*args)
            compared += 1
            if not torch.equal(kern, plain):
                fail(f"K3 differs from its plain version at the requantize "
                     f"ties of {(n, cin, h, w, cout, k)}, out_scale {o}, "
                     f"{dtype}")
    if device.type == "cuda" and not all(plans.values()):
        fail(f"K3's check reached only {plans}")
    if padded != len(l1):
        fail(f"{padded} shapes took the padded plan, not the {len(l1)} L1 "
             f"shapes")
    return {"shapes": len(shapes), "compared": compared,
            "max_abs_err": worst, "plans": plans, "padded": padded}


def calibrated_tree(model_config, state_dict, device, images,
                    quantize_heads: bool = False) -> dict:
    """The scale tree calibrated on ``images`` (batches of 8) with the
    float model the quantized Detector holds: f32 weights, compute
    dtype."""
    from objectdetection_ssd_torch.infer import quant
    from objectdetection_ssd_torch.models.ssd import build_model
    model = build_model(model_config, device=device, train=True)
    model.load_state_dict(state_dict, strict=True)
    stats = quant.calibrate(model, images.split(8))
    return quant.act_scales(stats, quantize_heads=quantize_heads)


def noise_ratio(got, int8, float_) -> tuple:
    """(mean |got - int8| / mean |int8 - float|, correlation of got with
    int8), the worst over loc and conf."""
    ratio, corr = 0.0, 1.0
    for g, q, f in zip(got, int8, float_):
        g, q, f = (t.detach().cpu().float().reshape(-1) for t in (g, q, f))
        ratio = max(ratio, float((g - q).abs().mean() / (q - f).abs().mean()))
        corr = min(corr, float(torch.corrcoef(torch.stack([g, q]))[0, 1]))
    return ratio, corr


def phase_int8_slice(device, state_dict, resnet_state_dict,
                     batches=INT8_SERVE_BATCHES) -> dict:
    """int8 serving.  SSD300: calibrate on the card over
    ``INT8_CALIB_IMAGES`` synthetic images, serve bf16 requests through
    the chained Detector (K1 and K3 counted around them; the kernel path's
    detections == the plain-NMS path's), chained == unchained bit for bit,
    and the card's f32 int8 loc/conf within 1e-3 of the CPU port's on the
    same scale tree.  ResNet-34: the same, unchained (no exact chain edge),
    with flip TTA, and card vs CPU held by the quantization noise."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer import quant
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.ops import int8_conv as k3

    cuda = device.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 21)
    out = {}

    def images_of(size, batch_sizes):
        return {b: torch.randint(0, 256, (b, size, size, 3), generator=gen,
                                 dtype=torch.uint8).to(device)
                for b in batch_sizes}

    # SSD300.
    cfg = Config(model=ModelConfig(compute_dtype="bfloat16"))
    calib = images_of(300, (INT8_CALIB_IMAGES,))[INT8_CALIB_IMAGES]
    qtree = calibrated_tree(cfg.model, state_dict, device, calib)
    chained = quant.chain_scales(qtree, "vgg16")
    if quant.count_quantized(qtree) != SSD300_INT8_CONVS:
        fail(f"SSD300 calibration quantizes {quant.count_quantized(qtree)} "
             f"convs")
    det_c = Detector(cfg, state_dict, device=device, quant=chained)
    det_u = Detector(cfg, state_dict, device=device, quant=qtree)
    images = images_of(300, batches)
    k1, n_valid, n_suppressed, k3_launches, _, k5 = serve_requests(
        det_c, images, "SSD300 int8")
    if cuda and (k3_launches != SSD300_INT8_CONVS * len(batches)
                 or k1 != len(batches)
                 or k5 != K5_PER_FORWARD["ssd300"] * len(batches)):
        fail(f"{len(batches)} SSD300 int8 requests launched K3 "
             f"{k3_launches} times, K1 {k1} times and K5 {k5} times")
    x = images[max(batches)]
    with torch.inference_mode():
        same = all(torch.equal(a, b) for a, b in
                   zip(det_c.forward(x), det_u.forward(x)))
    if not same:
        fail("SSD300 int8 chained != unchained")
    out["ssd300"] = {"k1": k1, "k3": k3_launches, "k5": k5,
                     "valid": n_valid, "suppressed": n_suppressed}
    cfg32 = Config()
    card = Detector(cfg32, state_dict, device=device, quant=chained)
    cpu = Detector(cfg32, state_dict, device="cpu", quant=chained)
    xc = x[:CPU_CHECK_BATCH]
    out["ssd300"]["card_vs_cpu_rel"] = rel_diff(card.forward(xc),
                                                cpu.forward(xc.cpu()))
    # The quantized convs are exact on both; the float heads and the
    # L2Norm sum in another order: 1e-3 of each output's scale, as f32.
    if not out["ssd300"]["card_vs_cpu_rel"] <= 1e-3:
        fail(f"SSD300 int8 card vs CPU loc/conf differ by "
             f"{out['ssd300']['card_vs_cpu_rel']:.3e}")
    del det_c, det_u, card, cpu

    # ResNet-34.
    cfg = Config(model=resnet_config(compute_dtype="bfloat16"))
    calib = images_of(RESNET_SIZE, (INT8_CALIB_IMAGES,))[INT8_CALIB_IMAGES]
    rtree = calibrated_tree(cfg.model, resnet_state_dict, device, calib)
    if quant.chain_scales(rtree, "resnet34") != rtree:
        fail("a ResNet-34 scale tree gained chain edges")
    det = Detector(cfg, resnet_state_dict, device=device, quant=rtree)
    images = images_of(RESNET_SIZE, batches)
    k1, n_valid, n_suppressed, k3_launches, _, k5 = serve_requests(
        det, images, "ResNet-34 int8")
    if cuda and (k3_launches != RESNET_INT8_CALLS * len(batches)
                 or k1 != len(batches)
                 or k5 != K5_PER_FORWARD["resnet34"] * len(batches)):
        fail(f"{len(batches)} ResNet-34 int8 requests launched K3 "
             f"{k3_launches} times, K1 {k1} times and K5 {k5} times")
    out["resnet34"] = {"k1": k1, "k3": k3_launches, "k5": k5,
                       "valid": n_valid, "suppressed": n_suppressed,
                       "convs": quant.count_quantized(rtree)}
    tta = Detector(cfg, resnet_state_dict, device=device, quant=rtree,
                   postprocess_config=dataclasses.replace(cfg.postprocess,
                                                          tta_flip=True))
    x = images[max(batches)]
    k3.launches = 0
    d = tta.detect_batch(x)
    if cuda:
        torch.cuda.synchronize()
    tta_launches = k3.launches
    if cuda and tta_launches != 2 * RESNET_INT8_CALLS:
        fail(f"ResNet-34 int8 flip TTA launched K3 {tta_launches} times")
    if (not torch.isfinite(d.boxes_xyxy).all() or int(d.valid.sum()) == 0
            or tta.mirror_perm is None):
        fail("ResNet-34 int8 flip TTA gave no detections")
    out["resnet34"].update(tta_k3=tta_launches,
                           tta_valid=int(d.valid.sum()))
    cfg32 = Config(model=resnet_config())
    xc = x[:CPU_CHECK_BATCH]
    card = Detector(cfg32, resnet_state_dict, device=device, quant=rtree)
    cpu = Detector(cfg32, resnet_state_dict, device="cpu", quant=rtree)
    cpu_float = Detector(cfg32, resnet_state_dict, device="cpu")
    got = card.forward(xc)
    want = cpu.forward(xc.cpu())
    ratio, corr = noise_ratio(got, want, cpu_float.forward(xc.cpu()))
    out["resnet34"].update(card_vs_cpu_rel=rel_diff(got, want),
                           noise_ratio=ratio, corr=corr)
    if not (ratio <= INT8_NOISE_RATIO and corr > 0.999):
        fail(f"ResNet-34 int8 card vs CPU: {ratio:.3f} of the quantization "
             f"noise, correlation {corr:.5f}")
    return out


def im2col_int8(x_q, k, stride, padding, dilation) -> torch.Tensor:
    """The (N*Ho*Wo, Kp) int8 matrix of ``x_q``'s receptive fields, K
    padded with zeros to a multiple of 8 (`torch._int_mm`'s yardstick)."""
    import torch.nn.functional as F
    n = x_q.shape[0]
    cols = F.unfold(x_q.half(), k, dilation=dilation, padding=padding,
                    stride=stride)                   # (N, K, L), exact
    kk = cols.shape[1]
    a = cols.transpose(1, 2).reshape(n * cols.shape[2], kk)
    kp = -(-kk // 8) * 8
    if kp != kk:
        a = torch.nn.functional.pad(a, (0, kp - kk))
    return a.to(torch.int8).contiguous()


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that no host
    time between launches is counted (a small conv's kernel is shorter
    than the Python call that launches it)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def k3_library_launcher(source: Path):
    """``fn(x_q, w_q, scale, bias, stride, padding, dilation, dtype,
    out_scale) -> out``, as `int8_conv` on a CUDA tensor, launching
    ``ssd_int8_conv`` of another K3 source through the first K3's C
    signature (6 pointers; n, h, w, cin, cout, kh, kw, stride, pad, dil,
    ho, wo, mode and its ``vec`` flag; the stream) on the current
    stream."""
    from objectdetection_ssd_torch import cuda_build
    from objectdetection_ssd_torch.ops import int8_conv as k3
    lib = cuda_build.load(source)
    lib.ssd_int8_conv.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
                                  + [ctypes.c_void_p])
    lib.ssd_int8_conv.restype = ctypes.c_int

    def run(x_q, w_q, scale, bias, stride, padding, dilation, dtype,
            out_scale=None):
        n, cin, h, w = x_q.shape
        cout, kh, kw, _ = w_q.shape
        ho = k3.out_size(h, kh, stride, padding, dilation)
        wo = k3.out_size(w, kw, stride, padding, dilation)
        int8_out = out_scale is not None
        out = torch.empty((n, ho, wo, cout), device=x_q.device,
                          dtype=torch.int8 if int8_out else dtype)
        vec = int(cin % 16 == 0 and x_q.data_ptr() % 16 == 0
                  and w_q.data_ptr() % 16 == 0)
        err = lib.ssd_int8_conv(
            x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if out_scale is None else out_scale.data_ptr(),
            out.data_ptr(), n, h, w, cin, cout, kh, kw, stride, padding,
            dilation, ho, wo,
            (k3._INT8_MODES if int8_out else k3._MODES)[dtype], vec,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, err, f"ssd_int8_conv ({source.name})")
        return out.permute(0, 3, 1, 2)
    return run


def k3_ptxas(rows: list, name: str) -> dict:
    """The build log's row of K3's instantiation ``name`` (a key of
    `int8_conv.TILES`)."""
    from objectdetection_ssd_torch.ops import int8_conv as k3
    path, bm, bn, wm, wn, stages = k3.TILES[name]
    symbol = (f"int8_conv_kernelILi{bm}ELi{bn}ELi{wm}ELi{wn}ELi{stages}"
              f"ELb{int(path == 'rows')}EE")
    found = [r for r in rows if symbol in r["function"]]
    if len(found) != 1:
        fail(f"{len(found)} kernels named {symbol} in the build log")
    return found[0]


def k3_shape_timing(conv, call, gen, baselines=None) -> dict:
    """K3 at one quantized conv's batch-32 shape of the serving forward
    (its own int8 weights, scales and output mode, random int8 input):
    bit-equal to the plain version, then its device time per launch
    (`graph_ms`) and CUDA-event time per direct call (host time between
    launches included), the bound, the plain version, and, each by
    `graph_ms`, cuDNN's bf16 conv of the same shape and `torch._int_mm`
    on the int8 im2col matrix of the same GEMM.  Each of ``baselines``
    (name -> `k3_library_launcher`) must give K3's bits; it is timed in
    turns with K3 (K3, baseline, K3, baseline; the better of each pair)."""
    import torch.nn.functional as F
    from objectdetection_ssd_torch.ops import int8_conv as k3
    n, cin, h, w = call["shape"]
    k, st, pad, dil = call["geometry"]
    cout = call["cout"]
    w_q, s_w = conv.int8_weight()
    q = conv.quant
    scale = q.act_scale * s_w
    bias = None if conv.bias is None else conv.bias.detach().float()
    x_q = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                        device="cuda", dtype=torch.int8).permute(0, 3, 1, 2)
    args = (x_q, w_q, scale, bias, st, pad, dil, q.dtype, q.out_scale)
    kern = k3.int8_conv(*args)
    if not torch.equal(kern, k3.int8_conv_plain(*args)):
        fail(f"K3 differs from its plain version at {call['conv']} batch "
             f"{n}")
    ho, wo = kern.shape[2], kern.shape[3]
    m = n * ho * wo
    kk = k * k * cin
    out_bytes = 1 if q.out_scale is not None else kern.element_size()
    ops = 2 * m * cout * kk
    nbytes = (x_q.numel() + w_q.numel() + m * cout * out_bytes
              + cout * 4 * (1 if bias is None else 2))
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    run = lambda: k3.int8_conv(*args)                       # noqa: E731
    dev_ms = graph_ms(run)
    plan = k3.plan(n, h, w, cin, cout, k, k, st, pad, dil,
                   aligned=x_q.data_ptr() % 16 == 0
                   and w_q.data_ptr() % 16 == 0)
    base = {}
    for name, fn in (baselines or {}).items():
        if not torch.equal(fn(*args), kern):
            fail(f"K3 baseline {name} differs from K3 at {call['conv']}")
        base[name] = graph_ms(lambda: fn(*args))
    if base:
        dev_ms = min(dev_ms, graph_ms(run))
        for name, fn in baselines.items():
            base[name] = min(base[name], graph_ms(lambda: fn(*args)))
    row = {"conv": call["conv"], "shape": [n, cin, h, w, cout, k, st, pad,
                                           dil],
           "path": plan.path, "tile": plan.name, "smem": plan.smem,
           "patch": [plan.tile_h, plan.tile_w], "baselines": base,
           "out": "int8" if q.out_scale is not None else str(q.dtype)[6:],
           "ms": dev_ms, "host_ms": cuda_ms(run, iters=20),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tops": ops / (dev_ms * 1e-3) / 1e12,
           "plain_ms": cuda_ms(lambda: k3.int8_conv_plain(*args), iters=2,
                               warmup=1)}
    xb = torch.randn(n, cin, h, w, generator=None, device="cuda",
                     dtype=torch.bfloat16).contiguous(
                         memory_format=torch.channels_last)
    wb = w_q.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bb = None if bias is None else bias.to(torch.bfloat16)
    row["cudnn_bf16_ms"] = graph_ms(lambda: F.conv2d(xb, wb, bb, st, pad,
                                                     dil))
    del xb, wb
    a = im2col_int8(x_q, k, st, pad, dil)
    b = torch.randint(-127, 128, (cout, a.shape[1]), generator=gen,
                      device="cuda", dtype=torch.int8).t()
    row["library_ms"], refused = None, []
    for layout, bb in (("column-major", b), ("row-major", b.contiguous())):
        try:
            row["library_ms"] = graph_ms(lambda: torch._int_mm(a, bb))
        except RuntimeError as e:
            refused.append(f"{layout}: {str(e).splitlines()[0][:100]}")
            continue
        row["library"] = (f"torch._int_mm ({m}, {a.shape[1]}) x "
                          f"({a.shape[1]}, {cout}) {layout}")
        break
    else:
        row["library"] = "torch._int_mm refused: " + "; ".join(refused)
    del a, b
    return row


def phase_int8_timing(state_dict, resnet_state_dict, k3_baselines=None
                      ) -> dict:
    """int8 serving at batch 256 bf16: SSD300 chained and unchained beside
    bf16 serving in the same run (in turns, twice), their forwards; K3
    per SSD300 quantized conv at batch 32 (`k3_shape_timing`, with the
    ``k3_baselines`` beside it); ResNet-34 int8 serving beside bf16."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer import quant
    from objectdetection_ssd_torch.infer.detector import Detector

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out = {}
    for family, cfg, sd, size in (
            ("ssd300", Config(model=ModelConfig(compute_dtype="bfloat16")),
             state_dict, 300),
            ("resnet34", Config(model=resnet_config(
                compute_dtype="bfloat16")), resnet_state_dict,
             RESNET_SIZE)):
        x = torch.randint(0, 256, (TIMING_BATCH, size, size, 3),
                          generator=gen, device="cuda", dtype=torch.uint8)
        qtree = calibrated_tree(cfg.model, sd, "cuda",
                                x[:INT8_CALIB_IMAGES])
        dets = {"bf16": Detector(cfg, sd, device="cuda"),
                "int8": Detector(cfg, sd, device="cuda", quant=qtree)}
        if family == "ssd300":
            dets["int8 chained"] = Detector(
                cfg, sd, device="cuda",
                quant=quant.chain_scales(qtree, "vgg16"))
        steps = {key: [] for key in dets}
        for order in (list(dets), list(dets)[::-1]):
            for key in order:
                steps[key].append(chained_step_s(dets[key], x))
        rows = {}
        for key, det in dets.items():
            best = min(steps[key])
            with torch.inference_mode():
                fwd = cuda_ms(lambda: det.forward(x), iters=5)
            rows[key] = {"images_per_s": TIMING_BATCH / best,
                         "step_ms": best * 1e3,
                         "step_ms_runs": [t * 1e3 for t in steps[key]],
                         "forward_ms": fwd}
        out[family] = rows
        det = dets.get("int8 chained")
        del dets
        torch.cuda.empty_cache()
        if det is not None:
            calls = [c for c in conv_calls(det.model, x[:INT8_TIMING_BATCH])
                     if c["quantized"]]
            if len(calls) != SSD300_INT8_CONVS:
                fail(f"{len(calls)} quantized conv calls in SSD300")
            g = torch.Generator(device="cuda").manual_seed(SEED + 23)
            out["k3"] = []
            for c in calls:
                out["k3"].append(k3_shape_timing(
                    det.model.get_submodule(c["conv"]), c, g, k3_baselines))
                torch.cuda.empty_cache()
            del det
    return out


def phase_qat(device, steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
              fixture=QAT_FIXTURE, cli_batch: int = 32) -> dict:
    """QAT.  ``steps`` f32 `train_step(quant_ste=)` on the card against the
    CPU, under the train slice's gates (scales calibrated on the first
    batch).  Then the CLI on a `write_fixture` VOCdevkit: `train --qat`
    (bf16, SSD300) writes quant_scales.json bound to its checkpoint;
    `eval --int8` and `detect --int8` serve those scales (K3 and K1
    counted around them); a checkpoint trained on without --qat makes
    `eval --int8` exit, and `--recalibrate` calibrates afresh.  The card's
    machine has no PIL: image reads come from the packed caches."""
    import io
    import os
    import tempfile

    from objectdetection_ssd_torch import cli
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.data import cache
    from objectdetection_ssd_torch.data import pipeline as data_pipeline
    from objectdetection_ssd_torch.infer import nms_cuda, quant
    from objectdetection_ssd_torch.models.ssd import build_model
    from objectdetection_ssd_torch.ops import int8_conv as k3
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager

    cuda = device.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 24)
    batches = [synthetic_batch(batch, gen) for _ in range(steps)]
    priors = torch.tensor(ssd300_priors())
    init_sd = train_init_state_dict()
    model = build_model(ModelConfig(), device="cpu", train=True)
    model.load_state_dict(init_sd)
    qtree = quant.chain_scales(quant.act_scales(quant.calibrate(
        model, [batches[0]["images"]])), "vgg16")
    del model
    cpu = torch.device("cpu")
    state, losses = _train_run(device, ModelConfig(), init_sd, batches,
                               priors, quant_ste=qtree)
    cpu_state, cpu_losses = _train_run(cpu, ModelConfig(), init_sd, batches,
                                       priors, quant_ste=qtree)
    # The floor: the CPU against itself with every conv output moved by
    # one ulp, the size of another summation order's rounding.  A fake
    # quantizer can round such noise to the other step, so the QAT steps
    # diverge far more than float steps do.
    ulp_state, ulp_losses = _train_run(
        cpu, ModelConfig(), init_sd, batches, priors, quant_ste=qtree,
        conv_noise=torch.Generator().manual_seed(SEED + 25))
    cpu_params = dict(cpu_state.model.named_parameters())
    out = {"losses": losses}
    for key, params, run_losses in (
            ("card", state.model.named_parameters(), losses),
            ("floor", ulp_state.model.named_parameters(), ulp_losses)):
        rows = change_rows(dict(params), cpu_params, init_sd)
        out[key] = {"loss_rel": max(abs(a - b) / abs(b) for a, b in
                                    zip(run_losses, cpu_losses)),
                    "delta_rel": rows[0][0], "delta_worst": rows[0][2],
                    "delta_norm_rel": max(r[1] for r in rows)}
    # The card is held to the train slice's gates or to QAT_FLOOR_FACTOR
    # times the floor, whichever is looser: two draws of the same rounding
    # noise through the same quantizers.
    card, floor = out["card"], out["floor"]
    for key, gate in (("loss_rel", TRAIN_LOSS_RTOL),
                      ("delta_rel", TRAIN_DELTA_TOL),
                      ("delta_norm_rel", TRAIN_DELTA_NORM_TOL)):
        limit = max(gate, QAT_FLOOR_FACTOR * floor[key])
        if not card[key] <= limit:
            fail(f"QAT card vs CPU {key} {card[key]:.3e} > {limit:.3e} "
                 f"(floor {floor[key]:.3e}): losses {losses} vs "
                 f"{cpu_losses}; worst {card['delta_worst']}")
    if any(m.quant is not None for m in state.model.modules()
           if hasattr(m, "quant")):
        fail("train_step left fake-quant scales attached")
    del state, cpu_state, ulp_state

    with tempfile.TemporaryDirectory(prefix="chip_smoke_qat_") as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        prefix = os.path.join(tmp, "cache")
        ckpt = os.path.join(tmp, "ckpt")
        train_recs, val_recs = write_fixture(root, prefix, *fixture)
        index = {r.image_path: (prefix, i) for i, r in enumerate(train_recs)}
        index.update({r.image_path: (prefix + ".val", i)
                      for i, r in enumerate(val_recs)})
        serve = ["--voc-root", root, "--checkpoint-dir", ckpt, "--bf16",
                 "--batch-size", str(cli_batch), "--num-workers", "0"] + (
                     [] if cuda else ["--device", "cpu"])
        common = serve + ["--image-cache", prefix]

        def run(argv) -> tuple:
            text, err = io.StringIO(), io.StringIO()
            try:
                with contextlib.redirect_stdout(text), \
                        contextlib.redirect_stderr(err):
                    rc = cli.main(argv)
            except SystemExit as e:
                raise SystemExit(f"cli {argv[0]}: {e} "
                                 f"{err.getvalue()[-300:]}") from e
            if rc != 0:
                fail(f"cli {argv[0]} rc {rc}: {text.getvalue()[-300:]}")
            return text.getvalue(), err.getvalue()

        def counted(argv) -> tuple:
            nms_cuda.launches = 0
            k3.launches = 0
            text, err = run(argv)
            if cuda:
                torch.cuda.synchronize()
            return text, err, nms_cuda.launches, k3.launches

        load_image = data_pipeline.load_image
        data_pipeline.load_image = lambda p: cache.get_image(*index[p])
        try:
            run(["train", "--qat", "--epochs", "1"] + common)
            path = os.path.join(ckpt, quant.SCALES_FILENAME)
            meta = quant.load_scales_meta(path)
            payload, _, epoch = CheckpointManager(ckpt).load()
            saved = quant.load_scales(path)
            if (meta.get("param_fingerprint")
                    != quant.param_fingerprint(payload["model"])
                    or meta.get("epoch") != epoch or epoch != 0
                    or quant.count_quantized(saved) != SSD300_INT8_CONVS):
                fail(f"train --qat wrote {meta} for checkpoint epoch {epoch}")
            text, err, k1, k3_launches = counted(["eval", "--int8"] + common)
            evals = -(-len(val_recs) // cli_batch)
            m = re.search(r"mAP = ([-+0-9.eEnaif]+)", text)
            if (m is None or "using QAT-trained scales" not in err
                    or (cuda and (k1 != evals or k3_launches
                                  != SSD300_INT8_CONVS * evals))):
                fail(f"cli eval --int8: K1 {k1}, K3 {k3_launches}: "
                     f"{err[-300:]} {text[-200:]}")
            out["eval"] = {"map": float(m.group(1)), "batches": evals,
                           "k1": k1, "k3": k3_launches}
            paths = [r.image_path for r in val_recs[:4]]
            text, err, k1, k3_launches = counted(
                ["detect", *paths, "--int8"] + serve)
            lines = text.splitlines()
            if ([ln for ln in lines if not ln.startswith(" ")] != paths
                    or "using QAT-trained scales" not in err
                    or (cuda and (k1 != 1
                                  or k3_launches != SSD300_INT8_CONVS))):
                fail(f"cli detect --int8: K1 {k1}, K3 {k3_launches}: "
                     f"{text[-300:]}")
            out["detect"] = {"lines": len(lines) - len(paths), "k1": k1,
                             "k3": k3_launches}
            # Train on without --qat: the saved scales are now stale.
            run(["train", "--epochs", "2", "--resume"] + common)
            try:
                run(["eval", "--int8"] + common)
            except SystemExit as e:
                if "--recalibrate" not in str(e):
                    raise
                out["stale"] = str(e).splitlines()[0][:120]
            else:
                fail("cli eval --int8 served scales of other weights")
            text, err, k1, k3_launches = counted(
                ["eval", "--int8", "--recalibrate", "--int8-calib-images",
                 "32"] + common)
            n_calib = min(32, len(train_recs))
            if (f"calibrated {SSD300_INT8_CONVS} convs on {n_calib} images"
                    not in err):
                fail(f"cli eval --int8 --recalibrate: {err[-300:]}")
            out["recalibrated"] = {"k1": k1, "k3": k3_launches}
        finally:
            data_pipeline.load_image = load_image
    return out


# ------------------------------------------------- the serving artifact

EXPORT_BATCH = 8
# Calls per timing window of an artifact and of the live Detector.
EXPORT_CALLS = 20
# An artifact moved to the CPU against the same artifact on the card: the
# int8 convs are exact on both, but the float parts (the f32 heads, the
# L2Norm, the ResNet-34 convs) sum in another order, ~1e-6 of a score.
# Each valid row is matched to a valid row of the other side of the same
# image and class with score and box within 1e-4 (the port against JAX,
# tests/test_torch_detector.py); a row may lack a partner only where its
# score lies within that of the score threshold or of the other side's
# top-k cutoff, the two places where such a difference can drop a row.
EXPORT_CPU_ATOL = 1e-4
# Concurrent single-image requests the MicroBatcher answers.
BATCHER_REQUESTS = 16


def jax_gate(got, want, what: str) -> None:
    """JAX's export gate (`tests/test_export.py:50-57`): valid and classes
    equal, scores to rtol 1e-6, boxes to rtol 1e-5 / atol 1e-6."""
    got, want = ([t.cpu() for t in d] for d in (got, want))
    if not (torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
            and torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0)
            and torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-6)):
        fail(f"{what}: the detections differ")


def match_detections(got, want, threshold: float, atol: float,
                     what: str) -> dict:
    """Every valid row of ``got`` and of ``want`` matched one to one to a
    valid row of the other (same image and class, score and box within
    ``atol``), except rows whose score lies within ``atol`` of
    ``threshold`` or of the other side's lowest score when that side is
    full.  Returns the rows matched, the rows left and the largest
    difference."""
    got, want = ([t.cpu() for t in d] for d in (got, want))
    top_k = got[3].shape[1]
    matched, left, worst = 0, 0, 0.0
    for i in range(got[3].shape[0]):
        (ba, sa, ca), (bb, sb, cb) = (
            (d[0][i][d[3][i]], d[1][i][d[3][i]], d[2][i][d[3][i]])
            for d in (got, want))
        used = torch.zeros(len(sb), dtype=torch.bool)
        free = ([], [])
        for j in range(len(sa)):
            ds = (sb - sa[j]).abs()
            db = (bb - ba[j]).abs().amax(-1)
            ok = (cb == ca[j]) & ~used & (ds <= atol) & (db <= atol)
            if not ok.any():
                free[0].append(float(sa[j]))
                continue
            k = int(torch.where(ok, ds, float("inf")).argmin())
            used[k] = True
            matched += 1
            worst = max(worst, float(ds[k]), float(db[k]))
        free[1].extend(float(x) for x in sb[~used])
        for scores, other in zip(free, (sb, sa)):
            cut = threshold
            if len(other) == top_k:
                cut = max(cut, float(other.min()))
            for score in scores:
                if score > cut + atol:
                    fail(f"{what}: image {i} has a row of score {score} "
                         f"with no partner")
                left += 1
    return {"matched": matched, "left": left, "worst": worst}


def artifact_timing(served, live, x) -> dict:
    """images/s of the artifact (``served``) and of ``live.detect_batch``
    on one chunk ``x`` on the card, in turns (live, artifact, artifact,
    live), the best window of `EXPORT_CALLS` calls each (host clock,
    ending in a synchronize), and the host time per call of each
    (`host_ms_per_call`); then the loaded program captured in a CUDA
    graph (its output held to the artifact's by JAX's gate), replayed
    `EXPORT_CALLS` times between CUDA events."""
    fns = {"live": live.detect_batch, "artifact": served}
    best = {key: float("inf") for key in fns}
    for key in ("live", "artifact", "artifact", "live"):
        fns[key](x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXPORT_CALLS):
            fns[key](x)
        torch.cuda.synchronize()
        best[key] = min(best[key],
                        (time.perf_counter() - t0) / EXPORT_CALLS)
    host = {key: host_ms_per_call(lambda: fn(x), EXPORT_CALLS)
            for key, fn in fns.items()}
    with torch.inference_mode():
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                served._call(static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = served._call(static)
        graph.replay()
        jax_gate(captured, served(x),
                 "the artifact replayed as a CUDA graph")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(EXPORT_CALLS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        graph_ms_ = start.elapsed_time(end) / EXPORT_CALLS
        del graph, captured
    n = x.shape[0]
    return {"live_images_per_s": n / best["live"],
            "live_ms": best["live"] * 1e3, "live_host_ms": host["live"],
            "artifact_images_per_s": n / best["artifact"],
            "artifact_ms": best["artifact"] * 1e3,
            "artifact_host_ms": host["artifact"],
            "graph_images_per_s": n / (graph_ms_ * 1e-3),
            "graph_ms": graph_ms_}


def phase_export(device, state_dict, resnet_state_dict, root: str,
                 batch: int = EXPORT_BATCH) -> dict:
    """The serving artifact (`infer/export.py`), exported on ``device``
    into ``root`` and served, through `ExportedDetector` (the main path):
    SSD300 bf16 at ``batch`` (uint8 input); SSD300 int8 as `cli export
    --latency-profile` builds it (per-class candidates 32, batch 1, f32
    compute, scales chained from this phase's own calibration); ResNet-34
    f32 with flip TTA at ``batch``.  Each call runs two chunks, and a
    reload of the directory once more: its detections equal the live
    `Detector.detect_batch` on the same chunks to JAX's gate, with K1
    launched once, K3 23 times (int8 SSD300), K4 23 times (bf16
    SSD300) or 8 (ResNet-34, two forwards with flip TTA) and K5 5 times
    (SSD300) or 2 (ResNet-34 with flip TTA) per chunk, one
    ``ssd.max_pool`` node per pool in each program.  On the card also:
    `torch.library.opcheck` of the four ops on CUDA tensors; the int8
    and ResNet-34 artifacts moved to the CPU against the card
    (`match_detections`); `MicroBatcher` over `MinimalExportedDetector`
    answering `BATCHER_REQUESTS` concurrent requests with the rows of one
    batched call; `artifact_timing` of each artifact; export and load
    seconds."""
    import os
    import threading
    from objectdetection_ssd_torch import serve_http
    from objectdetection_ssd_torch.config import (Config, ModelConfig,
                                                  PostprocessConfig)
    from objectdetection_ssd_torch.infer import nms_cuda, quant
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.infer.export import (ExportedDetector,
                                                        export_detector)
    from objectdetection_ssd_torch.infer.postprocess import Detections
    from objectdetection_ssd_torch.ops import bias_relu, int8_conv, max_pool

    on_card = device.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 30)
    ssd_images = torch.randint(0, 256, (2 * batch, 300, 300, 3),
                               generator=gen, dtype=torch.uint8).to(device)
    r34_images = torch.randint(0, 256, (2 * batch, RESNET_SIZE, RESNET_SIZE,
                                        3), generator=gen,
                               dtype=torch.uint8).to(device)
    latency = Config(postprocess=PostprocessConfig(per_class_top_k=32))
    qtree = quant.chain_scales(calibrated_tree(latency.model, state_dict,
                                               device, ssd_images), "vgg16")
    specs = {
        "ssd300_bf16": (Config(model=ModelConfig(compute_dtype="bfloat16")),
                        state_dict, None, batch, ssd_images, 0,
                        K4_PER_FORWARD["ssd300"], K5_PER_FORWARD["ssd300"]),
        "ssd300_int8_latency": (latency, state_dict, qtree, 1,
                                ssd_images[:2], SSD300_INT8_CONVS, 0,
                                K5_PER_FORWARD["ssd300"]),
        "resnet34_tta": (Config(model=resnet_config(),
                                postprocess=PostprocessConfig(
                                    tta_flip=True)),
                         resnet_state_dict, None, batch, r34_images, 0,
                         2 * K4_PER_FORWARD["resnet34"],
                         2 * K5_PER_FORWARD["resnet34"]),
    }
    out = {"k1": 0, "k3": 0, "k4": 0, "k5": 0, "artifacts": {}}
    for name, (cfg, sd, tree, size, images, k3_per_chunk, k4_per_chunk,
               k5_per_chunk) in specs.items():
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        export_detector(cfg, sd, path, batch_size=size, quant=tree,
                        device=device)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = ExportedDetector(path, device=device)
        load_s = time.perf_counter() - t0
        chunks = images.shape[0] // size
        nms_cuda.launches = 0
        int8_conv.launches = 0
        bias_relu.launches = 0
        max_pool.launches = 0
        got = served(images)
        again = ExportedDetector(path, device=device)(images)
        if on_card:
            torch.cuda.synchronize()
        k1, k3 = nms_cuda.launches, int8_conv.launches
        k4, k5 = bias_relu.launches, max_pool.launches
        if on_card and (k1, k3, k4, k5) != (2 * chunks,
                                            2 * chunks * k3_per_chunk,
                                            2 * chunks * k4_per_chunk,
                                            2 * chunks * k5_per_chunk):
            fail(f"export {name}: {k1} K1, {k3} K3, {k4} K4 and {k5} K5 "
                 f"launches in {2 * chunks} chunks")
        out["k1"] += k1
        out["k3"] += k3
        out["k4"] += k4
        out["k5"] += k5
        live = Detector(cfg, sd, device=device, quant=tree)
        want = [live.detect_batch(images[i:i + size])
                for i in range(0, images.shape[0], size)]
        want = Detections(*(torch.cat(parts) for parts in zip(*want)))
        jax_gate(got, want, f"export {name} against the live Detector")
        jax_gate(again, got, f"export {name} reloaded")
        if (got.boxes_xyxy.shape != (images.shape[0], 200, 4)
                or not torch.isfinite(got.boxes_xyxy).all()
                or int(got.valid.sum()) == 0):
            fail(f"export {name}: malformed or empty detections")
        ops = [str(node.target) for node in served.program.graph.nodes
               if node.op == "call_function"]
        row = {"export_s": export_s, "load_s": load_s, "batch": size,
               "chunks": 2 * chunks, "k1": k1, "k3": k3, "k4": k4, "k5": k5,
               "valid": int(got.valid.sum()), "meta": served.meta,
               "ops": len(ops), "op_counts": {
                   key: ops.count(key) for key in (
                       "aten._assert_tensor_metadata.default",
                       "aten.to.dtype", "ssd.nms_keep.default",
                       "ssd.int8_conv.default", "ssd.bias_relu.default",
                       "ssd.max_pool.default")}}
        if on_card and ops.count("ssd.bias_relu.default") != k4_per_chunk:
            fail(f"export {name}: {ops.count('ssd.bias_relu.default')} "
                 f"ssd.bias_relu nodes, want {k4_per_chunk}")
        if on_card and ops.count("ssd.max_pool.default") != k5_per_chunk:
            fail(f"export {name}: {ops.count('ssd.max_pool.default')} "
                 f"ssd.max_pool nodes, want {k5_per_chunk}")
        if on_card and name != "ssd300_bf16":
            cpu = ExportedDetector(path, device="cpu")(images.cpu())
            row["cpu"] = match_detections(
                got, cpu, cfg.postprocess.score_threshold, EXPORT_CPU_ATOL,
                f"export {name} on the CPU against the card")
        if on_card:
            row["timing"] = artifact_timing(served, live, images[:size])
        out["artifacts"][name] = row
        del served, live
        if on_card:
            torch.cuda.empty_cache()

    # The batcher over the bf16 artifact: 16 requests from 16 threads.
    det = serve_http.MinimalExportedDetector(
        os.path.join(root, "ssd300_bf16"), device=device)
    want = ExportedDetector(os.path.join(root, "ssd300_bf16"),
                            device=device)(ssd_images)
    rows = ssd_images.cpu().numpy()
    batcher = serve_http.MicroBatcher(det, max_wait_ms=50.0)
    results = [None] * BATCHER_REQUESTS

    def request(i):
        results[i] = batcher.infer_one(rows[i % len(rows)])

    nms_cuda.launches = 0
    try:
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(BATCHER_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                fail("a MicroBatcher request hung")
    finally:
        batcher.close()
    out["batcher_calls"] = nms_cuda.launches
    out["k1"] += nms_cuda.launches
    for i, r in enumerate(results):
        if r is None:
            fail(f"MicroBatcher request {i} got no answer")
        j = i % len(rows)
        jax_gate([torch.from_numpy(a)[None] for a in r],
                 [t[j:j + 1] for t in want], f"MicroBatcher request {i}")

    if on_card:
        cand, valid = random_nms_sets(2, 20, 64, gen, device)
        torch.library.opcheck(torch.ops.ssd.nms_keep.default,
                              (cand, valid, THR))
        x_q, w_q, scale, bias = int8_operands(2, 64, 19, 19, 128, 3, gen,
                                              device)
        for args in ((x_q, w_q, scale, bias, 1, 1, 1, torch.float32, None),
                     (x_q, w_q, scale, None, 2, 1, 1, torch.bfloat16,
                      torch.tensor(0.05, device=device))):
            torch.library.opcheck(torch.ops.ssd.int8_conv.default, args)
        for dtype in K4_DTYPES:
            y, b = k4_operands((2, 64, 9, 11), dtype,
                               torch.Generator(device=device).manual_seed(
                                   SEED + 31), device)
            torch.library.opcheck(torch.ops.ssd.bias_relu.default, (y, b))
        for dtype in K5_DTYPES:
            x = k5_map((2, 64, 9, 11), dtype, torch.Generator(
                device=device).manual_seed(SEED + 32), device)
            for window, stride, padding, ceil_mode in dict.fromkeys(
                    g for _, _, _, g in K5_POOLS):
                torch.library.opcheck(torch.ops.ssd.max_pool.default, (
                    x, [window] * 2, [stride] * 2, [padding] * 2, ceil_mode))
    return out


# ------------------------------------------------------------- parallel

# The data-parallel phase.  The card's machine has one card and NCCL takes
# one rank per card, so the wrappers run over NCCL at world size 1 (DDP,
# and FSDP2 on a 1 x 1 data x fsdp mesh) and a two-rank DDP leg runs over
# gloo, both ranks on the one card.  No collective between two cards is
# measured here.
PARALLEL_WINDOWS = 8
PARALLEL_WINDOW_STEPS = 10
GLOO_BATCH = 4
HOST_SPLIT_STEPS = 10
# torch.profiler's names for the host work of a step: the CUDA runtime's
# kernel launches and copies (scalars made on the host, `new_tensor`), the
# loss's host sync (`_hard_negative_sum` reads one scalar where the priors
# outnumber `LossConfig.hnm_topk`: SSD300's 8732, not ResNet-34's 189)
# and the optimizer's update.
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
COPY_EVENTS = ("cudaMemcpyAsync",)
SYNC_EVENTS = ("aten::_local_scalar_dense",)
OPTIMIZER_PREFIX = "Optimizer.step#"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_world_of_one(device) -> torch.device:
    """Join a one-rank process group through `distributed.initialize`,
    from the environment torchrun would give one process (NCCL on the
    card, gloo on the CPU)."""
    import os
    from objectdetection_ssd_torch.parallel import distributed
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    return distributed.initialize(device.type)


def leave_world() -> None:
    import os
    import torch.distributed as dist
    from objectdetection_ssd_torch.parallel import distributed
    if dist.is_initialized():
        dist.destroy_process_group()
    for k in distributed.ENV_VARS:
        os.environ.pop(k, None)


def full_params(state) -> dict:
    from objectdetection_ssd_torch.parallel.data_parallel import full_tensor
    return {n: full_tensor(p.detach()).cpu() for n, p in
            state.model.named_parameters()}


def phase_parallel_steps(device, steps: int = TRAIN_STEPS,
                         batch: int = TRAIN_BATCH) -> dict:
    """f32 train steps (TF32 off, cuDNN deterministic) of SSD300 with the
    four conv1/conv2 convs routed, wrapped as DDP and as FSDP2 on the
    one-rank group, against the same steps unwrapped.  At world size 1
    the wrappers do not change the arithmetic, so each must give the
    unwrapped run's losses and parameters bit for bit; the unwrapped run
    repeated must too.  Without cuDNN's deterministic algorithms the
    unwrapped run differs from itself (``nondeterministic``, reported)."""
    from objectdetection_ssd_torch.config import ModelConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.parallel import mesh as mesh_lib

    gen = torch.Generator().manual_seed(SEED + 21)
    batches = [synthetic_batch(batch, gen) for _ in range(steps)]
    priors = torch.tensor(ssd300_priors())
    init_sd = train_init_state_dict()
    routed = ModelConfig(dw_pallas_convs=ROUTED)
    deterministic = torch.backends.cudnn.deterministic
    # What the gate would read without deterministic algorithms: the
    # unwrapped run against itself (reported, not gated).
    torch.backends.cudnn.deterministic = False
    runs = [full_params(_train_run(device, routed, init_sd, batches,
                                   priors)[0]) for _ in range(2)]
    rows = change_rows(runs[1], runs[0], init_sd)
    out = {"nondeterministic": {"delta_rel": rows[0][0],
                                "delta_worst": rows[0][2],
                                "delta_norm_rel": max(r[1] for r in rows)}}
    del runs
    torch.backends.cudnn.deterministic = True
    try:
        plain, plain_losses = _train_run(device, routed, init_sd, batches,
                                         priors)
        want = full_params(plain)
        del plain
        for key, shape, axes in (("unwrapped", None, None),
                                 ("ddp", None, ("data",)),
                                 ("fsdp", (1, 1), ("data", "fsdp"))):
            mesh = (None if axes is None
                    else mesh_lib.create_mesh(shape, axes, device.type))
            # The main path: counts set to 0 just before, read just after.
            dw_cuda.launches = 0
            state, losses = _train_run(device, routed, init_sd, batches,
                                       priors, mesh=mesh)
            if device.type == "cuda":
                torch.cuda.synchronize()
            launches = dw_cuda.launches
            if device.type == "cuda" and launches != 4 * steps:
                fail(f"{key}: K2 launched {launches} times in {steps} "
                     f"steps")
            got = full_params(state)
            del state
            rows = change_rows(got, want, init_sd)
            worst, _, worst_name = rows[0]
            norm = max(r[1] for r in rows)
            differ = [n for n in want if not torch.equal(got[n], want[n])]
            if losses != plain_losses or differ:
                fail(f"{key} vs unwrapped, cuDNN deterministic: losses "
                     f"{losses} vs {plain_losses}, {len(differ)} tensors "
                     f"differ ({differ[:3]}), changes {worst:.3e} of the "
                     f"largest ({worst_name}), {norm:.3e} in norm; want "
                     f"both bit-equal")
            out[key] = {"launches": launches, "delta_rel": worst,
                        "delta_norm_rel": norm, "losses": losses}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def phase_parallel_timing(batch: int = TIMING_TRAIN_BATCH) -> dict:
    """bf16 SSD300 train steps at ``batch`` with conv1/conv2 routed:
    unwrapped, DDP and FSDP2 on the one-rank NCCL group, windows of
    PARALLEL_WINDOW_STEPS steps in turns (unwrapped, DDP, FSDP2, then the
    reverse); the median window of each, and K2's launches per wrapped
    step."""
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.parallel import mesh as mesh_lib
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(SEED + 22)
    b = {k: v.to(dev) for k, v in synthetic_batch(batch, gen).items()}
    priors = torch.tensor(ssd300_priors(), device=dev)
    init_sd = train_init_state_dict()
    cfg = ModelConfig(compute_dtype="bfloat16", dw_pallas_convs=ROUTED)
    meshes = {"unwrapped": None,
              "ddp": mesh_lib.create_mesh(None, ("data",), "cuda"),
              "fsdp": mesh_lib.create_mesh((1, 1), ("data", "fsdp"), "cuda")}
    states = {k: create_train_state(cfg, OptimConfig(), device=dev,
                                    state_dict=init_sd, mesh=m)
              for k, m in meshes.items()}
    for state in states.values():
        for _ in range(2):
            train_step(state, b, priors, seed=SEED)
    torch.cuda.synchronize()
    windows = {k: [] for k in states}
    launches = {k: [] for k in states}
    order = list(states) + list(states)[::-1]
    for _ in range(PARALLEL_WINDOWS // 2):
        for key in order:
            dw_cuda.launches = 0
            t0 = time.perf_counter()
            for _ in range(PARALLEL_WINDOW_STEPS):
                train_step(states[key], b, priors, seed=SEED)
            torch.cuda.synchronize()
            windows[key].append((time.perf_counter() - t0)
                                / PARALLEL_WINDOW_STEPS)
            launches[key].append(dw_cuda.launches / PARALLEL_WINDOW_STEPS)
    for key, per_step in launches.items():
        if any(n != 4 for n in per_step):
            fail(f"{key}: K2 launches per step {per_step}, want 4")
    out = {k: {"step_ms": statistics.median(w) * 1e3,
               "windows_ms": [x * 1e3 for x in w],
               "images_per_s": batch / statistics.median(w)}
           for k, w in windows.items()}
    out["launches"] = sum(sum(v) * PARALLEL_WINDOW_STEPS
                          for k, v in launches.items() if k != "unwrapped")
    return out


def _gloo_rank(rank, init_file, init_path, batch_path, out_path):
    """One rank of the two-rank gloo leg, on the card: DDP over gloo of
    the f32 routed SSD300 step on this rank's rows."""
    import torch.distributed as dist
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.parallel import mesh as mesh_lib
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    try:
        dw_cuda.build()
        dev = torch.device("cuda", 0)
        per = GLOO_BATCH // 2
        batch = {k: v[rank * per:(rank + 1) * per].to(dev)
                 for k, v in torch.load(batch_path).items()}
        state = create_train_state(
            ModelConfig(dw_pallas_convs=ROUTED), OptimConfig(), device=dev,
            state_dict=torch.load(init_path),
            mesh=mesh_lib.create_mesh(None, ("data",), "cuda"))
        dw_cuda.launches = 0
        state, metrics = train_step(state, batch,
                                    torch.tensor(ssd300_priors(),
                                                 device=dev))
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                        "grads": {n: p.grad.cpu() for n, p in
                                  state.model.named_parameters()},
                        "launches": dw_cuda.launches}, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_gloo_leg() -> dict:
    """Two processes on the one card, joined over gloo (NCCL takes one rank
    per card): DDP of one f32 routed SSD300 step at global batch
    GLOO_BATCH, against the single-process step of the whole batch: the
    loss and the gradients to the train gates."""
    import tempfile
    import torch.multiprocessing as mp
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    init_sd = train_init_state_dict()
    batch = synthetic_batch(GLOO_BATCH,
                            torch.Generator().manual_seed(SEED + 23))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        paths = [f"{tmp}/pg", f"{tmp}/init.pt", f"{tmp}/batch.pt",
                 f"{tmp}/out.pt"]
        torch.save(init_sd, paths[1])
        torch.save(batch, paths[2])
        t0 = time.perf_counter()
        mp.start_processes(_gloo_rank, args=tuple(paths), nprocs=2,
                           start_method="spawn")
        leg_s = time.perf_counter() - t0
        ranks = torch.load(paths[3])
    dev = torch.device("cuda")
    state = create_train_state(ModelConfig(dw_pallas_convs=ROUTED),
                               OptimConfig(), device=dev, state_dict=init_sd)
    state, metrics = train_step(state, {k: v.to(dev) for k, v in
                                        batch.items()},
                                torch.tensor(ssd300_priors(), device=dev))
    loss, want = float(metrics["loss"]), ranks["metrics"]["loss"]
    out = {"loss": want, "loss_rel": abs(want - loss) / abs(loss),
           "launches": ranks["launches"], "seconds": leg_s}
    if not out["loss_rel"] <= TRAIN_LOSS_RTOL:
        fail(f"gloo leg loss {want} vs single-process {loss}")
    if ranks["launches"] != 4:
        fail(f"gloo leg: K2 launched {ranks['launches']} times in a step")
    # The gradients to the train gates, tensor by tensor: the two ranks'
    # convs run at batch 2, cuDNN picks other algorithms than at batch 4,
    # and the other summation order flips a few discrete choices.
    grads = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
    rows = change_rows(ranks["grads"], grads,
                       {n: torch.zeros_like(g) for n, g in grads.items()})
    worst, _, worst_name = rows[0]
    norm = max(r[1] for r in rows)
    if not (worst <= TRAIN_DELTA_TOL and norm <= TRAIN_DELTA_NORM_TOL):
        fail(f"gloo leg gradients {worst:.3e} of the largest "
             f"({worst_name}), {norm:.3e} in norm")
    out.update(grad_rel=worst, grad_worst=worst_name, grad_norm_rel=norm)
    return out


# Tensor and spatial parallelism (`parallel/tensor_parallel.py`,
# `parallel/spatial.py`): two processes on the one card over gloo (NCCL
# takes one rank per card), a (1, 2) data x model and a (1, 2) data x
# spatial mesh, held against the single-process runs on the same card.
# Their times are those of two gloo ranks sharing one card: they are not
# a multi-card figure, and the collectives cross the host.
TP_SP_WAYS = 2
TP_SP_SERVE_BATCH = 8
TP_SP_INT8_BATCH = 2
TP_SP_TIMING_STEPS = 3
# The f32 step under a partition against the single-process step on the
# card (cuDNN deterministic, TF32 off): the loss to the train gate, the
# gradients to 1e-5 of their largest, as on the CPU (tests/test_torch_tp.py,
# tests/test_torch_sp.py): the partitioned convs sum the same products,
# and only the order of the sums differs (cuDNN may pick other algorithms
# for half the channels or rows; measured by this script on an H100 80GB
# HBM3 at 700 W: 9.2e-7 under TP, 3.2e-6 under SP).
TP_SP_GRAD_TOL = 1e-5
# ResNet-34 in train mode under spatial partitioning: the train-mode BN
# gate of ROADMAP.md §3 (5e-4 of the largest gradient).
TP_SP_RESNET_TOL = 5e-4
# f32 detections under a partition against the single-process Detector on
# the card: every row matched to one of the same image and class, score and
# box within this (tests/test_torch_detector.py's tolerance).  In bf16 the
# detection sets themselves differ (an ulp of a bf16 logit flips NMS and
# top-k choices among the many near-equal candidates of the wide-bias
# weights: 199 of 491 rows found no partner at any tolerance up to 0.3 in
# this script's first run), so bf16 is held by its loc / conf outputs.
TP_SP_DET_ATOL = 1e-4
# bf16 loc / conf under a partition against the single-process forward:
# four bf16 rounding steps (2^-8 each) of the largest output, since the
# forward's 23 convs round to bf16 one after another and an ulp that flips
# in one moves the next (measured by this script on an H100 80GB HBM3 at
# 700 W: 1.05e-2 under TP, 5.2e-3 under SP).
TP_SP_BF16_TOL = 2.0 ** -6
# The SSD300 collectives whose bytes are reported: batch and dtype.
COLLECTIVE_BATCH = 32


class _CountSpatial:
    """A stand-in for `parallel/spatial.py:SpatialParallel` on the meta
    device: the shapes of rank 0 of ``ways``, and the bytes of every
    all-gather stack (halo bands, head rows) the real one would build."""

    kind = "spatial"

    def __init__(self, ways: int):
        self.ways, self.index, self.halo, self.heads = ways, 0, 0, 0

    @staticmethod
    def narrow_rows(y, start, n):
        return y.narrow(2, start, n)

    def full_channels(self, x, channels):
        return x

    def rows(self, height):
        from objectdetection_ssd_torch.parallel.mesh import row_bounds
        return row_bounds(height, self.ways, self.index)

    def enter(self, x):
        lo, hi = self.rows(x.shape[2])
        return x[:, :, lo:hi]

    def extend(self, x, kernel, stride=1, padding=0, dilation=1,
               ceil_mode=False, fill=0.0, pad_w=0):
        from objectdetection_ssd_torch.parallel.spatial import halo_plan
        p = halo_plan(x.shape[3], self.ways, kernel, stride, padding,
                      dilation, ceil_mode)
        b, c, _, w = x.shape
        self.halo += (self.ways * sum(p.widths) * b * w * c
                      * x.element_size())
        lo, hi = p.need[self.index]
        return x.new_empty((b, c, hi - lo, w + 2 * pad_w)), p.rows[self.index]

    def whole(self, x, channels=None):
        from objectdetection_ssd_torch.parallel.mesh import row_bounds
        b, c, _, w = x.shape
        widest = max(hi - lo for lo, hi in (row_bounds(w, self.ways, j)
                                            for j in range(self.ways)))
        self.heads += self.ways * widest * b * w * c * x.element_size()
        return x.new_empty((b, c, w, w))


class _CountTensor:
    """A stand-in for `parallel/tensor_parallel.py:TensorParallel` over a
    whole model on the meta device: the bytes of every channel gather the
    real one would make (each tensor a sharded conv produced, once)."""

    kind = "model"

    def __init__(self, ways: int):
        self.ways, self.bytes, self.seen = ways, 0, []

    def enter(self, x):
        return x

    def full_channels(self, x, channels):
        if (channels % self.ways == 0 and channels > 3
                and not any(x is t for t in self.seen)):
            self.seen.append(x)
            self.bytes += x.numel() * x.element_size()
        return x

    whole = full_channels


def collective_bytes(ways: int, batch: int = COLLECTIVE_BATCH) -> dict:
    """The bytes of SSD300's collectives per step at ``batch`` bf16, for a
    ``model`` or ``spatial`` axis of ``ways`` ranks, from the shapes (a
    forward on the meta device through stand-ins of the two partitions):
    each all-gather's stack (every rank ends up holding it; the backward
    all-reduces a buffer of the same size), and TP's L2Norm all-reduce of
    the f32 squares."""
    from objectdetection_ssd_torch.models.layers import set_partition
    from objectdetection_ssd_torch.models.ssd import SSD300
    with torch.device("meta"):
        model = SSD300(dtype=torch.bfloat16).to(torch.bfloat16)
        images = torch.empty((batch, 300, 300, 3), dtype=torch.uint8)
    out = {}
    for part in (_CountTensor(ways), _CountSpatial(ways)):
        set_partition(model, part)
        with torch.no_grad():
            model(images)
        out[part.kind] = part
    set_partition(model, None)
    l2 = batch * 38 * 38 * 4 if 512 % ways == 0 else 0
    return {"tp_gather": out["model"].bytes, "tp_l2norm": l2,
            "sp_halo": out["spatial"].halo, "sp_heads": out["spatial"].heads}


def int8_calls_match(part, got: list, want: list) -> list:
    """Per K3 call: this rank's output equal, bit for bit, to its slice of
    the single-process call's output: its channels (tensor parallel) or
    the rows it computed (spatial; a rank without rows computes one)."""
    same = []
    for g, w in zip(got, want):
        if part.kind == "model":
            lo, hi = (part.channels(w.shape[1]) if g.shape[1] != w.shape[1]
                      else (0, w.shape[1]))
            ref = w[:, lo:hi]
        else:
            h = w.shape[2]
            lo, hi = part.rows(h)
            start = lo if hi > lo else min(lo, h - 1)
            ref = w[:, :, start:start + g.shape[2]]
        same.append(g.shape == ref.shape and torch.equal(g.cpu(), ref))
    return same


@contextlib.contextmanager
def recording_k3(calls: list):
    """While open, every K3 call's output is appended to ``calls`` (on the
    CPU)."""
    from objectdetection_ssd_torch.models import layers
    original = layers.k3.int8_conv

    def recording(*args, **kw):
        out = original(*args, **kw)
        calls.append(out.cpu())
        return out

    layers.k3.int8_conv = recording
    try:
        yield calls
    finally:
        layers.k3.int8_conv = original


def local_part(t: torch.Tensor) -> tuple:
    """(this rank's part of ``t`` on the CPU, whether it is a channel shard
    of a tensor-parallel DTensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t.cpu(), False
    return t.to_local().cpu(), any(isinstance(p, Shard)
                                   for p in t.placements)


def join_parts(ranks: list, own: int) -> dict:
    """The whole tensors of `local_part`s, one dict per rank in rank order:
    channel shards concatenated, replicated parts rank ``own``'s."""
    return {n: (torch.cat([r[n][0] for r in ranks]) if part[1] else part[0])
            for n, part in ranks[own].items()}


def _tp_sp_rank(rank, init_file, tmp):
    """One rank of the two-rank TP / SP leg, on the card."""
    import faulthandler
    import os

    import torch.distributed as dist

    from objectdetection_ssd_torch.config import (Config, DataConfig,
                                                  ModelConfig, OptimConfig,
                                                  TrainConfig)
    from objectdetection_ssd_torch.data.pipeline import Loader
    from objectdetection_ssd_torch.eval.evaluate import (
        evaluate_records, exact_eval_postprocess)
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.ops import dw_cuda, int8_conv
    from objectdetection_ssd_torch.ops.priors import (resnet34_priors,
                                                      ssd300_priors)
    from objectdetection_ssd_torch.parallel import mesh as mesh_lib
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state
    from objectdetection_ssd_torch.train.trainer import Trainer

    faulthandler.enable()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=TP_SP_WAYS)
    try:
        dw_cuda.build()
        nms_cuda.build()
        int8_conv.build()
        dev = torch.device("cuda", 0)
        inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        single_calls = torch.load(f"{tmp}/int8_calls.pt")
        priors = torch.tensor(ssd300_priors(), device=dev)
        batch = {k: v.to(dev) for k, v in inp["batch"].items()}
        out = {}

        def qat_step(mesh, rows):
            """One QAT step on ``mesh``: (metrics, this rank's part of
            each parameter after it)."""
            state = create_train_state(ModelConfig(), OptimConfig(),
                                       device=dev, state_dict=inp["train_sd"],
                                       mesh=mesh)
            state, metrics = train_step(state, rows, priors,
                                        quant_ste=inp["qat_tree"])
            return ({k: float(v) for k, v in metrics.items()},
                    {n: local_part(p.detach()) for n, p in
                     state.model.named_parameters()})

        # QAT under data parallelism (DDP over gloo): this rank's rows.
        b = TRAIN_BATCH // TP_SP_WAYS
        out["data"] = {"qat": qat_step(
            mesh_lib.create_mesh((TP_SP_WAYS,), ("data",), "cuda"),
            {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()})}
        for axis in ("model", "spatial"):
            mesh = mesh_lib.create_mesh((1, TP_SP_WAYS), ("data", axis),
                                        "cuda")
            r = {"qat": qat_step(mesh, batch)}
            t0 = time.perf_counter()
            state = create_train_state(
                ModelConfig(dw_pallas_convs=ROUTED), OptimConfig(),
                device=dev, state_dict=inp["train_sd"], mesh=mesh)
            # The main path: counts set to 0 just before, read just after.
            dw_cuda.launches = 0
            state, metrics = train_step(state, batch, priors)
            torch.cuda.synchronize()
            r["k2"] = dw_cuda.launches
            r["metrics"] = {k: float(v) for k, v in metrics.items()}
            # This rank's part of each gradient; the parent joins the
            # channel shards (DTensor's own gathers crash on gloo with
            # CUDA tensors, torch 2.11).
            r["grads"] = {n: local_part(p.grad) for n, p in
                          state.model.named_parameters()}
            t1 = time.perf_counter()
            for _ in range(TP_SP_TIMING_STEPS):
                train_step(state, batch, priors)
            torch.cuda.synchronize()
            r["step_ms"] = (time.perf_counter() - t1) / TP_SP_TIMING_STEPS \
                * 1e3
            del state
            if axis == "spatial":
                rbatch = {k: v.to(dev) for k, v in inp["resnet_batch"]
                          .items()}
                state = create_train_state(
                    ModelConfig(backbone="resnet34",
                                image_size=RESNET_SIZE), OptimConfig(),
                    device=dev, state_dict=inp["resnet_sd"], mesh=mesh)
                state, metrics = train_step(
                    state, rbatch, torch.tensor(resnet34_priors(),
                                                device=dev), seed=SEED)
                r["resnet"] = (
                    {k: float(v) for k, v in metrics.items()},
                    {n: p.grad.cpu() for n, p in
                     state.model.named_parameters() if p.grad is not None},
                    {n: t.cpu() for n, t in state.model.state_dict().items()
                     if n.endswith(("running_mean", "running_var"))})
                del state
            images = inp["images"].to(dev)
            det = Detector(Config(), inp["serve_sd"], device=dev, mesh=mesh)
            nms_cuda.launches = 0
            dets = det.detect_batch(images)
            torch.cuda.synchronize()
            r["k1"] = nms_cuda.launches
            r["f32"] = [t.cpu() for t in dets]
            det = Detector(Config(model=ModelConfig(
                compute_dtype="bfloat16")), inp["serve_sd"], device=dev,
                mesh=mesh)
            r["bf16"] = [t.float().cpu() for t in det.forward(images)]
            nms_cuda.launches = 0
            det.detect_batch(images)
            torch.cuda.synchronize()
            r["k1"] += nms_cuda.launches
            t1 = time.perf_counter()
            for _ in range(TP_SP_TIMING_STEPS):
                det.detect_batch(images)
            torch.cuda.synchronize()
            r["serve_ms"] = (time.perf_counter() - t1) / TP_SP_TIMING_STEPS \
                * 1e3
            del det
            det = Detector(Config(), inp["serve_sd"], device=dev,
                           quant=inp["qtree"], mesh=mesh)
            calls = []
            int8_conv.launches = 0
            with recording_k3(calls):
                dets = det.detect_batch(images[:TP_SP_INT8_BATCH])
            torch.cuda.synchronize()
            r["k3"] = int8_conv.launches
            part = det.model.trunk.conv1_1.part
            r["int8_calls"] = (len(calls), len(single_calls),
                               int8_calls_match(part, calls, single_calls))
            r["int8"] = [t.cpu() for t in dets]
            del det
            r["seconds"] = time.perf_counter() - t0
            out[axis] = r

        # One Trainer epoch and one eval under spatial partitioning.
        t0 = time.perf_counter()
        mesh = mesh_lib.create_mesh((1, TP_SP_WAYS), ("data", "spatial"),
                                    "cuda")
        shard = mesh_lib.data_shard(mesh)
        root, prefix = f"{tmp}/VOCdevkit", f"{tmp}/cache"
        train_recs, val_recs = inp["records"]
        cfg = Config(
            model=ModelConfig(compute_dtype="bfloat16"),
            data=DataConfig(voc_root=root, batch_size=TIMING_TRAIN_BATCH,
                            num_workers=min(4, os.cpu_count() or 1),
                            image_cache=prefix),
            train=TrainConfig(checkpoint_dir=f"{tmp}/ckpt",
                              log_every_steps=0, seed=SEED,
                              mesh_shape=(1, TP_SP_WAYS),
                              mesh_axis_names=("data", "spatial")))
        loaders = (Loader(train_recs, cfg.data, 300, train=True,
                          seed=SEED, cache_path=prefix, shard=shard),
                   Loader(val_recs, cfg.data, 300, train=False,
                          drop_last=False, cache_path=prefix + ".val",
                          shard=shard))
        try:
            trainer = Trainer(cfg, *loaders, device=dev)
            dw_cuda.launches = 0
            trainer.fit(1)
            torch.cuda.synchronize()
            fit = {"history": trainer.history,
                   "stats": trainer.phase_stats, "step": trainer.state.step,
                   "params": {n: p.detach().cpu() for n, p in
                              trainer.state.model.named_parameters()}}
            det = Detector(cfg, trainer.state.model.state_dict(), device=dev,
                           postprocess_config=exact_eval_postprocess(
                               cfg.postprocess), mesh=mesh)
            nms_cuda.launches = 0
            t1 = time.perf_counter()
            _, fit["map"] = evaluate_records(cfg, None, val_recs,
                                             detector=det,
                                             image_cache=prefix + ".val")
            torch.cuda.synchronize()
            fit["eval_s"] = time.perf_counter() - t1
            fit["eval_k1"] = nms_cuda.launches
            fit["eval_batches"] = -(-len(val_recs) // TIMING_TRAIN_BATCH)
        finally:
            for loader in loaders:
                loader.close()
        fit["seconds"] = time.perf_counter() - t0
        out["trainer"] = fit
        torch.save(out, f"{tmp}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_tp_sp_leg(qat_floor: dict) -> dict:
    """Two processes on the one card over gloo: QAT steps under data
    parallelism (DDP), tensor parallelism and spatial partitioning against
    the single-process card QAT step, at phase "qat"'s gates (the train
    gates or `QAT_FLOOR_FACTOR` times ``qat_floor``, that phase's floor);
    tensor parallelism
    (``data x model`` = 1 x 2) and spatial partitioning (``data x
    spatial`` = 1 x 2) of the f32 routed SSD300 step (K2 counted), bf16
    and int8 serving through `Detector(mesh=)` (K1 and K3 counted, every
    K3 call bit-equal to the single-process call's slice), the ResNet-34
    train-mode step under SP, then one `Trainer.fit` epoch and one
    `evaluate_records` under SP on half the trainer slice's fixture, whose
    checkpoint reloads at world size 1 to the ranks' parameters.  Held
    against the single-process runs on the card."""
    import tempfile
    import torch.multiprocessing as mp
    from objectdetection_ssd_torch.config import (Config, ModelConfig,
                                                  OptimConfig)
    from objectdetection_ssd_torch.infer import quant as quant_lib
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.models.ssd import build_model
    from objectdetection_ssd_torch.ops.priors import (resnet34_priors,
                                                      ssd300_priors)
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 24)
    serve_sd = seeded_state_dict()
    images = torch.randint(0, 256, (TP_SP_SERVE_BATCH, 300, 300, 3),
                           generator=gen, dtype=torch.uint8)
    inp = {"train_sd": train_init_state_dict(),
           "batch": synthetic_batch(TRAIN_BATCH, gen),
           "resnet_sd": seeded_resnet_state_dict(),
           "resnet_batch": synthetic_batch(RESNET_TRAIN_BATCH, gen,
                                           size=RESNET_SIZE),
           "serve_sd": serve_sd, "images": images}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # The single-process references on the card.
        model = build_model(ModelConfig(), device=dev, train=True)
        model.load_state_dict(serve_sd)
        inp["qtree"] = quant_lib.chain_scales(quant_lib.act_scales(
            quant_lib.calibrate(model, [images[:TP_SP_INT8_BATCH].to(dev)])),
            "vgg16")
        del model
        single_calls = []
        with recording_k3(single_calls):
            single_int8 = Detector(Config(), serve_sd, device=dev,
                                   quant=inp["qtree"]).detect_batch(
                images[:TP_SP_INT8_BATCH].to(dev))
        single_f32 = Detector(Config(), serve_sd, device=dev).detect_batch(
            images.to(dev))
        # QAT: scales calibrated on the step's batch, one single-process
        # step on the card.
        model = build_model(ModelConfig(), device=dev, train=True)
        model.load_state_dict(inp["train_sd"])
        inp["qat_tree"] = quant_lib.chain_scales(quant_lib.act_scales(
            quant_lib.calibrate(model, [inp["batch"]["images"].to(dev)])),
            "vgg16")
        del model
        state = create_train_state(ModelConfig(), OptimConfig(), device=dev,
                                   state_dict=inp["train_sd"])
        state, metrics = train_step(
            state, {k: v.to(dev) for k, v in inp["batch"].items()},
            torch.tensor(ssd300_priors(), device=dev),
            quant_ste=inp["qat_tree"])
        single_qat = (float(metrics["loss"]),
                      {n: p.detach().cpu() for n, p in
                       state.model.named_parameters()})
        del state
        single_bf16 = [t.float().cpu() for t in Detector(Config(
            model=ModelConfig(compute_dtype="bfloat16")), serve_sd,
            device=dev).forward(images.to(dev))]
        state = create_train_state(ModelConfig(dw_pallas_convs=ROUTED),
                                   OptimConfig(), device=dev,
                                   state_dict=inp["train_sd"])
        state, metrics = train_step(
            state, {k: v.to(dev) for k, v in inp["batch"].items()},
            torch.tensor(ssd300_priors(), device=dev))
        single_step = ({k: float(v) for k, v in metrics.items()},
                       {n: p.grad.cpu() for n, p in
                        state.model.named_parameters()})
        del state
        state = create_train_state(
            ModelConfig(backbone="resnet34", image_size=RESNET_SIZE),
            OptimConfig(), device=dev, state_dict=inp["resnet_sd"])
        state, metrics = train_step(
            state, {k: v.to(dev) for k, v in inp["resnet_batch"].items()},
            torch.tensor(resnet34_priors(), device=dev), seed=SEED)
        single_resnet = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in state.model.named_parameters()
             if p.grad is not None},
            {n: t.cpu() for n, t in state.model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))})
        del state
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tpsp_") as tmp:
        inp["records"] = write_fixture(f"{tmp}/VOCdevkit", f"{tmp}/cache",
                                       *CUT_FIXTURE)
        torch.save(inp, f"{tmp}/inputs.pt")
        torch.save(single_calls, f"{tmp}/int8_calls.pt")
        t0 = time.perf_counter()
        mp.start_processes(_tp_sp_rank, args=(f"{tmp}/pg", tmp),
                           nprocs=TP_SP_WAYS, start_method="spawn")
        leg_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(TP_SP_WAYS)]
        saved, _, _ = CheckpointManager(f"{tmp}/ckpt").load()

    out = {"seconds": leg_s, "k1": 0, "k2": 0, "k3": 0, "qat": {}}
    for axis in ("data", "model", "spatial"):
        row = {}
        for rank, res in enumerate(ranks):
            metrics, _ = res[axis]["qat"]
            params = join_parts([x[axis]["qat"][1] for x in ranks], rank)
            rows = change_rows(params, single_qat[1], inp["train_sd"])
            got = {"loss_rel": abs(metrics["loss"] - single_qat[0])
                   / abs(single_qat[0]),
                   "delta_rel": rows[0][0], "delta_worst": rows[0][2],
                   "delta_norm_rel": max(r[1] for r in rows)}
            for key, gate in (("loss_rel", TRAIN_LOSS_RTOL),
                              ("delta_rel", TRAIN_DELTA_TOL),
                              ("delta_norm_rel", TRAIN_DELTA_NORM_TOL)):
                limit = max(gate, QAT_FLOOR_FACTOR * qat_floor[key])
                if not got[key] <= limit:
                    fail(f"QAT under {axis} rank {rank} vs the "
                         f"single-process card step: {key} {got[key]:.3e} "
                         f"> {limit:.3e} ({got})")
                row[key] = max(row.get(key, 0.0), got[key])
            row.setdefault("delta_worst", got["delta_worst"])
        out["qat"][axis] = row
    smetrics, sgrads = single_step
    zeros = {n: torch.zeros_like(g) for n, g in sgrads.items()}
    for axis in ("model", "spatial"):
        row = {"step_ms": [], "serve_ms": [], "seconds": []}
        for rank, res in enumerate(ranks):
            r = res[axis]
            for key in ("step_ms", "serve_ms", "seconds"):
                row[key].append(r[key])
            what = f"{axis} rank {rank}"
            loss_rel = abs(r["metrics"]["loss"] - smetrics["loss"]) / abs(
                smetrics["loss"])
            grads = join_parts([x[axis]["grads"] for x in ranks], rank)
            rows = change_rows(grads, sgrads, zeros)
            worst, _, worst_name = rows[0]
            norm = max(x[1] for x in rows)
            if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TP_SP_GRAD_TOL
                    and norm <= TRAIN_DELTA_NORM_TOL):
                fail(f"{what}: step loss {loss_rel:.3e} relative, gradients "
                     f"{worst:.3e} of the largest ({worst_name}), {norm:.3e} "
                     f"in norm against the single-process step")
            if r["k2"] != 4:
                fail(f"{what}: K2 launched {r['k2']} times in a step")
            if r["k1"] != 2:
                fail(f"{what}: K1 launched {r['k1']} times in two batches")
            if r["k3"] != 23:
                fail(f"{what}: K3 launched {r['k3']} times in a forward")
            n_got, n_want, same = r["int8_calls"]
            if n_got != n_want or not all(same):
                fail(f"{what}: int8 calls {n_got} vs {n_want}, "
                     f"{same.count(False)} not bit-equal to the "
                     f"single-process call's slice")
            f32 = match_detections(r["f32"], single_f32,
                                   Config().postprocess.score_threshold,
                                   TP_SP_DET_ATOL, f"{what} f32 serving")
            bf16 = rel_diff(r["bf16"], single_bf16)
            if bf16 > TP_SP_BF16_TOL:
                fail(f"{what}: bf16 loc/conf {bf16:.3e} of their largest "
                     f"from the single-process forward's")
            int8 = match_detections(r["int8"], single_int8,
                                    Config().postprocess.score_threshold,
                                    TP_SP_DET_ATOL, f"{what} int8 serving")
            row.update(loss_rel=max(row.get("loss_rel", 0.0), loss_rel),
                       grad_rel=max(row.get("grad_rel", 0.0), worst),
                       grad_worst=worst_name,
                       grad_norm=max(row.get("grad_norm", 0.0), norm),
                       f32=f32, bf16=max(row.get("bf16", 0.0), bf16),
                       int8=int8, int8_calls=len(same))
            out["k1"] += r["k1"]
            out["k2"] += r["k2"]
            out["k3"] += r["k3"]
        out[axis] = row

    rmetrics, rgrads, rstats = single_resnet
    worst_resnet = 0.0
    for rank, res in enumerate(ranks):
        metrics, grads, stats = res["spatial"]["resnet"]
        if abs(metrics["loss"] - rmetrics["loss"]) > TRAIN_LOSS_RTOL * abs(
                rmetrics["loss"]):
            fail(f"ResNet-34 SP rank {rank}: loss {metrics['loss']} vs "
                 f"{rmetrics['loss']}")
        for name, g in rgrads.items():
            if name.startswith("loc_") and name.endswith("conv.bias"):
                continue        # zero in exact arithmetic (a BN follows)
            rel = float((grads[name] - g).abs().max() / g.abs().max())
            worst_resnet = max(worst_resnet, rel)
            if rel > TP_SP_RESNET_TOL:
                fail(f"ResNet-34 SP rank {rank}: {name} gradient {rel:.3e} "
                     f"of its largest")
        for name, s in rstats.items():
            if not torch.allclose(stats[name], s, rtol=1e-5, atol=1e-5):
                fail(f"ResNet-34 SP rank {rank}: BN statistic {name}")
    out["resnet_grad_rel"] = worst_resnet

    fit = ranks[0]["trainer"]
    history = fit["history"]["train"] + fit["history"]["test"]
    if not all(math.isfinite(x) for x in history) or not math.isfinite(
            fit["map"]):
        fail(f"SP trainer: history {fit['history']}, mAP {fit['map']}")
    if any(not torch.equal(saved["model"][n], p)
           for n, p in fit["params"].items()):
        fail("SP trainer: the checkpoint does not reload to the ranks' "
             "parameters")
    if fit["eval_k1"] != fit["eval_batches"]:
        fail(f"SP eval: K1 launched {fit['eval_k1']} times in "
             f"{fit['eval_batches']} batches")
    if ranks[1]["trainer"]["map"] != fit["map"]:
        fail("SP eval: the ranks' mAPs differ")
    out["trainer"] = {k: fit[k] for k in ("history", "stats", "step", "map",
                                          "eval_s", "eval_k1", "seconds")}
    out["k1"] += sum(r["trainer"]["eval_k1"] for r in ranks)
    out["bytes"] = {ways: collective_bytes(ways) for ways in (2, 4)}
    return out


def phase_parallel_cli(device, num_2007: int = 448, num_2012: int = 192,
                       batch: int = TIMING_TRAIN_BATCH,
                       workers: int = 0) -> dict:
    """Under the one-rank process group: `cli train --eval-map-every 1
    --profile-dir` (DDP through `distributed.initialize`) for one bf16
    epoch on the trainer slice's fixture, the trace written, the
    checkpoint served by `Detector.from_checkpoint`; then `cli eval
    --data-parallel 1` (the multi-rank path: rows gathered over the group)
    against `evaluate_records(local_only=True)` on the same checkpoint,
    with K1 launched once per batch; and both paths of `evaluate_records`
    on the serving weights, row for row."""
    import glob
    import io
    import logging.handlers
    import os
    import tempfile

    import numpy as np

    from objectdetection_ssd_torch import cli, native
    from objectdetection_ssd_torch.config import (Config, DataConfig,
                                                  ModelConfig)
    from objectdetection_ssd_torch.data import cache
    from objectdetection_ssd_torch.data.pipeline import (preprocess_image,
                                                         quantize_uint8)
    from objectdetection_ssd_torch.eval.evaluate import (
        evaluate_records, exact_eval_postprocess)
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer.detector import (Detector,
                                                          checkpoint_weights)
    from objectdetection_ssd_torch.utils.metrics import logger, setup_logging

    cuda = device.type == "cuda"
    native.fallbacks = 0
    workers = workers or min(8, os.cpu_count() or 1)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        prefix = os.path.join(tmp, "cache")
        ckpt = os.path.join(tmp, "ckpt")
        prof = os.path.join(tmp, "prof")
        train_recs, val_recs = write_fixture(root, prefix, num_2007,
                                             num_2012)
        common = ["--voc-root", root, "--checkpoint-dir", ckpt,
                  "--image-cache", prefix, "--batch-size", str(batch),
                  "--bf16"] + ([] if cuda else ["--device", "cpu"])

        def run(argv) -> str:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main(argv)
            if rc != 0:
                fail(f"cli {argv[0]} rc {rc}: {text.getvalue()[-300:]}")
            return text.getvalue()

        nms_cuda.launches = 0
        t0 = time.perf_counter()
        text = run(["train", "--epochs", "1", "--num-workers", str(workers),
                    "--eval-map-every", "1", "--profile-dir", prof]
                   + common)
        if cuda:
            torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["train_k1"] = nms_cuda.launches
        m = re.search(r"epoch 0: val mAP = ([-+0-9.eEnaif]+)", text)
        if m is None or not math.isfinite(float(m.group(1))):
            fail(f"cli train --eval-map-every printed no mAP: {text[-300:]}")
        out["train_map"] = float(m.group(1))
        if cuda and out["train_k1"] < 1:
            fail("the side eval of --eval-map-every launched no K1")
        traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
        if len(traces) != 1 or os.path.getsize(traces[0]) == 0:
            fail(f"--profile-dir wrote {traces}")
        out["trace_mb"] = os.path.getsize(traces[0]) / 2 ** 20

        cfg = Config(model=ModelConfig(compute_dtype="bfloat16"),
                     data=DataConfig(voc_root=root, batch_size=batch))
        det = Detector.from_checkpoint(cfg, ckpt, device=device)
        imgs = np.stack([quantize_uint8(preprocess_image(
            cache.get_image(prefix + ".val", i % len(val_recs)), 300,
            normalize=False)) for i in range(8)])
        dets = det.detect_batch(imgs)
        if (dets.boxes_xyxy.shape != (8, 200, 4)
                or not torch.isfinite(dets.boxes_xyxy).all()):
            fail("detect_batch from the data-parallel checkpoint is "
                 "malformed")
        del det

        setup_logging()
        log = logging.handlers.BufferingHandler(capacity=1 << 16)
        logger.addHandler(log)
        nms_cuda.launches = 0
        try:
            text = run(["eval", "--data-parallel", "1"] + common)
        finally:
            logger.removeHandler(log)
        if cuda:
            torch.cuda.synchronize()
        launches = nms_cuda.launches
        m = re.search(r"mAP = ([-+0-9.eEnaif]+)", text)
        runs = [re.fullmatch(r"eval: (\d+) images in (\d+) batches, "
                             r"([0-9.]+) s", r.getMessage())
                for r in log.buffer]
        runs = [r for r in runs if r]
        if m is None or len(runs) != 1:
            fail(f"cli eval --data-parallel 1: {text[-300:]}")
        batches = int(runs[0].group(2))
        if cuda and launches != batches:
            fail(f"K1 launched {launches} times in {batches} eval batches")
        weights, _ = checkpoint_weights(cfg, ckpt)
        _, plain_map = evaluate_records(
            cfg, weights, val_recs, batch_size=batch, device=device,
            image_cache=prefix + ".val", local_only=True)
        if abs(float(m.group(1)) - plain_map) > 5e-5:
            fail(f"cli eval --data-parallel 1 mAP {m.group(1)} vs the plain "
                 f"path's {plain_map}")
        out["eval"] = {"map": float(m.group(1)), "plain_map": plain_map,
                       "launches": launches, "batches": batches,
                       "images": int(runs[0].group(1)),
                       "images_per_s": int(runs[0].group(1))
                       / float(runs[0].group(3))}
        # The trained checkpoint finds nothing after one epoch, so the
        # paths are also compared on the serving weights (wide conf
        # biases): every gathered detection row equal to the plain path's,
        # per-class AP to 1e-6.
        det = Detector(Config(), seeded_state_dict(), device=device,
                       postprocess_config=exact_eval_postprocess(
                           Config().postprocess))
        detect, rows, aps = det.detect_batch, {}, {}
        for key, local in (("multi", False), ("plain", True)):
            seen = rows[key] = []

            def recording(images, seen=seen):
                dets = detect(images)
                seen.append(dets)
                return dets

            det.detect_batch = recording
            aps[key] = evaluate_records(
                Config(), None, val_recs, batch_size=batch, detector=det,
                image_cache=prefix + ".val", local_only=local)
        det.detect_batch = detect
        same = len(rows["multi"]) == len(rows["plain"]) and all(
            torch.equal(a, b) for x, y in zip(rows["multi"], rows["plain"])
            for a, b in zip(x, y))
        worst = max(abs(aps["multi"][0][c] - aps["plain"][0][c])
                    for c in aps["plain"][0])
        valid = sum(int(d.valid.sum()) for d in rows["plain"])
        if not (same and valid > 0 and worst <= 1e-6):
            fail(f"multi-rank vs plain eval on the serving weights: rows "
                 f"equal {same}, {valid} valid, AP {worst:.3e} apart")
        out["eval"].update(multi_map=aps["multi"][1],
                           serving_map=aps["plain"][1], ap_diff=worst,
                           valid=valid)
    if native.fallbacks:
        fail(f"{native.fallbacks} fall-throughs from the native library")
    return out


def phase_host_split(batch: int = TIMING_TRAIN_BATCH) -> dict:
    """`utils.metrics.profiler_trace` around HOST_SPLIT_STEPS ResNet-34
    train steps (bf16, batch 32, dropout 0.4, frozen trunk): the host's ms
    per step split into kernel launches (the CUDA runtime's launch calls),
    the loss's host sync, the optimizer step, the rest of the aten
    operators' own host time, and Python (the step's wall time that no
    profiled operator or runtime call covers); beside the device ops'
    busy time.  The window's step time without the profiler is given
    too."""
    import tempfile
    from torch.autograd import DeviceType
    from objectdetection_ssd_torch.config import OptimConfig
    from objectdetection_ssd_torch.ops.priors import resnet34_priors
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state
    from objectdetection_ssd_torch.utils.metrics import profiler_trace

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(SEED + 15)
    b = {k: v.to(dev) for k, v in
         synthetic_batch(batch, gen, RESNET_SIZE).items()}
    priors = torch.tensor(resnet34_priors(), device=dev)
    state = create_train_state(resnet_config(compute_dtype="bfloat16"),
                               OptimConfig(), device=dev,
                               state_dict=seeded_resnet_state_dict())
    for _ in range(3):
        train_step(state, b, priors, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_SPLIT_STEPS):
        train_step(state, b, priors, seed=SEED)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / HOST_SPLIT_STEPS * 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as tmp:
        with profiler_trace(tmp) as prof:
            t0 = time.perf_counter()
            for _ in range(HOST_SPLIT_STEPS):
                train_step(state, b, priors, seed=SEED)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / HOST_SPLIT_STEPS * 1e3
    events = prof.key_averages()
    per = 1e3 * HOST_SPLIT_STEPS
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launch = sum(e.self_cpu_time_total for e in cpu
                 if e.key in LAUNCH_EVENTS) / per
    sync = sum(e.cpu_time_total for e in cpu if e.key in SYNC_EVENTS) / per
    copy = sum(e.self_cpu_time_total for e in cpu
               if e.key in COPY_EVENTS) / per
    optim = sum(e.cpu_time_total for e in cpu
                if e.key.startswith(OPTIMIZER_PREFIX)) / per
    aten = sum(e.self_cpu_time_total for e in cpu
               if e.key.startswith("aten::")) / per
    covered = sum(e.self_cpu_time_total for e in cpu
                  if not e.key.startswith(OPTIMIZER_PREFIX)) / per
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type != DeviceType.CPU) / per
    top = sorted(((e.self_cpu_time_total / per, e.key) for e in cpu),
                 reverse=True)[:8]
    return {"plain_step_ms": plain_ms, "wall_ms": wall_ms,
            "launch_ms": launch,
            "launches": sum(e.count for e in cpu
                            if e.key in LAUNCH_EVENTS) / HOST_SPLIT_STEPS,
            "sync_ms": sync, "copy_ms": copy,
            "copies": sum(e.count for e in cpu
                          if e.key in COPY_EVENTS) / HOST_SPLIT_STEPS,
            "syncs": sum(e.count for e in cpu
                         if e.key in SYNC_EVENTS) / HOST_SPLIT_STEPS,
            "optimizer_ms": optim, "aten_self_ms": aten,
            "python_ms": wall_ms - covered, "device_ms": device_ms,
            "top": top}


def phase_doctor() -> dict:
    """`cli doctor --json` on the card: healthy, with this card's name."""
    import io
    from objectdetection_ssd_torch import cli
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["doctor", "--json"])
    payload = json.loads(text.getvalue().strip().splitlines()[-1])
    if (rc != 0 or payload["status"] != "healthy"
            or payload["device_name"] != torch.cuda.get_device_name(0)
            or payload["device_count"] != torch.cuda.device_count()):
        fail(f"cli doctor rc {rc}: {payload}")
    return payload


# ------------------------------------------------------------ pipeline (PP)

# The PP step on one card (every stage on cuda:0) against the monolithic
# step from the same weights and batch, cuDNN deterministic: the same
# convs on the same rows, so the gradients are bit-equal at M = 1 (as on
# the CPU, tests/test_torch_pp.py); dp = 2 splits each microbatch's rows,
# so its convs run at other batch sizes (other cuDNN algorithms) and its
# filter gradients are sums of two halves: held to this of the largest
# (measured by this script on an H100 80GB HBM3 at 700 W: 1.45e-5).
PP_GRAD_TOL = 1e-4
# The 3- and 4-stage forwards against the monolith (tests/test_torch_pp.py).
PP_FORWARD_TOL = 1e-5
# bf16 timing of the PP step beside the monolithic one: windows in turns.
PP_TIMING_WINDOWS = 3
PP_TIMING_STEPS = 5
PP_TIMING_MICROBATCHES = (1, 4)
# The PP Trainer epoch's fixture (train, val images) and batch.
PP_FIXTURE = (64, 16)
PP_TRAINER_BATCH = 16


def _pp_step(device, model_config, init_sd, batch, priors, stages: int = 2,
             microbatches: int = 1, dp: int = 1, optim=None):
    """One `make_pp_steps` train step from ``init_sd`` with every stage on
    ``device``: (state, metrics as floats, the runner)."""
    from objectdetection_ssd_torch.config import OptimConfig
    from objectdetection_ssd_torch.parallel.pipeline import build_pipeline_for
    from objectdetection_ssd_torch.train.loop import make_pp_steps
    from objectdetection_ssd_torch.train.state import create_train_state
    state = create_train_state(model_config, optim or OptimConfig(),
                               device=device, state_dict=init_sd)
    runner = build_pipeline_for(state.model, stages,
                                [device] * (stages * dp), microbatches, dp)
    step, _ = make_pp_steps(runner, priors)
    state, metrics = step(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}, runner


def _grads(state) -> dict:
    return {n: p.grad.detach().float().cpu()
            for n, p in state.model.named_parameters()}


def _grad_rel(got: dict, want: dict) -> tuple:
    """(the worst |got - want| over the largest |want| per tensor, its
    name, whether every tensor is bit-equal)."""
    rows = [(float((got[n] - w).abs().max() / w.abs().max()), n)
            for n, w in want.items() if w.abs().max() > 0]
    worst = max(rows)
    return worst[0], worst[1], all(torch.equal(got[n], w)
                                   for n, w in want.items())


def pp_timing(device, init_sd, batch, priors) -> dict:
    """bf16 batch-32 steps, the monolithic `train_step` and the 2-stage PP
    step at each of `PP_TIMING_MICROBATCHES`, every stage on the one card:
    ms per step (median of windows in turns) and the peak memory of one
    step above the state's."""
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.parallel.pipeline import build_pipeline_for
    from objectdetection_ssd_torch.train.loop import (make_pp_steps,
                                                      train_step)
    from objectdetection_ssd_torch.train.state import create_train_state
    cfg = ModelConfig(compute_dtype="bfloat16")
    steps = {}
    for key in ["mono"] + [f"pp_m{m}" for m in PP_TIMING_MICROBATCHES]:
        state = create_train_state(cfg, OptimConfig(), device=device,
                                   state_dict=init_sd)
        if key == "mono":
            fn = (lambda st: lambda b: train_step(st, b, priors))(state)
        else:
            runner = build_pipeline_for(state.model, 2, [device] * 2,
                                        int(key[4:]))
            pp_train, _ = make_pp_steps(runner, priors)
            fn = (lambda st, f: lambda b: f(st, b))(state, pp_train)
        fn(batch)                                           # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(batch)
        torch.cuda.synchronize()
        steps[key] = {"fn": fn, "windows_ms": [],
                      "peak_mb": (torch.cuda.max_memory_allocated() - base)
                      / 2**20}
    for _ in range(PP_TIMING_WINDOWS):
        for key, row in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PP_TIMING_STEPS):
                _, metrics = row["fn"](batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            row["windows_ms"].append((time.perf_counter() - t0)
                                     / PP_TIMING_STEPS * 1e3)
    out = {}
    for key, row in steps.items():
        ms = statistics.median(row["windows_ms"])
        out[key] = {"step_ms": ms, "windows_ms": row["windows_ms"],
                    "images_per_s": batch["images"].shape[0] / ms * 1e3,
                    "peak_mb": row["peak_mb"]}
    return out


def pp_trainer(device, fixture=PP_FIXTURE,
               batch_size: int = PP_TRAINER_BATCH, workers: int = 2) -> dict:
    """One `Trainer.fit` epoch of SSD300 under PP (2 stages, M = 2, every
    stage on ``device``) on a `write_fixture` VOCdevkit; a monolithic
    Trainer resumes its checkpoint to bit-equal parameters.  Then `cli
    train --pp 2` on the same fixture: with fewer cards than stages it
    must exit with the device message, not fall back."""
    import io
    import tempfile

    from objectdetection_ssd_torch import cli
    from objectdetection_ssd_torch.config import (Config, DataConfig,
                                                  TrainConfig)
    from objectdetection_ssd_torch.data.pipeline import Loader
    from objectdetection_ssd_torch.train.trainer import Trainer

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        root, prefix = f"{tmp}/VOCdevkit", f"{tmp}/cache"
        train_recs, val_recs = write_fixture(root, prefix, *fixture)
        loaders = []

        def trainer(pp: int):
            cfg = Config(
                data=DataConfig(voc_root=root, batch_size=batch_size,
                                num_workers=workers, image_cache=prefix),
                train=TrainConfig(checkpoint_dir=f"{tmp}/ckpt",
                                  log_every_steps=0, seed=SEED,
                                  pp_stages=pp, pp_microbatches=2))
            lds = (Loader(train_recs, cfg.data, 300, train=True, seed=SEED,
                          cache_path=prefix),
                   Loader(val_recs, cfg.data, 300, train=False,
                          drop_last=False, cache_path=prefix + ".val"))
            loaders.extend(lds)
            return Trainer(cfg, *lds, device=device,
                           pp_devices=[device] * 2 if pp else None)

        try:
            t0 = time.perf_counter()
            pp = trainer(2)
            pp.fit(1)
            if device.type == "cuda":
                torch.cuda.synchronize()
            out["fit_s"] = time.perf_counter() - t0
            out["history"] = pp.history
            out["stats"] = pp.phase_stats
            history = pp.history["train"] + pp.history["test"]
            if not all(math.isfinite(x) for x in history):
                fail(f"PP trainer: history {pp.history}")
            params = {n: p.detach().clone() for n, p in
                      pp.state.model.named_parameters()}
            mono = trainer(0)
            if not (mono.maybe_resume() and mono.start_epoch == 1
                    and mono.state.step == pp.state.step):
                fail("PP trainer: the monolithic Trainer did not resume "
                     "the PP checkpoint")
            if any(not torch.equal(p.detach(), params[n]) for n, p in
                   mono.state.model.named_parameters()):
                fail("PP trainer: the checkpoint does not reload to the PP "
                     "run's parameters")
        finally:
            for loader in loaders:
                loader.close()
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if device.type == "cuda" and n_cards < 2:
            want = (f"--pp 2 x --pp-dp 1 needs 2 devices; {n_cards} "
                    "available")
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(["train", "--pp", "2", "--voc-root", root,
                              "--checkpoint-dir", f"{tmp}/cli", "--epochs",
                              "1", "--num-workers", "0"])
                fail("cli train --pp 2 ran on one card")
            except SystemExit as e:
                if str(e) != want:
                    fail(f"cli train --pp 2 exited with {e!r}")
            out["cli_exit"] = want
        else:
            out["cli_exit"] = None
    return out


def phase_pp(device, batch: int = TRAIN_BATCH,
             timing_batch: int = TIMING_TRAIN_BATCH, **trainer_kw) -> dict:
    """Pipeline parallelism (`parallel/pipeline.py`) with every stage on
    the one card, cuDNN deterministic: the f32 2-stage M = 1 step against
    the monolithic step, M = 2 against two grad-accum micro-steps, the 3-
    and 4-stage forwards against the monolith, dp = 2 against dp = 1, one
    routed step (K2 counted: 4 per microbatch; its dW against the
    unrouted step's), the bf16 batch-32 PP step's time and peak memory
    beside the monolithic step's at M = 1 and 4, one `Trainer.fit` epoch
    under PP whose checkpoint a monolithic Trainer resumes, and `cli train
    --pp 2` refused on one card."""
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops.priors import ssd300_priors
    from objectdetection_ssd_torch.parallel.pipeline import build_pipeline_for
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state

    cuda = device.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 30)
    b = {k: v.to(device) for k, v in synthetic_batch(batch, gen).items()}
    priors = torch.tensor(ssd300_priors(), device=device)
    init_sd = train_init_state_dict()
    f32 = ModelConfig()
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # M = 1 against the monolithic step.
        state = create_train_state(f32, OptimConfig(), device=device,
                                   state_dict=init_sd)
        state, metrics = train_step(state, b, priors)
        mono_loss, mono_grads = float(metrics["loss"]), _grads(state)
        del state
        state, m, _ = _pp_step(device, f32, init_sd, b, priors)
        rel, name, equal = _grad_rel(_grads(state), mono_grads)
        out["m1"] = {"grad_rel": rel, "worst": name, "bit_equal": equal,
                     "loss_equal": m["loss"] == mono_loss}
        if not (rel <= 1e-6 and abs(m["loss"] - mono_loss)
                <= 1e-6 * abs(mono_loss)):
            fail(f"PP M=1 step vs monolithic: gradients {rel:.3e} of the "
                 f"largest ({name}), loss {m['loss']} vs {mono_loss}")
        del state

        # M = 2 against two grad-accum micro-steps of the halves.
        state, m, _ = _pp_step(device, f32, init_sd, b, priors,
                               microbatches=2)
        acc = create_train_state(f32, OptimConfig(grad_accum_steps=2),
                                 device=device, state_dict=init_sd)
        half = batch // 2
        losses = []
        for rows in (slice(0, half), slice(half, batch)):
            acc, am = train_step(acc, {k: v[rows] for k, v in b.items()},
                                 priors)
            losses.append(float(am["loss"]))
        loss_rel = abs(m["loss"] - sum(losses) / 2) / abs(sum(losses) / 2)
        rows = change_rows(dict(state.model.named_parameters()),
                           {n: p.detach().cpu() for n, p in
                            acc.model.named_parameters()}, init_sd)
        out["m2"] = {"loss_rel": loss_rel, "delta_rel": rows[0][0],
                     "delta_worst": rows[0][2],
                     "delta_norm_rel": max(r[1] for r in rows)}
        if not (loss_rel <= TRAIN_LOSS_RTOL
                and out["m2"]["delta_rel"] <= TRAIN_DELTA_TOL
                and out["m2"]["delta_norm_rel"] <= TRAIN_DELTA_NORM_TOL):
            fail(f"PP M=2 step vs grad-accum micro-steps: {out['m2']}")
        del state, acc

        # The 3- and 4-stage forwards against the monolith.
        model = create_train_state(f32, OptimConfig(), device=device,
                                   state_dict=init_sd).model
        with torch.no_grad():
            want = [t.cpu() for t in model(b["images"])]
        out["forward_rel"] = {}
        for n in (3, 4):
            runner = build_pipeline_for(model, n, [device] * n, 1)
            got = runner.forward(b["images"])
            out["forward_rel"][n] = rel_diff(got, want)
            if not out["forward_rel"][n] <= PP_FORWARD_TOL:
                fail(f"PP {n}-stage forward vs monolith: "
                     f"{out['forward_rel'][n]:.3e} of the largest")
        del model, runner

        # dp = 2 against dp = 1.
        state, m, _ = _pp_step(device, f32, init_sd, b, priors, dp=2)
        rel, name, _ = _grad_rel(_grads(state), mono_grads)
        loss_rel = abs(m["loss"] - mono_loss) / abs(mono_loss)
        out["dp2"] = {"grad_rel": rel, "worst": name, "loss_rel": loss_rel}
        if not (rel <= PP_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL):
            fail(f"PP dp=2 vs dp=1: gradients {rel:.3e} of the largest "
                 f"({name}), loss {loss_rel:.3e} relative")
        del state

        # The routed step, M = 2: K2's launches and its dW.
        unrouted, um, _ = _pp_step(device, f32, init_sd, b, priors,
                                   microbatches=2)
        want = _grads(unrouted)
        del unrouted
        # The main path: counts set to 0 just before, read just after.
        dw_cuda.launches = 0
        state, rm, runner = _pp_step(device, ModelConfig(
            dw_pallas_convs=ROUTED), init_sd, b, priors, microbatches=2)
        if cuda:
            torch.cuda.synchronize()
        out["k2"] = dw_cuda.launches
        if cuda and out["k2"] != 4 * 2:
            fail(f"K2 launched {out['k2']} times in a routed PP step of 2 "
                 f"microbatches")
        if not all(getattr(runner.stages[0].trunk, n).dw_route
                   for n in ROUTED):
            fail("the PP stages lost the K2 route")
        got = _grads(state)
        out["k2_wgrad_rel"] = max(
            float((got[f"trunk.{n}.weight"] - want[f"trunk.{n}.weight"])
                  .abs().max() / want[f"trunk.{n}.weight"].abs().max())
            for n in ROUTED)
        if not out["k2_wgrad_rel"] <= WGRAD_TOL:
            fail(f"PP routed dW vs the unrouted step's: "
                 f"{out['k2_wgrad_rel']:.3e}")
        del state, runner
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if cuda:
        torch.cuda.empty_cache()
        tb = {k: v.to(device) for k, v in
              synthetic_batch(timing_batch, gen).items()}
        out["timing"] = pp_timing(device, init_sd, tb, priors)
        del tb
        torch.cuda.empty_cache()
    out["trainer"] = pp_trainer(device, **trainer_kw)
    return out


# Phase "api": the JAX package's remaining public names (the package-level
# imports, the legacy box ops, the two-stage pipeline, create_global_mesh).
API_NMS_SETS = (8, 200)      # mixed_class_nms: 8 sets of a serving top-200
API_SHUFFLE_BATCH = 8        # the (y, x, y, x) shuffles over SSD300's priors
API_DECODE_BATCH = 256       # decode_tanh over the 189 zoom/ratio priors
API_GT_BOXES = 24            # pairwise_iou_rescaled: raw GT per image
# Card floats against the CPU's: tanh and the IoU's division may round an
# ulp apart; every value is at most ~1.5.
API_FLOAT_TOL = 1e-6


def api_box_inputs(gen: torch.Generator) -> dict:
    """Inputs of the legacy box ops at serving sizes, drawn from ``gen`` on
    the CPU; probabilities on a 1/20 grid, so that ties occur."""
    from objectdetection_ssd_torch.ops.boxes import cxcywh_to_xyxy
    from objectdetection_ssd_torch.ops.priors import (ssd300_priors,
                                                      zoom_ratio_priors)
    b, n = API_NMS_SETS
    ctr = torch.rand(b, n, 2, generator=gen) * 0.6 + 0.2
    wh = torch.rand(b, n, 2, generator=gen) * 0.35 + 0.05
    priors = torch.tensor(ssd300_priors())
    zoom, grid = zoom_ratio_priors(reference_order=False)
    sizes = torch.randint(200, 641, (API_SHUFFLE_BATCH, 1, 2),
                          generator=gen).float()
    lo = torch.rand(API_SHUFFLE_BATCH, API_GT_BOXES, 2, generator=gen) * 0.6
    hi = lo + torch.rand(API_SHUFFLE_BATCH, API_GT_BOXES, 2,
                         generator=gen) * 0.35 + 0.05
    return {
        "nms": (torch.cat([ctr - wh / 2, ctr + wh / 2], -1),
                torch.randint(0, 20, (b, n), generator=gen),
                torch.randint(1, 21, (b, n), generator=gen) / 20.0),
        "boxes": torch.rand(API_SHUFFLE_BATCH, *priors.shape, generator=gen),
        "tanh": (torch.randn(API_DECODE_BATCH, *zoom.shape, generator=gen)
                 * 1.5, torch.tensor(zoom), torch.tensor(grid)),
        "rescaled": (torch.cat([lo, hi], -1) * sizes.repeat(1, 1, 2), sizes,
                     cxcywh_to_xyxy(priors).expand(API_SHUFFLE_BATCH, -1,
                                                   -1) * 300.0),
    }


def api_box_ops(inputs: dict, device) -> dict:
    """Each legacy box op of `ops/boxes.py` on ``inputs`` moved to
    ``device``; the results on the CPU."""
    from objectdetection_ssd_torch.ops import boxes

    def on(*ts):
        return [t.to(device) for t in ts]

    xyxy, classes, probs = on(*inputs["nms"])
    pred, zoom, grid = on(*inputs["tanh"])
    raw, sizes, other = on(*inputs["rescaled"])
    (b,) = on(inputs["boxes"])
    out = {"mixed_class_nms": boxes.mixed_class_nms(xyxy, classes, probs,
                                                    0.45),
           "decode_tanh": boxes.decode_tanh(pred, zoom, grid),
           "pairwise_iou_rescaled (one size)": boxes.pairwise_iou_rescaled(
               raw[0], sizes[0, 0], other[0]),
           "pairwise_iou_rescaled (per image)":
               boxes.pairwise_iou_rescaled(raw, sizes, other)}
    for fn in ("xyxy_to_yxyx", "yxyx_to_xyxy", "cxcywh_to_yxyx",
               "yxyx_to_cxcywh"):
        out[fn] = getattr(boxes, fn)(b)
    return {k: v.cpu() for k, v in out.items()}


def phase_api(device, batch: int = TRAIN_BATCH) -> dict:
    """The JAX package's remaining public names in the port, on the card:
    the package-level imports; each legacy box op on CUDA tensors against
    its CPU result (masks and shuffles equal, floats within
    API_FLOAT_TOL); `create_global_mesh` with no process group up (a
    one-rank ``data`` mesh); the two-stage `build_ssd300_pipeline` on
    [card, card] against the monolithic SSD300 f32 forward at ``batch``,
    cuDNN deterministic: bit-equal; and ``devices=None`` refused on fewer
    than two cards, with no CPU fallback."""
    import objectdetection_ssd_torch as pkg
    from objectdetection_ssd_torch import config
    from objectdetection_ssd_torch.models.ssd import build_model
    from objectdetection_ssd_torch.ops.priors import ssd_paper_scale
    from objectdetection_ssd_torch.parallel import distributed, mesh
    from objectdetection_ssd_torch.parallel.pipeline import (
        SSD300HeadStage, SSD300TrunkStage, build_ssd300_pipeline)

    t0 = time.perf_counter()
    out = {}
    if pkg.Config is not config.Config or pkg.__version__ != "0.3.0":
        fail("api: the package-level names are not the submodules'")
    if [ssd_paper_scale(k) for k in range(1, 7)] != [
            0.2, 0.34, 0.48, 0.62, 0.76, 0.9]:
        fail("api: ssd_paper_scale(1..6)")

    inputs = api_box_inputs(torch.Generator().manual_seed(SEED + 40))
    got = api_box_ops(inputs, device)
    want = api_box_ops(inputs, torch.device("cpu"))
    out["boxes"] = {}
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"api: {name} gave {tuple(g.shape)} {g.dtype} on the card, "
                 f"{tuple(w.shape)} {w.dtype} on the CPU")
        err = 0.0 if not w.is_floating_point() else float(
            (g - w).abs().max())
        if not w.is_floating_point() or name in ("xyxy_to_yxyx",
                                                 "yxyx_to_xyxy"):
            ok = torch.equal(g, w)
        else:
            ok = err <= API_FLOAT_TOL and bool(torch.isfinite(g).all())
        if not ok:
            fail(f"api: {name} on the card differs from the CPU ({err:.3e})")
        out["boxes"][name] = err
    out["suppressed"] = int((~got["mixed_class_nms"]).sum())

    if torch.distributed.is_initialized():
        fail("api: a process group is up before create_global_mesh")
    m = distributed.create_global_mesh(device_type=device.type)
    if m.mesh_dim_names != ("data",) or mesh.data_shard(m) != (0, 1):
        fail(f"api: create_global_mesh gave {m}")
    out["mesh"] = str(m)

    model = build_model(config.ModelConfig(), device="cpu",
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(device)
    x = torch.randint(0, 256, (batch, 300, 300, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(SEED + 41)
                      ).to(device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            mono = model(x)
        runner = build_ssd300_pipeline(model, devices=[device, device])
        if [type(s) for s in runner.stages] != [SSD300TrunkStage,
                                                SSD300HeadStage]:
            fail(f"api: the pipeline's stages are {runner.stages}")
        piped = runner.forward(x)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["pipeline_bit_equal"] = all(torch.equal(p, w)
                                    for p, w in zip(piped, mono))
    out["pipeline_rel"] = rel_diff(piped, [t.cpu() for t in mono])
    if not out["pipeline_bit_equal"]:
        fail(f"api: the two-stage pipeline's forward differs from the "
             f"monolith's by {out['pipeline_rel']:.3e} of the largest")
    cards = torch.cuda.device_count()
    if cards < 2:
        try:
            build_ssd300_pipeline(model)
        except RuntimeError as e:
            out["default_devices"] = str(e)
        else:
            fail(f"api: build_ssd300_pipeline took devices=None on {cards} "
                 f"card(s)")
    else:
        out["default_devices"] = f"{cards} cards: not checked"
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    return out


# ------------------------------------------------------------- quality

# Leg (b), `benchmarks/quality_ab.py`'s recipe through the port's CLI: a
# 1200 + 200 image class-colour-coded VOC at 400x300 with up to 4 objects,
# SSD300 trained in bf16 at batch 64, lr 5e-4, 300 warmup steps, no
# decay, on the Loader's 8 workers; then 5 QAT epochs at lr 1e-4 on a
# copy of the checkpoint directory.
QUALITY_FIXTURE = (1200, 200)
QUALITY_IMAGE_SIZE = (400, 300)
QUALITY_MAX_OBJECTS = 4
QUALITY_BATCH = 64
QUALITY_WORKERS = 8
# 30 epochs fit ~180 s on the H100 (the card's mAP ladder, every 5 epochs
# of 50: 0.00, 0.08, 0.25, 0.31, 0.59, 0.59, 0.63, 0.66, 0.68, 0.67).
QUALITY_EPOCHS = 30
QUALITY_QAT_EPOCHS = 5
QUALITY_MAP_EVERY = 10
# The gates, fixed before the first run: the base mAP and its gain over
# the untrained weights, and each variant's margin below the base.
QUALITY_BASE_MAP = 0.4
QUALITY_BASE_GAIN = 0.3
QUALITY_MARGINS = {"int8": 0.02, "int8 heads quantized": 0.03,
                   "tta flip": 0.02, "soft-nms gaussian": 0.02}
QUALITY_QAT_MARGIN = 0.005


def learnability_module():
    """`tests/test_torch_learnability.py`, whose recipes and gates leg (a)
    runs (it imports no JAX at its top)."""
    import importlib.util
    path = (Path(__file__).resolve().parent / "tests"
            / "test_torch_learnability.py")
    spec = importlib.util.spec_from_file_location("test_torch_learnability",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_quality_toy(device) -> dict:
    """Leg (a): the three learnability recipes of
    `tests/test_torch_learnability.py` on ``device`` with their gates, the
    fixtures written into packed caches.  K1 and K3 are counted around
    every mAP measurement: K1 launches in each hard-NMS one and not in
    Soft-NMS, K3 in each int8 one and in no other; the QAT steps are
    counted through the fake-quant path on the card."""
    mod = learnability_module()
    fixture = {k: v for k, v in mod.FIXTURE.items()
               if k != "class_color_coding"}
    out = {}
    # The toys train under PyTorch's default conv numerics (cuDNN TF32,
    # which this script turns off elsewhere for its bit-level checks), as
    # leg (b)'s QAT fine-tune does, and with cuDNN's deterministic
    # algorithms, so that a recipe gives the same mAPs in every run, as on
    # the CPU.  Each gate is one trajectory's: two card runs with the
    # default algorithms put the variants recipe's int8 at +0.0016 and
    # -0.0249 of its base, and TF32 off with deterministic algorithms its
    # TTA at -0.0155 (JAX's gate: -0.005; `PERF.md`, PR 16).
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for key, (recipe, failures) in mod.RECIPES.items():
            out[key] = _quality_toy_recipe(device, mod, key, recipe,
                                           failures, fixture)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32) = flags
    return out


def _quality_toy_recipe(device, mod, key: str, recipe, failures,
                        fixture: dict) -> dict:
    """One recipe of leg (a) on a `write_fixture` cache, with K1 and K3
    counted around each mAP measurement and the QAT steps counted."""
    import os
    import tempfile

    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.ops import int8_conv as k3

    cuda = device.type == "cuda"
    counts = {}

    def measure(name, *args, **kwargs):
        nms_cuda.launches = 0
        k3.launches = 0
        value = mod.map_variant(name, *args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        counts[name] = (nms_cuda.launches, k3.launches)
        return value

    qat_steps = []
    train_step = mod.loop_lib.train_step

    def counted_step(state, batch, priors, *args, quant_ste=None, **kw):
        if quant_ste is not None:
            qat_steps.append(next(state.model.parameters()).device.type)
        return train_step(state, batch, priors, *args, quant_ste=quant_ste,
                          **kw)

    mod.loop_lib.train_step = counted_step
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_toy_") as tmp:
            prefix = os.path.join(tmp, "cache")
            records, _ = write_fixture(
                os.path.join(tmp, "VOCdevkit"), prefix, seed=mod.SEEDS[key],
                split=False, **fixture)
            result = recipe(records, device, cache_path=prefix,
                            measure=measure)
    finally:
        mod.loop_lib.train_step = train_step
    result["seconds"] = time.perf_counter() - t0
    result["launches"] = counts
    bad = failures(result)
    for name, (k1, k3n) in counts.items():
        soft = name == "soft_nms"
        int8 = name.startswith("int8")
        if cuda and ((k1 > 0) == soft or (k3n > 0) != int8):
            bad.append(f"{name}: K1 {k1}, K3 {k3n} launches")
    if key == "qat":
        want = mod.QAT_EPOCHS * len(records) // mod.DATA.batch_size
        result["qat_steps"] = len(qat_steps)
        if len(qat_steps) != want or set(qat_steps) != {device.type}:
            bad.append(f"QAT steps {len(qat_steps)} on {set(qat_steps)}, "
                       f"want {want} on {device.type}")
    if bad:
        fail(f"quality toy {key}: {bad} ({result})")
    return result


def phase_quality_ssd300(device, fixture=QUALITY_FIXTURE,
                         image_size=QUALITY_IMAGE_SIZE,
                         batch: int = QUALITY_BATCH,
                         workers: int = QUALITY_WORKERS,
                         epochs: int = QUALITY_EPOCHS,
                         qat_epochs: int = QUALITY_QAT_EPOCHS,
                         map_every: int = QUALITY_MAP_EVERY) -> dict:
    """Leg (b): SSD300 at full width trained by `cli train` in-process on
    a `write_fixture` VOC (``benchmarks/quality_ab.py``'s recipe, image
    reads from the packed caches), then the val split through
    `evaluate_records` with the exact postprocess on one Detector per
    variant: f32 (the base), bf16, int8 PTQ with the heads f32 and the
    requant chain (`cli`'s `--int8` default), int8 with the heads
    quantized, flip TTA, Soft-NMS Gaussian, and int8 served after
    ``train --qat`` on a copy of the checkpoint directory.  K1 and K3 are
    counted around each evaluation.  The gates are checked by the
    caller."""
    import io
    import os
    import tempfile

    from objectdetection_ssd_torch import cli
    from objectdetection_ssd_torch.config import (Config, DataConfig,
                                                  ModelConfig, QuantConfig,
                                                  TrainConfig)
    from objectdetection_ssd_torch.data import cache
    from objectdetection_ssd_torch.data import pipeline as data_pipeline
    from objectdetection_ssd_torch.eval.evaluate import (
        evaluate_records, exact_eval_postprocess)
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer import quant as quant_lib
    from objectdetection_ssd_torch.infer.detector import (Detector,
                                                         checkpoint_weights)
    from objectdetection_ssd_torch.ops import int8_conv as k3
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager

    cuda = device.type == "cuda"
    out = {"epochs": epochs, "qat_epochs": qat_epochs}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        prefix = os.path.join(tmp, "cache")
        ckpt = os.path.join(tmp, "ckpt")
        ckpt_qat = os.path.join(tmp, "ckpt_qat")
        t0 = time.perf_counter()
        train_recs, val_recs = write_fixture(
            root, prefix, *fixture, image_size=image_size,
            max_objects=QUALITY_MAX_OBJECTS)
        out["fixture_s"] = time.perf_counter() - t0
        out["train_images"], out["val_images"] = (len(train_recs),
                                                  len(val_recs))
        index = {r.image_path: (prefix, i) for i, r in enumerate(train_recs)}
        index.update({r.image_path: (prefix + ".val", i)
                      for i, r in enumerate(val_recs)})
        common = ["--voc-root", root, "--batch-size", str(batch),
                  "--num-workers", str(workers), "--image-cache", prefix,
                  "--bf16"] + ([] if cuda else ["--device", "cpu"])

        def run(argv) -> str:
            text, err = io.StringIO(), io.StringIO()
            try:
                with contextlib.redirect_stdout(text), \
                        contextlib.redirect_stderr(err):
                    rc = cli.main(argv)
            except SystemExit as e:
                raise SystemExit(f"cli {argv[0]}: {e} "
                                 f"{err.getvalue()[-300:]}") from e
            if rc != 0:
                fail(f"cli {argv[0]} rc {rc}: {text.getvalue()[-300:]}")
            return text.getvalue() + err.getvalue()

        cfg = Config(data=DataConfig(voc_root=root, batch_size=batch,
                                     num_workers=0),
                     train=TrainConfig(checkpoint_dir=ckpt))
        pp = exact_eval_postprocess(cfg.postprocess)

        def evaluate(name, weights, config=cfg, postprocess=pp,
                     quant=None) -> float:
            det = Detector(config, weights, postprocess_config=postprocess,
                           quant=quant, device=device)
            nms_cuda.launches = 0
            k3.launches = 0
            t = time.perf_counter()
            _, mean_ap = evaluate_records(config, None, val_recs,
                                          detector=det,
                                          image_cache=prefix + ".val")
            if cuda:
                torch.cuda.synchronize()
            out.setdefault("variants", {})[name] = {
                "map": mean_ap, "images": len(val_recs),
                "seconds": time.perf_counter() - t,
                "k1": nms_cuda.launches, "k3": k3.launches,
                "int8_convs": (None if quant is None
                               else quant_lib.count_quantized(quant))}
            return mean_ap

        def int8_tree(config, weights, heads=False):
            qcfg = config.replace(quant=QuantConfig(
                int8=True, quantize_heads=heads))
            return cli._build_quant(qcfg, weights, device,
                                    records=train_recs)

        load_image = data_pipeline.load_image
        data_pipeline.load_image = lambda p: cache.get_image(*index[p])
        try:
            untrained, _ = checkpoint_weights(
                cfg, os.path.join(tmp, "empty"), allow_random_init=True)
            out["untrained_map"] = evaluate("untrained", untrained)
            del out["variants"]["untrained"]
            t0 = time.perf_counter()
            log = run(["train", *common, "--checkpoint-dir", ckpt,
                       "--epochs", str(epochs), "--lr", "5e-4",
                       "--warmup-steps", "300", "--no-lr-decay",
                       "--eval-map-every", str(map_every)])
            out["train_s"] = time.perf_counter() - t0
            out["ladder"] = {int(e): float(m) for e, m in re.findall(
                r"epoch (\d+): val mAP = ([0-9.]+)", log)}
            _, meta, epoch = CheckpointManager(ckpt).load()
            out["history"] = meta.get("history")
            out["train_epoch"] = epoch
            out["steps_per_epoch"] = len(train_recs) // batch
            weights, _ = checkpoint_weights(cfg)
            base = evaluate("f32", weights)
            evaluate("bf16", weights, config=cfg.replace(
                model=ModelConfig(compute_dtype="bfloat16")))
            qtree = int8_tree(cfg, weights)
            evaluate("int8", weights, quant=qtree)
            evaluate("int8 heads quantized", weights,
                     quant=int8_tree(cfg, weights, heads=True))
            evaluate("tta flip", weights,
                     postprocess=dataclasses.replace(pp, tta_flip=True))
            evaluate("soft-nms gaussian", weights,
                     postprocess=dataclasses.replace(
                         pp, nms_method="soft_gaussian"))
            shutil.copytree(ckpt, ckpt_qat)
            t0 = time.perf_counter()
            # The fake-quant convs run in f32: under PyTorch's default
            # cuDNN TF32 here, which this script turns off elsewhere for
            # its bit-level checks.
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                run(["train", *common, "--checkpoint-dir", ckpt_qat,
                     "--epochs", str(epochs + qat_epochs), "--resume",
                     "--qat", "--lr", "1e-4", "--no-lr-decay"])
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            out["qat_s"] = time.perf_counter() - t0
            cfg_qat = cfg.replace(train=TrainConfig(checkpoint_dir=ckpt_qat))
            weights_q, _ = checkpoint_weights(cfg_qat)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                qtree_q = int8_tree(cfg_qat, weights_q)
            if "using QAT-trained scales" not in err.getvalue():
                fail(f"int8 after QAT did not serve the QAT scales: "
                     f"{err.getvalue()[-300:]}")
            evaluate("int8 after qat", weights_q, config=cfg_qat,
                     quant=qtree_q)
        finally:
            data_pipeline.load_image = load_image
    out["base_map"] = base
    return out


def report_quality(qt: dict, qs: dict, smi: str) -> tuple:
    """Print phase "quality"'s lines: each toy recipe's mAPs, final loss
    and launches, leg (b)'s training and one line per variant.  Returns
    the K1 and K3 launches of the phase's measurements."""
    k1 = k3 = 0
    for key, r in qt.items():
        counts = ", ".join(f"{n} K1 {a} K3 {b}"
                           for n, (a, b) in r["launches"].items())
        maps = ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                         if isinstance(v, float) and k not in ("seconds",
                                                               "loss"))
        print(f"quality toy {key} ({smi}): {maps}; final loss "
              f"{r['loss']:.4f}; launches: {counts}"
              + (f"; {r['qat_steps']} QAT steps on the card"
                 if "qat_steps" in r else "")
              + f"; {r['seconds']:.1f} s")
        k1 += sum(a for a, _ in r["launches"].values())
        k3 += sum(b for _, b in r["launches"].values())
    base = qs["base_map"]
    rate = qs["epochs"] * qs["steps_per_epoch"] * QUALITY_BATCH / qs["train_s"]
    print(f"quality ssd300: fixture {qs['train_images']} train + "
          f"{qs['val_images']} val images at {QUALITY_IMAGE_SIZE[0]}x"
          f"{QUALITY_IMAGE_SIZE[1]} in packed caches "
          f"({qs['fixture_s']:.2f} s); cli train --bf16 batch "
          f"{QUALITY_BATCH}, lr 5e-4, 300 warmup steps, no decay, "
          f"{QUALITY_WORKERS} workers ({smi}): {qs['epochs']} epochs of "
          f"{qs['steps_per_epoch']} steps in {qs['train_s']:.1f} s "
          f"({rate:.1f} images/s with the per-epoch loss eval, checkpoint "
          f"and mAP evals); train loss by epoch "
          f"{[round(x, 3) for x in qs['history']['train']]}; val mAP ladder "
          f"{qs['ladder']}; untrained mAP {qs['untrained_map']:.4f}; "
          f"train --qat {qs['qat_epochs']} epochs in {qs['qat_s']:.1f} s")
    for name, r in qs["variants"].items():
        print(f"quality ssd300 {name}: mAP {r['map']:.4f} (delta "
              f"{r['map'] - base:+.4f} vs f32), {r['images']} images, "
              f"{r['seconds']:.2f} s, K1 {r['k1']}, K3 {r['k3']} ({smi})")
        k1 += r["k1"]
        k3 += r["k3"]
    return k1, k3


def quality_failures(q: dict, batch: int = QUALITY_BATCH) -> list:
    """Leg (b)'s gates, and its launch counts: K1 once per batch of every
    hard-NMS evaluation and never under Soft-NMS; K3 once per quantized
    conv per batch of every int8 evaluation and never elsewhere."""
    v = q["variants"]
    base = q["base_map"]
    bad = []
    if not base >= QUALITY_BASE_MAP:
        bad.append(f"base mAP {base:.4f} < {QUALITY_BASE_MAP}")
    if not base >= q["untrained_map"] + QUALITY_BASE_GAIN:
        bad.append(f"base mAP {base:.4f} < untrained "
                   f"{q['untrained_map']:.4f} + {QUALITY_BASE_GAIN}")
    for name, margin in QUALITY_MARGINS.items():
        if not v[name]["map"] >= base - margin:
            bad.append(f"{name} mAP {v[name]['map']:.4f} < base "
                       f"{base:.4f} - {margin}")
    if not v["int8 after qat"]["map"] >= v["int8"]["map"] - \
            QUALITY_QAT_MARGIN:
        bad.append(f"int8 after QAT {v['int8 after qat']['map']:.4f} < "
                   f"PTQ {v['int8']['map']:.4f} - {QUALITY_QAT_MARGIN}")
    for name, r in v.items():
        batches = -(-r["images"] // batch)
        k1 = 0 if name == "soft-nms gaussian" else batches
        k3n = (r["int8_convs"] or 0) * batches
        if (r["k1"], r["k3"]) != (k1, k3n):
            bad.append(f"{name}: K1 {r['k1']} (want {k1}), K3 {r['k3']} "
                       f"(want {k3n})")
    return bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k1-baseline", type=Path, action="append",
                        default=[],
                        help="another K1 source with the same C interface, "
                             "timed beside the repo's K1 on the same inputs "
                             "(repeatable)")
    parser.add_argument("--k3-baseline", type=Path, action="append",
                        default=[],
                        help="another K3 source with the first K3's C "
                             "interface (ssd_int8_conv with a vec flag), "
                             "timed beside the repo's K3 at each SSD300 "
                             "conv shape on the same inputs (repeatable)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from objectdetection_ssd_torch import cuda_build
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.ops import bias_relu
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops import int8_conv
    from objectdetection_ssd_torch.ops import max_pool

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    # Build from the checkout's sources, not from an earlier build: one
    # nvcc per source, all started together.
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    sources = {"K1": nms_cuda.SOURCE, "K2": dw_cuda.SOURCE,
               "K3": int8_conv.SOURCE, "K4": bias_relu.SOURCE,
               "K5": max_pool.SOURCE}
    for path in args.k1_baseline:
        sources[f"K1 baseline {path.stem}"] = path.resolve()
    for path in args.k3_baseline:
        sources[f"K3 baseline {path.stem}"] = path.resolve()
    t0 = time.perf_counter()
    cuda_build.compile_sources(sources.values())
    nms_cuda.build()
    dw_cuda.build()
    int8_conv.build()
    bias_relu.build()
    max_pool.build()
    build_s = time.perf_counter() - t0
    k1_baselines = {path.stem: k1_library_launcher(path.resolve())
                    for path in args.k1_baseline}
    k3_baselines = {path.stem: k3_library_launcher(path.resolve())
                    for path in args.k3_baseline}
    for kid, src in sources.items():
        rows = ptxas_rows(src)
        print(f"build: {kid} {src.name} (-Xptxas=-v): " + "; ".join(
            f"{short_name(r['function'])} {r['registers']} registers, "
            f"{r['spill_stores']}/{r['spill_loads']} bytes spilled "
            f"(stores/loads)" for r in rows))
        spilled = [short_name(r["function"]) for r in rows
                   if r["spill_stores"] or r["spill_loads"]]
        if not rows or spilled:
            fail(f"{kid}: kernels that spill registers: {spilled}")
    k3_ptx = ptxas_rows(int8_conv.SOURCE)
    for name in int8_conv.TILES:
        r = k3_ptxas(k3_ptx, name)
        print(f"build: K3 {name} ({short_name(r['function'])}): "
              f"{r['registers']} registers, {r['spill_stores']}/"
              f"{r['spill_loads']} bytes spilled")
    k2_rows = ptxas_rows(dw_cuda.SOURCE)
    for n, h, w, cin, cout in DW_SHAPES + dw_shapes(TIMING_TRAIN_BATCH):
        for dtype, aligned in itertools.product(DW_TOL, (True, False)):
            kernel_ptxas(k2_rows, dw_cuda.plan(n, h, w, cin, cout, dtype,
                                               aligned), dtype)
    print(f"build: {', '.join(sources)} in {build_s:.2f} s (parallel "
          f"nvcc), no kernel spills")

    worst = phase_kernel_vs_plain(device)
    print(f"kernel vs plain: K1 keep masks bit-equal on random "
          f"{list(NMS_SHAPES)} with random validity masks and on crafted "
          f"sets (max_abs_err {worst})")

    dw_rows = phase_dw_vs_plain(device)
    for r in dw_rows:
        print(f"kernel vs plain: K2 {r['dtype']} {r['shape']}"
              f"{'' if r['aligned'] else ' unaligned'} "
              f"({r['kernel']} kernel, same bits twice): max_abs_err "
              f"{r['max_abs_err']:.3e}, {r['rel']:.3e} of max|dW| "
              f"{r['scale']:.3e} (tolerance {r['tol']:.0e})")
    dw_worst = max(r["max_abs_err"] for r in dw_rows)

    sd = seeded_state_dict()
    rsd = seeded_resnet_state_dict()
    t_phase = time.perf_counter()
    br = phase_bias_relu(device, sd, rsd)
    det_k4 = "; ".join(f"{k} {v['launches']} launches" for k, v in
                       br["detector"].items())
    print(f"bias-relu kernel: K4 bit-equal to its plain version in "
          f"{br['compared']} comparisons: the {br['shapes']} SSD300 and "
          f"ResNet-34 ReLU'd conv outputs at batch {K4_CHECK_BATCH}, ragged "
          f"C {[s[1] for s in K4_RAGGED]}, an unaligned map, NaN / +-inf / "
          f"-0.0 in y and the bias, bf16 and f32 (max_abs_err "
          f"{br['max_abs_err']}); bf16 loc/conf of one inference forward "
          f"(K4: {det_k4}) bit-equal to the grad-enabled forward's "
          f"(bias in the conv, then F.relu), batch {K4_DETECTOR_BATCH}, "
          f"cuDNN deterministic")
    for r in br["rows"]:
        fused = ("not available: " + r["cudnn_relu_error"]
                 if r["cudnn_relu_ms"] is None
                 else f"{r['cudnn_relu_ms'] * 1e3:.1f} us")
        print(f"bias-relu timing: K4 {r['model']} {r['conv']} {r['shape']} "
              f"bf16 ({smi}): {r['ms'] * 1e3:.1f} us (CUDA graph), bound "
              f"{r['bound_ms'] * 1e3:.1f} us by bytes ({r['share']:.3f} of "
              f"it); plain {r['plain_ms'] * 1e3:.1f} us; add_ + relu "
              f"{r['pair_ms'] * 1e3:.1f} us; bias-free cuDNN conv "
              f"{r['conv_ms'] * 1e3:.1f} us; torch.cudnn_convolution_relu "
              f"{fused}")
    ssd_rows = [r for r in br["rows"] if r["model"] == "ssd300"]
    print(f"bias-relu timing: the {len(ssd_rows)} K4 launches of one "
          f"batch-{K4_TIMING_BATCH} bf16 SSD300 forward ({smi}): "
          f"{sum(r['ms'] for r in ssd_rows):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in ssd_rows):.3f} ms, plain "
          f"{sum(r['plain_ms'] for r in ssd_rows):.3f} ms, add_ + relu "
          f"{sum(r['pair_ms'] for r in ssd_rows):.3f} ms; bias-free cuDNN "
          f"convs {sum(r['conv_ms'] for r in ssd_rows):.3f} ms" + (
              "" if any(r["cudnn_relu_ms"] is None for r in ssd_rows) else
              f", torch.cudnn_convolution_relu "
              f"{sum(r['cudnn_relu_ms'] for r in ssd_rows):.3f} ms"))
    print(f"bias-relu b1: one bf16 SSD300 detect_batch(1) ({smi}): "
          f"{br['b1']['ops']:.1f} device operations per request, "
          f"{br['b1']['k4']:.1f} of them K4, {br['b1']['device_ms']:.3f} "
          f"device ms (torch.profiler, {K4_B1_REQUESTS} requests)")
    print(f"bias-relu host: {br['host_shape']} bf16, host us per call, best "
          f"of 2 turns of {K4_HOST_CALLS} calls ({smi}): " + ", ".join(
              f"{k} {v * 1e3:.2f}" for k, v in br["host_ms"].items())
          + f"; the phase took {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    mp = phase_max_pool(device)
    print(f"max-pool kernel: K5 bit-equal to its plain version (F.max_pool2d"
          f", int8 through f16) in {mp['compared']} comparisons: every pool "
          f"the port serves (SSD300 pools 1-5, the ResNet-34 stem) at batch "
          f"{K5_TIMING_BATCH} in bf16, f32 and int8; ragged C "
          f"{[s[1] for s in K5_RAGGED]} and odd maps at every geometry and "
          f"{len(K5_EXTRA_GEOMETRIES)} more; an unaligned map, a batch, a row "
          f"and a channel slice; NaN / +-inf / +-0.0 (int8: -128, 127) "
          f"(max_abs_err {mp['max_abs_err']})")
    for r in mp["rows"]:
        lib = ("null (no PyTorch call pools int8 on the card)"
               if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.1f} us")
        print(f"max-pool timing: K5 {r['model']} {r['pool']} {r['shape']} "
              f"{r['geometry']} {r['dtype']} ({smi}): {r['ms'] * 1e3:.1f} us "
              f"(CUDA graph), bound {r['bound_ms'] * 1e3:.1f} us by "
              f"{r['bound_by']} ({r['share']:.3f} of it); plain "
              f"{r['plain_ms'] * 1e3:.1f} us; F.max_pool2d {lib}")
    k5_bf16 = [r for r in mp["rows"] if r["model"] == "ssd300"
               and r["dtype"] == str(torch.bfloat16)]
    k5_int8 = [r for r in mp["rows"] if r["model"] == "ssd300"
               and (r["dtype"] == str(torch.int8) or r["pool"] == "pool4")]
    for label, rows in (("bf16", k5_bf16), ("int8 (pool4 bf16)", k5_int8)):
        print(f"max-pool timing: the {len(rows)} K5 launches of one "
              f"batch-{K5_TIMING_BATCH} {label} SSD300 forward ({smi}): "
              f"{sum(r['ms'] for r in rows):.3f} ms, bound "
              f"{sum(r['bound_ms'] for r in rows):.3f} ms, plain "
              f"{sum(r['plain_ms'] for r in rows):.3f} ms")
    print(f"max-pool host: {mp['host_shape']} bf16 3x3/s1/p1, host us per "
          f"call, best of 2 turns of {K5_HOST_CALLS} calls ({smi}): "
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in mp["host_ms"].items())
          + f"; the phase took {time.perf_counter() - t_phase:.1f} s")

    sl = phase_slice(device, sd)
    if sl["launches"] < len(SERVE_BATCHES):
        fail(f"K1 launched {sl['launches']} times on the main path")
    print(f"slice: detect_batch f32 on {list(SERVE_BATCHES)}: valid "
          f"{sl['valid']}, suppressed {sl['suppressed']}, K1 launches "
          f"{sl['launches']}, K4 launches {sl['k4']}, K5 launches "
          f"{sl['k5']}, kernel == plain-NMS "
          f"detections, card vs CPU loc/conf {sl['card_vs_cpu_rel']:.3e} of "
          f"scale")

    tr = phase_train_slice(device)
    print(f"train slice: {TRAIN_STEPS} train_steps f32 (TF32 off) batch "
          f"{TRAIN_BATCH}, {list(ROUTED)} routed: losses "
          f"{[round(x, 6) for x in tr['losses']]}, K2 launches "
          f"{tr['launches']} (want {4 * TRAIN_STEPS}), gradient layout "
          f"copies {tr['layout_copies']}; card vs CPU: losses "
          f"{tr['loss_rel']:.3e} relative, parameter changes "
          f"{tr['delta_norm_rel']:.3e} in norm and {tr['delta_rel']:.3e} of "
          f"their largest ({tr['delta_worst']}); "
          f"K2 vs cuDNN wgrad dW {tr['wgrad_rel']:.3e} of max|dW|; routed "
          f"dX channels_last, {tr['dx_rel']:.3e} of max|dX| from autograd's "
          f"(tolerance {DX_TOL:.0e})")
    fr = phase_frozen_step(device)
    print(f"train slice: freeze_stages=1 step: K2 launches {fr['launches']} "
          f"(conv2_1, conv2_2), conv1 gradients none, conv2 gradients "
          f"present")

    tm = phase_timing(sd, k1_baselines)
    print(f"timing: bf16 channels_last batch {TIMING_BATCH} ({smi}): "
          f"{tm['images_per_s']:.1f} images/s end to end "
          f"({tm['step_ms']:.3f} ms/step), forward {tm['forward_ms']:.3f} ms"
          f" ({tm['gflop_per_image']:.2f} GFLOP/image of convs, "
          f"{tm['forward_tflops']:.1f} TFLOP/s, "
          f"{tm['forward_tflops'] / 989 * 100:.1f}% of the 989 TFLOP/s bf16 "
          f"peak), postprocess {tm['postprocess_ms']:.3f} ms")
    for r in tm["k1"]:
        runs = "; ".join(
            f"{key} device {r[key]['device_ms'] * 1e3:.2f} us per launch "
            f"(torch.profiler, {K1_CALLS} launches: {r[key]['kernels']}), "
            f"host {r[key]['host_ms'] * 1e3:.2f} us per call, CUDA events "
            f"{r[key]['event_ms'] * 1e3:.2f} us per call"
            for key in r["runs"])
        print(f"timing: K1 at {r['shape']} ({smi}): {runs}; valid per set "
              f"mean {r['valid_mean']:.2f} max {r['valid_max']}, suppressed "
              f"{r['suppressed']}; bound {r['bound_ms'] * 1e3:.3f} us by "
              f"{r['bound_by']} (valid pairs), all-pairs bound "
              f"{r['all_pairs_bound_ms'] * 1e3:.3f} us by "
              f"{r['all_pairs_bound_by']}; plain {r['plain_ms'] * 1e3:.1f} "
              f"us; library_ms null: no PyTorch call computes fixed-shape "
              f"batched greedy NMS")

    tt = phase_train_timing()
    rng = {k: "-".join(f"{t:.3f}" for t in v)
           for k, v in tt["step_ms_range"].items()}
    print(f"train timing: bf16 channels_last batch {TIMING_TRAIN_BATCH} "
          f"({smi}), median of 4 windows of 10 steps: routed "
          f"{tt['routed_images_per_s']:.1f} images/s "
          f"({tt['routed_step_ms']:.3f} ms/step, windows {rng['routed']}), "
          f"dw_pallas_convs=() {tt['plain_images_per_s']:.1f} images/s "
          f"({tt['plain_step_ms']:.3f} ms/step, windows {rng['plain']}); "
          f"K2 launches per routed step {tt['launches_per_step']}")
    print(f"train timing: one bf16 step at batch {TIMING_TRAIN_BATCH} from "
          f"the same weights, routed vs unrouted: K2 vs cuDNN wgrad dW " +
          ", ".join(f"{n} {v:.3e}" for n, v in tt["bf16_wgrad_rel"].items())
          + f" of max|dW| (tolerance {BF16_WGRAD_TOL:.0e})")
    prof = tt["profile"]
    for key, p in prof.items():
        print_profile(key, p)
    if all(p["device_ms"] > 0 for p in prof.values()):
        names = set(prof["routed"]["ops"]) | set(prof["plain"]["ops"])
        diff = sorted(((prof["routed"]["ops"].get(n, 0.0)
                        - prof["plain"]["ops"].get(n, 0.0), n)
                       for n in names), reverse=True)
        print(f"profile: routed minus unrouted, "
              f"{prof['routed']['device_ms'] - prof['plain']['device_ms']:.3f}"
              f" ms/step of device ops; most added: " + "; ".join(
                  f"{d:+.3f} ms {n[:90]}" for d, n in diff[:6])
              + "; most removed: " + "; ".join(
                  f"{d:+.3f} ms {n[:90]}" for d, n in diff[-4:]))
        names = set(prof["routed"]["aten"]) | set(prof["plain"]["aten"])
        diff = sorted(((prof["routed"]["aten"].get(n, 0.0)
                        - prof["plain"]["aten"].get(n, 0.0), n)
                       for n in names), reverse=True)
        print("profile: routed minus unrouted by aten operator (device ms "
              "per step, children included): " + "; ".join(
                  f"{d:+.3f} {n}" for d, n in diff[:6] + diff[-3:]))
        copy = {key: p["aten"].get("aten::copy_", 0.0)
                for key, p in prof.items()}
        print(f"profile: aten::copy_ routed {copy['routed']:.3f} ms/step, "
              f"unrouted {copy['plain']:.3f}, routed minus unrouted "
              f"{copy['routed'] - copy['plain']:+.3f} ms/step")
    else:
        print("profile: torch.profiler recorded no device time")
    for r in tt["k2"]:
        pl, px = r["plan"], r["ptxas"]
        tiling = (f"tiles {pl['tile_h']}x{pl['tile_w']} px, "
                  f"{pl['tiles_per_chunk']} per chunk"
                  if r["kernel"] == "halo"
                  else f"{pl['chunk_pixels']} px per chunk")
        print(f"train timing: K2 {r['conv']} {r['shape']} bf16: "
              f"{r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.1f} us "
              f"by {r['bound_by']}; {r['gflop']:.1f} GFLOP, "
              f"{r['mbytes']:.1f} MB), plain {r['plain_ms'] * 1e3:.1f} us, "
              f"cuDNN wgrad (library) {r['library_ms'] * 1e3:.1f} us, "
              f"kernel vs plain {r['rel']:.3e} of max|dW|; {r['kernel']} "
              f"kernel {short_name(px['function'])}, {pl['chunks']} chunks, "
              f"{tiling}; {px['registers']} registers, "
              f"{px['spill_stores']}/{px['spill_loads']} bytes spilled")
    t_phase = time.perf_counter()
    ts = phase_trainer_slice(device)
    print(f"trainer slice: fixture {ts['train_images']} train + "
          f"{ts['val_images']} val images at 500x375 in packed caches "
          f"({ts['fixture_s']:.2f} s, no decode); Loader alone (host, "
          f"augment on, uint8, batch {TIMING_TRAIN_BATCH}, {ts['workers']} "
          f"workers, os.cpu_count() {ts['cpu_count']}): "
          f"{ts['loader_images_per_s']:.1f} images/s (first epoch, workers "
          f"starting: {ts['loader_cold_images_per_s']:.1f}), "
          f"{ts['loader_worker_ms']:.2f} ms per image in a worker; native "
          f"fall-throughs 0; host CPUs: {ts['cpus']} ({smi})")
    for key, s in ts["train"].items():
        print(f"trainer slice: Trainer.fit bf16 batch {TIMING_TRAIN_BATCH} "
              f"{'device_prefetch on, epoch 1' if key == 'prefetch' else 'device_prefetch off, epoch 2'}"
              f" ({smi}): train phase {s['images_per_s']:.1f} images/s "
              f"({s['steps']} steps, {s['seconds']:.3f} s), input wait "
              f"{s['input_wait_ms_per_step']:.3f} ms/step; train_step alone "
              f"(unrouted, synthetic batches, train timing above) "
              f"{tt['plain_images_per_s']:.1f} images/s")
    print(f"trainer slice: val loss {ts['val_loss']:.4f} after epoch 1, "
          f"checkpoint save ms per epoch "
          f"{[round(x, 1) for x in ts['save_ms']]}; resume: start_epoch 2, "
          f"same history, bit-equal parameters; copy stage: the batches "
          f"of {ts['copy_stage_steps']} steps (epochs 0-1, train and test "
          f"phases) bit-equal to their host arrays ({smi})")
    ev = ts["eval"]
    print(f"trainer slice: cli eval (val split from its cache, exact "
          f"postprocess, f32, batch {TIMING_TRAIN_BATCH}) ({smi}): mAP "
          f"{ev['map']:.4f}, {ev['images']} images in {ev['batches']} batches"
          f", {ev['images_per_s']:.1f} images/s, K1 launches "
          f"{ev['launches']}; Detector.from_checkpoint detect_batch(8): K1 "
          f"launches {ts['detect_launches']}; empty directory raises "
          f"FileNotFoundError")
    print(f"trainer slice: the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    k1_launches = sl["launches"] + ev["launches"] + ts["detect_launches"]

    # The ResNet-34 family, Soft-NMS, flip TTA, the loaders' CLI and remat.
    t_phase = time.perf_counter()
    rs = phase_resnet_slice(device, rsd)
    print(f"resnet34 slice: detect_batch bf16 {RESNET_SIZE} px on "
          f"{list(SERVE_BATCHES)}: valid {rs['valid']}, suppressed "
          f"{rs['suppressed']}, K1 launches {rs['launches']}, K4 launches "
          f"{rs['k4']}, K5 launches {rs['k5']}, kernel == "
          f"plain-NMS detections; f32 card vs CPU loc/conf "
          f"{rs['card_vs_cpu_rel']:.3e} of scale (non-trivial BN "
          f"statistics); card == CPU detections (atol {SOFT_NMS_ATOL:.0e}) "
          f"for " + ", ".join(
              f"{k} (valid {v['valid']}, merged loc/conf "
              f"{v['merged_rel']:.2e}, K1 {v['k1']})"
              for k, v in rs["opt_in"].items()))
    rt = phase_resnet_train(device)
    print(f"resnet34 train: {TRAIN_STEPS} f32 train_steps batch "
          f"{RESNET_TRAIN_BATCH} dropout 0, frozen trunk (bit-unchanged): "
          f"losses {[round(x, 6) for x in rt['losses']]}; card vs CPU: "
          f"losses {rt['loss_rel']:.3e} relative, changes of parameters "
          f"and running statistics {rt['delta_norm_rel']:.3e} in norm and "
          f"{rt['delta_rel']:.3e} of their largest ({rt['delta_worst']}), "
          f"running statistics alone {rt['stats_rel']:.3e}; dropout 0.4: "
          f"losses {rt['dropout_losses']} (runs a, b seed {SEED}; c seed "
          f"{SEED + 1}), masks repeat from (seed, step)")
    rtr = phase_resnet_trainer(device, *CUT_FIXTURE)
    phases = "; ".join(
        f"{label}: train phase {s['images_per_s']:.1f} images/s "
        f"({s['steps']} steps, {s['seconds']:.3f} s), input wait "
        f"{s['input_wait_ms_per_step']:.3f} ms/step"
        for label, s in (("epoch 1, workers warm", rtr["warm"]),
                         ("--resume epoch 2, workers starting",
                          rtr["resumed"])))
    print(f"resnet34 trainer: cli train --backbone resnet34 --bf16 batch "
          f"{TIMING_TRAIN_BATCH}, {rtr['workers']} workers, fixture "
          f"{rtr['train_images']} train + {rtr['val_images']} val at "
          f"500x375 in packed caches ({smi}): {phases}; wall "
          f"{rtr['train_s']:.2f} s for epochs 0-1, {rtr['resume_s']:.2f} s "
          f"for the resumed run; train losses "
          f"{[round(x, 4) for x in rtr['train_loss']]}; fresh Trainer "
          f"resume bit-equal (BN statistics included), trunk unchanged; "
          f"cli eval mAP {rtr['eval']['map']:.4f}, K1 launches "
          f"{rtr['eval']['launches']} in {rtr['eval']['batches']} batches "
          f"(K = 189); cli detect " + ", ".join(
              f"{k}: {v['lines']} detections, K1 launches {v['launches']}"
              for k, v in rtr["detect"].items()))
    rm = phase_remat_step(device)
    print(f"remat: one bf16 SSD300 step batch {TIMING_TRAIN_BATCH}, "
          f"{list(ROUTED)} routed, cuDNN deterministic ({smi}): remat vs "
          f"plain loss {rm['loss_rel']:.3e}, gradients {rm['grad_rel']:.3e} "
          f"of max; peak memory above the state "
          f"{rm['plain_peak_mb']:.1f} MiB plain, {rm['remat_peak_mb']:.1f} "
          f"MiB remat; step {rm['plain_step_ms']:.2f} / "
          f"{rm['remat_step_ms']:.2f} ms (one step each); K2 launches "
          f"{rm['launches']}")
    rtm = phase_resnet_timing(rsd)
    print(f"resnet34 timing: bf16 channels_last batch {TIMING_BATCH} "
          f"({smi}): {rtm['images_per_s']:.1f} images/s end to end "
          f"({rtm['step_ms']:.3f} ms/step), forward {rtm['forward_ms']:.3f} "
          f"ms ({rtm['gflop_per_image']:.2f} GFLOP/image of convs, "
          f"{rtm['forward_tflops']:.1f} TFLOP/s), postprocess hard "
          f"{rtm['postprocess_hard_ms']:.3f} ms, soft_gaussian "
          f"{rtm['postprocess_soft_gaussian_ms']:.3f} ms, soft_linear "
          f"{rtm['postprocess_soft_linear_ms']:.3f} ms; detect_batch "
          f"{rtm['detect_ms']:.3f} ms, with flip TTA "
          f"{rtm['detect_tta_ms']:.3f} ms")
    for r in rtm["k1"]:
        print(f"resnet34 timing: K1 at {r['shape']} ({smi}): device "
              f"{r['k1']['device_ms'] * 1e3:.2f} us per launch "
              f"(torch.profiler, {K1_CALLS} launches: {r['k1']['kernels']}), "
              f"host {r['k1']['host_ms'] * 1e3:.2f} us per call, CUDA events "
              f"{r['k1']['event_ms'] * 1e3:.2f} us per call; valid per set "
              f"mean {r['valid_mean']:.2f} max {r['valid_max']}, suppressed "
              f"{r['suppressed']}; bound {r['bound_ms'] * 1e3:.3f} us by "
              f"{r['bound_by']} (valid pairs), all-pairs bound "
              f"{r['all_pairs_bound_ms'] * 1e3:.3f} us; plain "
              f"{r['plain_ms'] * 1e3:.1f} us")
    rtt = phase_resnet_train_timing()
    print(f"resnet34 train timing: train_step bf16 batch "
          f"{TIMING_TRAIN_BATCH}, dropout 0.4, frozen trunk ({smi}), median "
          f"of 4 windows of 10 steps: {rtt['images_per_s']:.1f} images/s "
          f"({rtt['step_ms']:.3f} ms/step, windows "
          f"{[round(w, 3) for w in rtt['windows_ms']]})")
    for key, p in rtt["profile"].items():
        print_profile(key, p)
    print(f"resnet34 phases took {time.perf_counter() - t_phase:.1f} s")
    k1_launches += (rs["launches"] + rtr["eval"]["launches"]
                    + rtr["detect"]["hard"]["launches"])

    # int8 serving (K3) and QAT.
    t_phase = time.perf_counter()
    iv = phase_int8_vs_plain(device)
    print(f"int8 kernel: K3 bit-equal to its plain version at "
          f"{iv['shapes']} shapes (every SSD300 and ResNet-34 conv at batch "
          f"{INT8_CHECK_BATCH}, heads included, ragged and unaligned ones, "
          f"{iv['padded']} L1 shapes with Cin padded), "
          f"{iv['compared']} comparisons: f32 / bf16 / int8 output, with "
          f"and without bias (max_abs_err {iv['max_abs_err']}); shapes per "
          f"instantiation {iv['plans']}")
    isl = phase_int8_slice(device, sd, rsd)
    a, b = isl["ssd300"], isl["resnet34"]
    print(f"int8 slice: SSD300 calibrated on the card over "
          f"{INT8_CALIB_IMAGES} images, {SSD300_INT8_CONVS} convs, chained "
          f"bf16 detect_batch on {list(INT8_SERVE_BATCHES)}: valid "
          f"{a['valid']}, suppressed {a['suppressed']}, K3 launches "
          f"{a['k3']} ({SSD300_INT8_CONVS} per forward), K1 {a['k1']}, K5 "
          f"{a['k5']} (int8 pools 1-3 and 5, bf16 pool4), "
          f"kernel == plain-NMS detections, chained == unchained bit for "
          f"bit; f32 int8 card vs CPU loc/conf {a['card_vs_cpu_rel']:.3e} "
          f"of scale")
    print(f"int8 slice: ResNet-34 {b['convs']} convs, unchained bf16 "
          f"detect_batch on {list(INT8_SERVE_BATCHES)}: valid {b['valid']}, "
          f"suppressed {b['suppressed']}, K3 launches {b['k3']} "
          f"({RESNET_INT8_CALLS} per forward), K1 {b['k1']}, K5 {b['k5']}; "
          f"flip TTA K3 "
          f"{b['tta_k3']}, valid {b['tta_valid']}; f32 int8 card vs CPU "
          f"{b['card_vs_cpu_rel']:.3e} of scale, {b['noise_ratio']:.3f} of "
          f"the CPU's int8-vs-float difference (limit "
          f"{INT8_NOISE_RATIO}), correlation {b['corr']:.6f}")
    it = phase_int8_timing(sd, rsd, k3_baselines)
    for family in ("ssd300", "resnet34"):
        print(f"int8 timing: {family} batch {TIMING_BATCH} ({smi}), best "
              f"of 3 windows of 10 chained steps, in turns twice: " +
              "; ".join(f"{key} {r['images_per_s']:.1f} images/s "
                        f"({r['step_ms']:.3f} ms/step, runs "
                        f"{[round(t, 3) for t in r['step_ms_runs']]}), "
                        f"forward {r['forward_ms']:.3f} ms"
                        for key, r in it[family].items()))
    for r in it["k3"]:
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.1f} us")
        r["registers"] = k3_ptxas(k3_ptx, r["tile"])["registers"]
        patch = (f", patch {r['patch'][0]}x{r['patch'][1]}"
                 if r["path"] == "rows" else "")
        base = "".join(f"; baseline {k} {v * 1e3:.1f} us"
                       for k, v in r["baselines"].items())
        print(f"int8 timing: K3 {r['conv']} {r['shape']} -> {r['out']} "
              f"({smi}): {r['tile']}{patch}, {r['smem']} B shared, "
              f"{r['registers']} registers: device {r['ms'] * 1e3:.1f} us "
              f"per launch (CUDA graph, {r['tops']:.1f} TOPS){base}, "
              f"{r['host_ms'] * 1e3:.1f} us per direct call (CUDA events); "
              f"bound {r['bound_ms'] * 1e3:.1f} us by {r['bound_by']}; "
              f"plain {r['plain_ms'] * 1e3:.1f} us; cuDNN bf16 conv "
              f"{r['cudnn_bf16_ms'] * 1e3:.1f} us; {r['library']}: {lib}")
    k3_rows = it["k3"]
    print(f"int8 timing: K3 over the {len(k3_rows)} quantized convs of one "
          f"batch-{INT8_TIMING_BATCH} SSD300 forward: device "
          f"{sum(r['ms'] for r in k3_rows):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in k3_rows):.3f} ms, cuDNN bf16 "
          f"{sum(r['cudnn_bf16_ms'] for r in k3_rows):.3f} ms, "
          f"torch._int_mm "
          f"{sum(r['library_ms'] or 0.0 for r in k3_rows):.3f} ms" + "".join(
              f", baseline {name} "
              f"{sum(r['baselines'][name] for r in k3_rows):.3f} ms"
              for name in k3_baselines))
    qa = phase_qat(device)
    print(f"qat: {TRAIN_STEPS} f32 train_steps (quant_ste, TF32 off) batch "
          f"{TRAIN_BATCH}: losses {[round(x, 6) for x in qa['losses']]}; " +
          "; ".join(f"{label}: losses {r['loss_rel']:.3e} relative, "
                    f"parameter changes {r['delta_norm_rel']:.3e} in norm "
                    f"and {r['delta_rel']:.3e} of their largest "
                    f"({r['delta_worst']})"
                    for label, r in (("card vs CPU", qa["card"]),
                                     ("floor, CPU vs CPU with each conv "
                                      "output an ulp off", qa["floor"])))
          + f" (limit: the train gates or {QAT_FLOOR_FACTOR} x the floor)")
    print(f"qat: cli train --qat -> quant_scales.json bound to the "
          f"checkpoint; cli eval --int8 mAP {qa['eval']['map']:.4f}, "
          f"{qa['eval']['batches']} batches, K3 {qa['eval']['k3']}, K1 "
          f"{qa['eval']['k1']}; cli detect --int8 {qa['detect']['lines']} "
          f"detections, K3 {qa['detect']['k3']}, K1 {qa['detect']['k1']}; "
          f"after training on: {qa['stale']!r}; --recalibrate K3 "
          f"{qa['recalibrated']['k3']}")
    print(f"int8 phases took {time.perf_counter() - t_phase:.1f} s")
    k1_launches += (a["k1"] + b["k1"] + qa["eval"]["k1"]
                    + qa["detect"]["k1"])
    k3_launches = (a["k3"] + b["k3"] + b["tta_k3"] + qa["eval"]["k3"]
                   + qa["detect"]["k3"])

    # The serving artifact: export, load, serve, reload, the CPU, timing.
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root:
        ex = phase_export(device, sd, rsd, root)
    for name, r in ex["artifacts"].items():
        m, t = r["meta"], r["timing"]
        cpu = ("" if "cpu" not in r else
               f"; moved to the CPU: {r['cpu']['matched']} rows matched "
               f"within {EXPORT_CPU_ATOL:.0e} (largest difference "
               f"{r['cpu']['worst']:.3e}), {r['cpu']['left']} at a cutoff")
        print(f"export: {name} (batch {r['batch']}, {m['input_dtype']} in, "
              f"quantized_convs {m['quantized_convs']}, tta_flip "
              f"{m['tta_flip']}): export {r['export_s']:.2f} s, load "
              f"{r['load_s']:.2f} s; {r['chunks']} chunks (two, and a "
              f"reload) == live detect_batch (JAX's gate), K1 {r['k1']}, "
              f"K3 {r['k3']}, K4 {r['k4']}, K5 {r['k5']}, valid "
              f"{r['valid']}{cpu}; the "
              f"program: "
              f"{r['ops']} operator calls, of them " + ", ".join(
                  f"{v} {k}" for k, v in r["op_counts"].items()))
        print(f"export timing: {name} batch {r['batch']} ({smi}), best of "
              f"2 windows of {EXPORT_CALLS} calls in turns: artifact "
              f"{t['artifact_images_per_s']:.1f} images/s "
              f"({t['artifact_ms']:.3f} ms/call, host "
              f"{t['artifact_host_ms']:.3f} ms/call), live Detector "
              f"{t['live_images_per_s']:.1f} ({t['live_ms']:.3f} ms, host "
              f"{t['live_host_ms']:.3f} ms); the "
              f"loaded program as a CUDA graph {t['graph_images_per_s']:.1f} "
              f"images/s ({t['graph_ms']:.3f} ms/replay)")
    print(f"export: MicroBatcher over MinimalExportedDetector answered "
          f"{BATCHER_REQUESTS} concurrent requests in {ex['batcher_calls']} "
          f"program calls with the rows of one batched call; opcheck "
          f"passed for ssd::nms_keep, ssd::int8_conv, ssd::bias_relu and "
          f"ssd::max_pool on CUDA tensors; "
          f"the phase took {time.perf_counter() - t_phase:.1f} s")
    k1_launches += ex["k1"]
    k3_launches += ex["k3"]
    # The serving requests of SSD300 and ResNet-34 and the artifacts'
    # chunks.
    k4_launches = sl["k4"] + rs["k4"] + ex["k4"]
    # The same and the int8 serving requests of both families.
    k5_launches = (sl["k5"] + rs["k5"] + ex["k5"] + isl["ssd300"]["k5"]
                   + isl["resnet34"]["k5"])

    # The JAX package's remaining public names, before any process group.
    ap = phase_api(device)
    print(f"api: package-level names == the submodules'; the legacy box ops "
          f"on the card vs the CPU ({smi}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in ap["boxes"].items())
          + f" (masks and shuffles equal, floats within {API_FLOAT_TOL:.0e};"
          f" mixed_class_nms suppressed {ap['suppressed']} of "
          f"{API_NMS_SETS[0] * API_NMS_SETS[1]}); create_global_mesh with no "
          f"process group: {ap['mesh']}; build_ssd300_pipeline on [cuda, "
          f"cuda], f32 batch {TRAIN_BATCH}, cuDNN deterministic, vs the "
          f"monolith: {'bit-equal' if ap['pipeline_bit_equal'] else 'not bit-equal'}"
          f" ({ap['pipeline_rel']:.3e}); devices=None: "
          f"{ap['default_devices']}")
    print(f"api phase took {ap['ms']:.1f} ms")

    # Quality: the learnability recipes on the card (leg a), then SSD300
    # trained through the CLI and every inference variant's mAP (leg b).
    t_phase = time.perf_counter()
    qt = phase_quality_toy(device)
    t_toy = time.perf_counter() - t_phase
    qs = phase_quality_ssd300(device)
    k1, k3 = report_quality(qt, qs, smi)
    k1_launches += k1
    k3_launches += k3
    bad = quality_failures(qs)
    if bad:
        fail(f"quality ssd300: {bad}")
    print(f"quality: every gate met; leg (a) {t_toy:.1f} s, the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")

    # Data parallelism: the two-rank gloo leg, then the wrappers, the CLI
    # and the multi-rank eval under a one-rank NCCL group joined through
    # `distributed.initialize`; the ResNet-34 host-time split; the doctor.
    t_phase = time.perf_counter()
    gl = phase_gloo_leg()
    print(f"parallel: two ranks over gloo on the one card ({smi}), DDP of "
          f"one f32 SSD300 step at global batch {GLOO_BATCH}, "
          f"{list(ROUTED)} routed: loss {gl['loss']:.6f}, "
          f"{gl['loss_rel']:.3e} relative to the single-process step, "
          f"gradients {gl['grad_norm_rel']:.3e} in norm and "
          f"{gl['grad_rel']:.3e} of their largest ({gl['grad_worst']}; the "
          f"train gates); K2 launches on rank 0 {gl['launches']}; the leg "
          f"took {gl['seconds']:.1f} s")
    dev = join_world_of_one(device)
    ps = phase_parallel_steps(dev)
    kinds = {"unwrapped": "the unwrapped run again",
             "ddp": "DDP (NCCL world size 1)",
             "fsdp": "FSDP2 on a 1 x 1 data x fsdp mesh (NCCL world size 1)"}
    nd = ps.pop("nondeterministic")
    print(f"parallel: {TRAIN_STEPS} f32 steps batch {TRAIN_BATCH}, cuDNN "
          f"deterministic, vs the unwrapped run: " + "; ".join(
              f"{kinds[key]}: losses and parameters bit-equal (changes "
              f"{r['delta_rel']:.3e} of their largest, "
              f"{r['delta_norm_rel']:.3e} in norm), K2 launches "
              f"{r['launches']}" for key, r in ps.items())
          + f"; without cuDNN's deterministic algorithms the unwrapped run "
          f"differs from itself by {nd['delta_rel']:.3e} of the largest "
          f"change ({nd['delta_worst']}), {nd['delta_norm_rel']:.3e} in "
          f"norm")
    pt = phase_parallel_timing()
    print(f"parallel timing: SSD300 bf16 batch {TIMING_TRAIN_BATCH}, "
          f"{list(ROUTED)} routed ({smi}), median of {PARALLEL_WINDOWS} "
          f"windows of {PARALLEL_WINDOW_STEPS} steps in turns: " + "; ".join(
              f"{key} {pt[key]['step_ms']:.3f} ms/step "
              f"({pt[key]['images_per_s']:.1f} images/s, windows "
              f"{[round(w, 3) for w in pt[key]['windows_ms']]})"
              for key in ("unwrapped", "ddp", "fsdp"))
          + f"; wrapper overhead DDP "
          f"{pt['ddp']['step_ms'] - pt['unwrapped']['step_ms']:+.3f} ms/step,"
          f" FSDP2 {pt['fsdp']['step_ms'] - pt['unwrapped']['step_ms']:+.3f}"
          f" ms/step; K2 launches per wrapped step 4")
    pc = phase_parallel_cli(dev, *CUT_FIXTURE)
    ev = pc["eval"]
    print(f"parallel: cli train (distributed.initialize, DDP, world size 1)"
          f" bf16 batch {TIMING_TRAIN_BATCH}, 1 epoch, --eval-map-every 1 "
          f"--profile-dir ({smi}): {pc['train_s']:.1f} s, val mAP "
          f"{pc['train_map']:.4f} (K1 launches {pc['train_k1']}), trace "
          f"{pc['trace_mb']:.1f} MiB, the checkpoint served by "
          f"Detector.from_checkpoint; cli eval --data-parallel 1: mAP "
          f"{ev['map']:.4f}, {ev['images']} images in {ev['batches']} "
          f"batches, K1 launches {ev['launches']}, {ev['images_per_s']:.1f} "
          f"images/s (plain path {ev['plain_map']:.4f}); on the serving "
          f"weights, evaluate_records multi-rank rows == plain rows "
          f"({ev['valid']} valid detections), mAP {ev['multi_map']:.6f} vs "
          f"{ev['serving_map']:.6f} (per-class AP within "
          f"{ev['ap_diff']:.1e})")
    leave_world()
    hs = phase_host_split()
    print(f"host split: ResNet-34 train_step bf16 batch {TIMING_TRAIN_BATCH}"
          f", dropout 0.4, frozen trunk, {HOST_SPLIT_STEPS} steps under "
          f"profiler_trace ({smi}): {hs['wall_ms']:.3f} ms/step under the "
          f"profiler ({hs['plain_step_ms']:.3f} without); host per step: "
          f"kernel launches {hs['launch_ms']:.3f} ms ({hs['launches']:.0f} "
          f"launch calls), host-to-card copies {hs['copy_ms']:.3f} ms "
          f"({hs['copies']:.0f}), the loss's host sync {hs['sync_ms']:.3f} "
          f"ms ({hs['syncs']:.0f} reads), optimizer step "
          f"{hs['optimizer_ms']:.3f} ms, aten operators' own host time "
          f"{hs['aten_self_ms']:.3f} ms, Python (no operator or runtime "
          f"call) {hs['python_ms']:.3f} ms; device ops "
          f"{hs['device_ms']:.3f} ms/step; top host self times: " + "; ".join(
              f"{ms:.3f} ms {name[:60]}" for ms, name in hs["top"]))
    dr = phase_doctor()
    print(f"doctor: cli doctor --json: {dr['status']}, {dr['device_count']} "
          f"x {dr['device_name']}, init {dr['init_seconds']:.3f} s, matmul "
          f"{dr['matmul_seconds']:.3f} s; host checks: "
          + "; ".join(dr["host_checks"]))
    print(f"parallel phases took {time.perf_counter() - t_phase:.1f} s")
    k1_launches += pc["train_k1"] + ev["launches"]

    # Tensor and spatial parallelism: two gloo ranks on the one card.
    t_phase = time.perf_counter()
    tps = phase_tp_sp_leg(qa["floor"])
    shared = "two gloo ranks sharing one card, not a multi-card figure"
    print(f"tp/sp: QAT, one f32 train_step (quant_ste, TF32 off, cuDNN "
          f"deterministic) batch {TRAIN_BATCH} on two gloo ranks ({shared}, "
          f"{smi}) against the single-process card QAT step: " + "; ".join(
              f"{name}: losses {r['loss_rel']:.3e} relative, parameter "
              f"changes {r['delta_norm_rel']:.3e} in norm and "
              f"{r['delta_rel']:.3e} of their largest ({r['delta_worst']})"
              for name, r in (("data (DDP)", tps["qat"]["data"]),
                              ("TP = 2", tps["qat"]["model"]),
                              ("SP = 2", tps["qat"]["spatial"])))
          + f" (limit: the train gates or {QAT_FLOOR_FACTOR} x phase qat's "
          f"floor)")
    for axis, name in (("model", "TP = 2 (data x model = 1 x 2)"),
                       ("spatial", "SP = 2 (data x spatial = 1 x 2)")):
        r = tps[axis]
        f32, int8 = r["f32"], r["int8"]
        print(f"tp/sp: {name}, {shared} ({smi}): f32 SSD300 step batch "
              f"{TRAIN_BATCH}, {list(ROUTED)} routed, against the "
              f"single-process card step (cuDNN deterministic): loss "
              f"{r['loss_rel']:.3e} relative, gradients "
              f"{r['grad_rel']:.3e} of their largest ({r['grad_worst']}; "
              f"gate {TP_SP_GRAD_TOL:.0e}), {r['grad_norm']:.3e} in norm; "
              f"K2 4 per step per rank; "
              f"{[round(x, 3) for x in r['step_ms']]} ms/step by rank; "
              f"f32 detect_batch({TP_SP_SERVE_BATCH}): {f32['matched']} "
              f"rows matched within {TP_SP_DET_ATOL:.0e} (largest "
              f"difference {f32['worst']:.3e}, {f32['left']} at a cutoff); "
              f"bf16 loc/conf {r['bf16']:.3e} of their largest from the "
              f"single-process forward's (gate {TP_SP_BF16_TOL:.3e}), "
              f"bf16 detect_batch {[round(x, 3) for x in r['serve_ms']]} "
              f"ms/batch by rank; K1 1 per batch per rank; int8 "
              f"detect_batch({TP_SP_INT8_BATCH}): {r['int8_calls']} K3 "
              f"calls per rank, each bit-equal to its slice of the "
              f"single-process call, {int8['matched']} rows matched "
              f"(largest difference {int8['worst']:.3e}); "
              f"{[round(x, 1) for x in r['seconds']]} s by rank")
    print(f"tp/sp: ResNet-34 train mode, batch {RESNET_TRAIN_BATCH}, "
          f"dropout, SP = 2 ({shared}): gradients "
          f"{tps['resnet_grad_rel']:.3e} of their largest against the "
          f"single-process card step (gate {TP_SP_RESNET_TOL:.0e}), losses "
          f"and BN statistics within 1e-4 / 1e-5")
    tr_sp = tps["trainer"]
    st = tr_sp["stats"]["train"]
    print(f"tp/sp: Trainer.fit, 1 bf16 epoch at batch {TIMING_TRAIN_BATCH} "
          f"under SP = 2 ({shared}, {smi}): {st['images']} images in "
          f"{st['steps']} steps, {st['seconds']:.1f} s "
          f"({st['images'] / st['seconds']:.1f} images/s, input wait "
          f"{st['input_wait_s'] / st['steps'] * 1e3:.1f} ms/step), losses "
          f"{tr_sp['history']}; the checkpoint reloads at world size 1 to "
          f"the ranks' parameters; evaluate_records under SP: mAP "
          f"{tr_sp['map']:.4f} in {tr_sp['eval_s']:.1f} s, K1 "
          f"{tr_sp['eval_k1']} per rank (once per batch); "
          f"{tr_sp['seconds']:.1f} s")
    for ways, b in tps["bytes"].items():
        print(f"tp/sp collectives per step, SSD300 batch {COLLECTIVE_BATCH} "
              f"bf16, {ways} ways (from the shapes): TP channel gathers "
              f"{b['tp_gather'] / 2**20:.1f} MiB of stacks per forward (a "
              f"buffer as large all-reduced in the backward), L2Norm "
              f"{b['tp_l2norm'] / 2**20:.2f} MiB f32 all-reduced; SP halos "
              f"{b['sp_halo'] / 2**20:.1f} MiB, head rows "
              f"{b['sp_heads'] / 2**20:.1f} MiB")
    print(f"tp/sp leg: {tps['seconds']:.1f} s of spawned ranks, "
          f"{time.perf_counter() - t_phase:.1f} s in all")
    k1_launches += tps["k1"]
    k3_launches += tps["k3"]

    # Pipeline parallelism, every stage on the one card.
    t_phase = time.perf_counter()
    pp = phase_pp(device)
    m1, m2, dp2 = pp["m1"], pp["m2"], pp["dp2"]
    print(f"pp: f32 SSD300 batch {TRAIN_BATCH}, every stage on cuda:0, "
          f"cuDNN deterministic ({smi}): 2-stage M=1 vs the monolithic step "
          f"gradients {'bit-equal' if m1['bit_equal'] else 'not bit-equal'}"
          f" ({m1['grad_rel']:.3e} of the largest), loss "
          f"{'equal' if m1['loss_equal'] else 'not equal'}; M=2 vs two "
          f"grad-accum micro-steps: loss {m2['loss_rel']:.3e} relative, "
          f"parameter changes {m2['delta_rel']:.3e} of their largest "
          f"({m2['delta_worst']}), {m2['delta_norm_rel']:.3e} in norm; "
          f"3- and 4-stage forwards vs the monolith " + ", ".join(
              f"{n}: {v:.3e}" for n, v in pp["forward_rel"].items())
          + f" of the largest; dp=2 vs dp=1 gradients {dp2['grad_rel']:.3e} "
          f"of the largest ({dp2['worst']}; gate {PP_GRAD_TOL:.0e}), loss "
          f"{dp2['loss_rel']:.3e}; routed step M=2: K2 launches {pp['k2']} "
          f"(4 per microbatch), dW vs the unrouted step's "
          f"{pp['k2_wgrad_rel']:.3e} of max|dW|")
    t = pp["timing"]
    print(f"pp timing: bf16 SSD300 train step batch {TIMING_TRAIN_BATCH}, "
          f"every stage on the one card ({smi}), median of "
          f"{PP_TIMING_WINDOWS} windows of {PP_TIMING_STEPS} steps in turns: "
          + "; ".join(f"{key} {r['step_ms']:.3f} ms/step "
                      f"({r['images_per_s']:.1f} images/s, windows "
                      f"{[round(w, 3) for w in r['windows_ms']]}), peak "
                      f"memory above the state {r['peak_mb']:.1f} MiB"
                      for key, r in t.items()))
    tr_pp = pp["trainer"]
    st = tr_pp["stats"]["train"]
    print(f"pp: Trainer.fit 1 f32 epoch, --pp 2 --pp-microbatches 2, batch "
          f"{PP_TRAINER_BATCH}, fixture {PP_FIXTURE} ({smi}): {st['images']} "
          f"images in {st['steps']} steps, {st['seconds']:.2f} s, losses "
          f"{tr_pp['history']}; a monolithic Trainer resumed its checkpoint "
          f"to bit-equal parameters; cli train --pp 2 on "
          f"{torch.cuda.device_count()} card(s): "
          f"{tr_pp['cli_exit'] or 'not checked (enough cards)'}")
    print(f"pp phase took {time.perf_counter() - t_phase:.1f} s")

    k2 = tt["k2"]
    k2_ops = sum(r["ops_ms"] for r in k2)
    k2_bytes = sum(r["bytes_ms"] for r in k2)
    k3_ops = sum(r["bound_ms"] for r in k3_rows if r["bound_by"]
                 == "operations")
    k3_bytes = sum(r["bound_ms"] for r in k3_rows if r["bound_by"]
                   == "bytes")

    serve_k1 = tm["k1"][0]
    print(json.dumps({"kernels": [{
        "name": "greedy_nms_keep",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/nms.cu",
        "replaces": "objectdetection_ssd_tpu/infer/nms_pallas.py:139 "
                    "(git eb1d1b7)",
        # Serving requests, cli eval's batches, the detect requests of
        # SSD300 and ResNet-34, the serving artifacts' chunks, the
        # data-parallel eval batches and the TP / SP ranks' batches.
        "launches": k1_launches,
        "max_abs_err": worst,
        # The serving shape; every shape's numbers are in per_shape.
        "ms": serve_k1["k1"]["event_ms"],
        "device_ms": serve_k1["k1"]["device_ms"],
        "host_ms": serve_k1["k1"]["host_ms"],
        "plain_ms": serve_k1["plain_ms"],
        "bound_ms": serve_k1["bound_ms"],
        "bound_by": serve_k1["bound_by"],
        "library_ms": None,
        "per_shape": [{
            "model": model, "shape": r["shape"], "ms": r["k1"]["event_ms"],
            "device_ms": r["k1"]["device_ms"], "host_ms": r["k1"]["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "all_pairs_bound_ms": r["all_pairs_bound_ms"],
            "valid_mean": r["valid_mean"], "valid_max": r["valid_max"],
            "library_ms": None}
            for model, rows in (("ssd300", tm["k1"]),
                                ("resnet34", rtm["k1"])) for r in rows],
    }, {
        "name": "dw_conv3x3p1",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/dw_conv3x3.cu",
        "replaces": "objectdetection_ssd_tpu/ops/dw_pallas.py:151",
        # The routed train steps, the remat phase's two steps, the
        # wrapped steps (DDP and FSDP2), rank 0 of the gloo leg, both
        # ranks of the TP and SP steps and the routed PP step.
        "launches": (tr["launches"] + rm["launches"]
                     + ps["ddp"]["launches"] + ps["fsdp"]["launches"]
                     + pt["launches"] + gl["launches"] + tps["k2"]
                     + pp["k2"]),
        "max_abs_err": dw_worst,
        # The four launches of one bf16 batch-32 train step, summed.
        "ms": sum(r["ms"] for r in k2),
        "plain_ms": sum(r["plain_ms"] for r in k2),
        "bound_ms": sum(r["bound_ms"] for r in k2),
        "bound_by": "operations" if k2_ops >= k2_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in k2),
        "per_shape": [{key: r[key] for key in (
            "conv", "shape", "kernel", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for r in k2],
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/int8_conv.cu",
        "replaces": "objectdetection_ssd_tpu/models/layers.py:124 "
                    "(Int8Conv, XLA)",
        # int8 serving requests (SSD300, ResNet-34, its flip TTA), the
        # QAT phase's cli eval and detect, the int8 artifact's chunks and
        # the TP / SP ranks' int8 forwards.
        "launches": k3_launches,
        "max_abs_err": iv["max_abs_err"],
        # The 23 launches of one batch-32 SSD300 int8 forward, summed.
        "ms": sum(r["ms"] for r in k3_rows),
        "host_ms": sum(r["host_ms"] for r in k3_rows),
        "plain_ms": sum(r["plain_ms"] for r in k3_rows),
        "bound_ms": sum(r["bound_ms"] for r in k3_rows),
        "bound_by": "operations" if k3_ops >= k3_bytes else "bytes",
        "library_ms": (None if any(r["library_ms"] is None for r in k3_rows)
                       else sum(r["library_ms"] for r in k3_rows)),
        "baseline_ms": ({name: sum(r["baselines"][name] for r in k3_rows)
                         for name in k3_baselines} or None),
        "per_shape": [dict({key: r[key] for key in (
            "conv", "shape", "out", "path", "tile", "patch", "smem",
            "registers", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "cudnn_bf16_ms")},
            baseline_ms=(next(iter(r["baselines"].values()))
                         if r["baselines"] else None))
            for r in k3_rows],
    }, {
        "name": "bias_relu",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/bias_relu.cu",
        "replaces": "none: the bias add of objectdetection_ssd_tpu/models/"
                    "layers.py:201 (TorchConv) and nn.relu of models/"
                    "backbones.py:97, which XLA fuses into the conv",
        "launches": k4_launches,
        "max_abs_err": br["max_abs_err"],
        # The 23 launches of one batch-256 bf16 SSD300 forward, summed.
        "ms": sum(r["ms"] for r in ssd_rows),
        "plain_ms": sum(r["plain_ms"] for r in ssd_rows),
        "bound_ms": sum(r["bound_ms"] for r in ssd_rows),
        "bound_by": "bytes",
        # No one PyTorch call adds a bias and applies ReLU; pair_ms is the
        # add_ + relu that the conv ran before.
        "library_ms": None,
        "pair_ms": sum(r["pair_ms"] for r in ssd_rows),
        "host_ms": br["host_ms"],
        "per_shape": [{key: r.get(key) for key in (
            "model", "conv", "shape", "ms", "plain_ms", "pair_ms",
            "bound_ms", "bound_by", "share", "conv_ms", "cudnn_relu_ms")}
            for r in br["rows"]],
    }, {
        "name": "max_pool",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/max_pool.cu",
        "replaces": "none: the max pools of objectdetection_ssd_tpu/models/"
                    "layers.py:249 (max_pool, lax.reduce_window), which XLA "
                    "lowers to one pass",
        "launches": k5_launches,
        "max_abs_err": mp["max_abs_err"],
        # The 5 launches of one batch-256 bf16 SSD300 forward, summed.
        "ms": sum(r["ms"] for r in k5_bf16),
        "plain_ms": sum(r["plain_ms"] for r in k5_bf16),
        "bound_ms": sum(r["bound_ms"] for r in k5_bf16),
        "bound_by": "bytes",
        # F.max_pool2d (which runs max_pool2d_with_indices on the card) on
        # the same inputs.
        "library_ms": sum(r["library_ms"] for r in k5_bf16),
        "int8_ms": sum(r["ms"] for r in k5_int8),
        "int8_plain_ms": sum(r["plain_ms"] for r in k5_int8),
        "int8_bound_ms": sum(r["bound_ms"] for r in k5_int8),
        "host_ms": mp["host_ms"],
        "per_shape": [{key: r[key] for key in (
            "model", "pool", "dtype", "shape", "geometry", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "share")}
            for r in mp["rows"]],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

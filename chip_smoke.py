#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`objectdetection_ssd_torch`) on one CUDA
card: builds every hand kernel (K1 greedy NMS, K2 the 3x3 filter
gradient, K3 the int8 conv), holds each against its plain PyTorch
version, serves SSD300
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
spills; a spill fails), K1 vs plain, K2 vs plain, the serving slice,
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
of both families calibrated on the card (K3 counted per forward, chained
== unchained, card vs CPU, flip TTA); int8 serving at batch 256 beside
bf16 and K3 per conv shape at batch 32 against its bound, cuDNN's bf16
conv, `torch._int_mm` and any `--k3-baseline`; QAT steps card vs CPU and
`cli train --qat` -> `eval` / `detect --int8` with the fingerprint
binding enforced.  Then the serving artifact (`infer/export.py`): SSD300
bf16, SSD300 int8 as `cli export --latency-profile` builds it and
ResNet-34 with flip TTA, each exported on the card, loaded and served
through `ExportedDetector` (== the live `detect_batch`, K1 once and K3 23
times per chunk), reloaded, moved to the CPU, and timed against the live
Detector with and without a CUDA graph; `torch.library.opcheck` of the
two custom ops; the MicroBatcher over 16 concurrent requests.
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
    launches)."""
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer import postprocess as pp
    from objectdetection_ssd_torch.ops import int8_conv
    nms_cuda.launches = 0
    int8_conv.launches = 0
    served = {b: det.detect_batch(x) for b, x in images.items()}
    if det.device.type == "cuda":
        torch.cuda.synchronize()
    launches, k3_launches = nms_cuda.launches, int8_conv.launches

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
    return launches, n_valid, n_suppressed, k3_launches


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

    launches, n_valid, n_suppressed, _ = serve_requests(det, images,
                                                        "SSD300")

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
            "suppressed": n_suppressed, "card_vs_cpu_rel": rel}


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
               seed: int = 0, quant_ste=None, conv_noise=None):
    """``conv_noise``: a generator; every conv output is then moved by one
    ulp up or down at random (a model of another summation order)."""
    from objectdetection_ssd_torch.config import OptimConfig
    from objectdetection_ssd_torch.models.layers import TorchConv
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state
    state = create_train_state(model_config, OptimConfig(), device=device,
                               state_dict=init_sd)
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
                  num_2012: int, image_size=(500, 375)) -> tuple:
    """A synthetic VOCdevkit (XML and ImageSets as `generate_voc` writes
    them, up to 8 objects, class-colour coded) whose pixels go straight into
    two packed caches instead of JPEG files: ``cache_prefix`` over the
    train split's paths in order and ``cache_prefix.val`` over the val
    split's, the split the CLI takes.  No PIL, no decode.  Returns (train
    records, val records)."""
    from objectdetection_ssd_torch.config import DataConfig
    from objectdetection_ssd_torch.data import cache, synthetic, voc
    pixels = {}
    synthetic.generate_voc(root, num_2007=num_2007, num_2012=num_2012,
                           image_size=image_size, max_objects=8, seed=SEED,
                           class_color_coding=True,
                           image_sink=pixels.__setitem__)
    records = voc.load_records(root, train=True)
    data = DataConfig()
    train_ids, val_ids = voc.train_val_split(len(records), data.val_fraction,
                                             data.split_seed)
    splits = ([records[i] for i in train_ids], [records[i] for i in val_ids])
    for recs, prefix in zip(splits, (cache_prefix, cache_prefix + ".val")):
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

    launches, n_valid, n_suppressed, _ = serve_requests(det, images,
                                                        "ResNet-34")
    if device.type == "cuda" and launches != len(batches):
        fail(f"K1 launched {launches} times for {len(batches)} ResNet-34 "
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
           "suppressed": n_suppressed, "card_vs_cpu_rel": rel, "opt_in": {}}
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
    k1, n_valid, n_suppressed, k3_launches = serve_requests(
        det_c, images, "SSD300 int8")
    if cuda and (k3_launches != SSD300_INT8_CONVS * len(batches)
                 or k1 != len(batches)):
        fail(f"{len(batches)} SSD300 int8 requests launched K3 "
             f"{k3_launches} times and K1 {k1} times")
    x = images[max(batches)]
    with torch.inference_mode():
        same = all(torch.equal(a, b) for a, b in
                   zip(det_c.forward(x), det_u.forward(x)))
    if not same:
        fail("SSD300 int8 chained != unchained")
    out["ssd300"] = {"k1": k1, "k3": k3_launches, "valid": n_valid,
                     "suppressed": n_suppressed}
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
    k1, n_valid, n_suppressed, k3_launches = serve_requests(
        det, images, "ResNet-34 int8")
    if cuda and (k3_launches != RESNET_INT8_CALLS * len(batches)
                 or k1 != len(batches)):
        fail(f"{len(batches)} ResNet-34 int8 requests launched K3 "
             f"{k3_launches} times and K1 {k1} times")
    out["resnet34"] = {"k1": k1, "k3": k3_launches, "valid": n_valid,
                       "suppressed": n_suppressed,
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
    launched once and K3 23 times (int8 SSD300) per chunk.  On the card
    also: `torch.library.opcheck` of both ops on CUDA tensors; the int8
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
    from objectdetection_ssd_torch.ops import int8_conv

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
                        state_dict, None, batch, ssd_images, 0),
        "ssd300_int8_latency": (latency, state_dict, qtree, 1,
                                ssd_images[:2], SSD300_INT8_CONVS),
        "resnet34_tta": (Config(model=resnet_config(),
                                postprocess=PostprocessConfig(
                                    tta_flip=True)),
                         resnet_state_dict, None, batch, r34_images, 0),
    }
    out = {"k1": 0, "k3": 0, "artifacts": {}}
    for name, (cfg, sd, tree, size, images, k3_per_chunk) in specs.items():
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
        got = served(images)
        again = ExportedDetector(path, device=device)(images)
        if on_card:
            torch.cuda.synchronize()
        k1, k3 = nms_cuda.launches, int8_conv.launches
        if on_card and (k1, k3) != (2 * chunks,
                                    2 * chunks * k3_per_chunk):
            fail(f"export {name}: {k1} K1 and {k3} K3 launches in "
                 f"{2 * chunks} chunks")
        out["k1"] += k1
        out["k3"] += k3
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
               "chunks": 2 * chunks, "k1": k1, "k3": k3,
               "valid": int(got.valid.sum()), "meta": served.meta,
               "ops": len(ops), "op_counts": {
                   key: ops.count(key) for key in (
                       "aten._assert_tensor_metadata.default",
                       "aten.to.dtype", "ssd.nms_keep.default",
                       "ssd.int8_conv.default")}}
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
    return out


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
    from objectdetection_ssd_torch.ops import dw_cuda
    from objectdetection_ssd_torch.ops import int8_conv

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
               "K3": int8_conv.SOURCE}
    for path in args.k1_baseline:
        sources[f"K1 baseline {path.stem}"] = path.resolve()
    for path in args.k3_baseline:
        sources[f"K3 baseline {path.stem}"] = path.resolve()
    t0 = time.perf_counter()
    cuda_build.compile_sources(sources.values())
    nms_cuda.build()
    dw_cuda.build()
    int8_conv.build()
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
    sl = phase_slice(device, sd)
    if sl["launches"] < len(SERVE_BATCHES):
        fail(f"K1 launched {sl['launches']} times on the main path")
    print(f"slice: detect_batch f32 on {list(SERVE_BATCHES)}: valid "
          f"{sl['valid']}, suppressed {sl['suppressed']}, K1 launches "
          f"{sl['launches']}, kernel == plain-NMS detections, card vs CPU "
          f"loc/conf {sl['card_vs_cpu_rel']:.3e} of scale")

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
    rsd = seeded_resnet_state_dict()
    rs = phase_resnet_slice(device, rsd)
    print(f"resnet34 slice: detect_batch bf16 {RESNET_SIZE} px on "
          f"{list(SERVE_BATCHES)}: valid {rs['valid']}, suppressed "
          f"{rs['suppressed']}, K1 launches {rs['launches']}, kernel == "
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
    rtr = phase_resnet_trainer(device)
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
          f"{a['k3']} ({SSD300_INT8_CONVS} per forward), K1 {a['k1']}, "
          f"kernel == plain-NMS detections, chained == unchained bit for "
          f"bit; f32 int8 card vs CPU loc/conf {a['card_vs_cpu_rel']:.3e} "
          f"of scale")
    print(f"int8 slice: ResNet-34 {b['convs']} convs, unchained bf16 "
          f"detect_batch on {list(INT8_SERVE_BATCHES)}: valid {b['valid']}, "
          f"suppressed {b['suppressed']}, K3 launches {b['k3']} "
          f"({RESNET_INT8_CALLS} per forward), K1 {b['k1']}; flip TTA K3 "
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
              f"K3 {r['k3']}, valid {r['valid']}{cpu}; the program: "
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
          f"passed for ssd::nms_keep and ssd::int8_conv on CUDA tensors; "
          f"the phase took {time.perf_counter() - t_phase:.1f} s")
    k1_launches += ex["k1"]
    k3_launches += ex["k3"]

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
        # SSD300 and ResNet-34 and the serving artifacts' chunks.
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
        # The routed train steps and the remat phase's two steps.
        "launches": tr["launches"] + rm["launches"],
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
        # QAT phase's cli eval and detect and the int8 artifact's chunks.
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
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

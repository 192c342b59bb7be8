#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`objectdetection_ssd_torch`) on one CUDA
card: builds every hand kernel (K1 greedy NMS, K2 the 3x3 filter
gradient), holds each against its plain PyTorch version, serves SSD300
requests through `Detector`, takes SSD300 train steps with K2 on the
routed convs, times both paths, and drives the training entry point
(Loader, Trainer, checkpoints and resume, `cli eval`, `Detector.
from_checkpoint`) on a synthetic VOC fixture held in packed caches.

    python3 chip_smoke.py          # from the repo root, one card, nvcc

    python3 chip_smoke.py --k1-baseline OLD.cu   # also time other K1
                                                 # sources (repeatable) on
                                                 # the same inputs

Phases, one line each: device, build (each kernel's registers and
spills; a spill fails), K1 vs plain, K2 vs plain, the serving slice,
serving timing (K1 at the serving and the exact-eval shape: device time
per launch from torch.profiler, host time per call, CUDA-event time,
valid counts, bounds), the train slice (with the routed conv's dX
layout), the frozen-conv1 step, train timing (with a bf16
routed-vs-unrouted gradient check and a profile of both steps), the
trainer slice (the Loader alone, three epochs of `Trainer.fit`, resume,
`cli eval` with K1 launched for every batch, detect from the checkpoint,
no fall-through from the native data library).  Then
one JSON line with each kernel's numbers, the card's name and power
limit as nvidia-smi gives them, and as the last line ``{"ok": true,
"device": {...}}``.  Any failed check exits non-zero before that line.
Without CUDA it exits 1 at once.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
TIMING_BATCH = 256
# K1 vs plain on random (non-prefix) validity masks: the serving K, the
# exact-eval K, and K across the word and warp boundaries.
NMS_SHAPES = ((256, 20, 64), (8, 20, 200), (256, 20, 200), (4, 20, 1),
              (4, 20, 33), (4, 20, 65), (4, 20, 256))
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


def phase_slice(device, state_dict, batches=SERVE_BATCHES,
                cpu_check_batch: int = 2) -> dict:
    """Serve detect_batch requests in f32 (TF32 off) and check them."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.infer import postprocess as pp
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.models.ssd import build_model

    det = Detector(Config(), state_dict, device=device)
    gen = torch.Generator().manual_seed(SEED + 1)
    images = {b: torch.randint(0, 256, (b, 300, 300, 3), generator=gen,
                               dtype=torch.uint8).to(device)
              for b in batches}

    # The main path: counts set to 0 just before, read just after.
    nms_cuda.launches = 0
    served = {b: det.detect_batch(images[b]) for b in batches}
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = nms_cuda.launches

    n_valid, n_suppressed = {}, 0
    for b in batches:
        d = served[b]
        if d.boxes_xyxy.shape != (b, 200, 4) or not torch.isfinite(
                d.boxes_xyxy).all() or not torch.isfinite(d.scores).all():
            fail(f"detect_batch({b}) gave malformed detections")
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
            fail(f"batch {b}: kernel-path detections != plain-NMS path")
    if n_suppressed == 0 or min(n_valid.values()) == 0:
        fail(f"the slice gave NMS no work ({n_valid}, {n_suppressed})")

    # The card's loc/conf against the same model on the CPU.
    x = images[max(batches)][:cpu_check_batch]
    loc, conf = det.forward(x)
    cpu_model = build_model(ModelConfig(), device="cpu")
    cpu_model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        cloc, cconf = cpu_model(x.cpu())
    rel = max(float((loc.cpu() - cloc).abs().max() / cloc.abs().max()),
              float((conf.cpu() - cconf).abs().max() / cconf.abs().max()))
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


def synthetic_batch(batch: int, gen: torch.Generator) -> dict:
    """A dense train batch: uint8 images and 1..MAX_BOXES boxes per image
    (normalized xyxy, classes 0..19), the rest padded rows."""
    images = torch.randint(0, 256, (batch, 300, 300, 3), generator=gen,
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


def _train_run(device, model_config, init_sd, batches, priors):
    from objectdetection_ssd_torch.config import OptimConfig
    from objectdetection_ssd_torch.train.loop import train_step
    from objectdetection_ssd_torch.train.state import create_train_state
    state = create_train_state(model_config, OptimConfig(), device=device,
                               state_dict=init_sd)
    losses = []
    for batch in batches:
        state, metrics = train_step(state, batch, priors)
        losses.append(float(metrics["loss"]))
    return state, losses


def phase_train_slice(device, steps: int = TRAIN_STEPS,
                      batch: int = TRAIN_BATCH, cpu_check: bool = True
                      ) -> dict:
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
           "loss_rel": 0.0, "delta_rel": 0.0, "delta_norm_rel": 0.0,
           "delta_worst": None,
           "wgrad_rel": 0.0, "dx_rel": routed_dx_check(device, batch)}
    if not cpu_check:
        return out

    cpu_state, cpu_losses = _train_run(torch.device("cpu"), routed, init_sd,
                                       batches, priors)
    out["loss_rel"] = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, cpu_losses))
    if not out["loss_rel"] <= TRAIN_LOSS_RTOL:
        fail(f"card vs CPU losses {losses} vs {cpu_losses}")
    cpu_params = dict(cpu_state.model.named_parameters())
    rows = []
    for name, p in state.model.named_parameters():
        want = cpu_params[name].detach() - init_sd[name]
        got = p.detach().cpu() - init_sd[name]
        diff, scale = float((got - want).abs().max()), float(
            want.abs().max())
        norm = float((got - want).norm() / want.norm()) if scale > 0 else 0.0
        # A parameter that no gradient reached must not move on the card.
        rel = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
        rows.append((rel, norm, name))
    rows.sort(key=lambda r: -r[0] if math.isfinite(r[0]) else -math.inf)
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
    m = re.search(r"(?:dw|nms)_[a-z_]*kernel(?:I\w*?EE)?", function)
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

    def step(x):
        # Each step consumes the previous step's detections, so steps
        # cannot overlap or be skipped (bench.py:100-118).
        dets = det.detect_batch(x)
        s = dets.scores.sum() * 1e-9
        return x * (1.0 + s * 1e-6)

    for _ in range(3):
        x = step(x)
    float(x.float().sum())
    n_iters, best = 10, float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            x = step(x)
        float(x.float().sum())                      # fence
        best = min(best, (time.perf_counter() - t0) / n_iters)

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k1-baseline", type=Path, action="append",
                        default=[],
                        help="another K1 source with the same C interface, "
                             "timed beside the repo's K1 on the same inputs "
                             "(repeatable)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from objectdetection_ssd_torch import cuda_build
    from objectdetection_ssd_torch.infer import nms_cuda
    from objectdetection_ssd_torch.ops import dw_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    # Build from the checkout's sources, not from an earlier build: one
    # nvcc per source, all started together.
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    sources = {"K1": nms_cuda.SOURCE, "K2": dw_cuda.SOURCE}
    for path in args.k1_baseline:
        sources[f"K1 baseline {path.stem}"] = path.resolve()
    t0 = time.perf_counter()
    cuda_build.compile_sources(sources.values())
    nms_cuda.build()
    dw_cuda.build()
    build_s = time.perf_counter() - t0
    k1_baselines = {path.stem: k1_library_launcher(path.resolve())
                    for path in args.k1_baseline}
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
        top = sorted(p["ops"].items(), key=lambda kv: -kv[1])[:10]
        print(f"profile: {key} bf16 step ({PROFILE_STEPS} steps, "
              f"torch.profiler): device ops {p['device_ms']:.3f} ms/step, "
              f"host {p['wall_ms']:.3f} ms/step under the profiler; top 10: "
              + "; ".join(f"{ms:.3f} ms {name[:90]}" for name, ms in top))
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

    k2 = tt["k2"]
    k2_ops = sum(r["ops_ms"] for r in k2)
    k2_bytes = sum(r["bytes_ms"] for r in k2)

    serve_k1 = tm["k1"][0]
    print(json.dumps({"kernels": [{
        "name": "greedy_nms_keep",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/nms.cu",
        "replaces": "objectdetection_ssd_tpu/infer/nms_pallas.py:139 "
                    "(git eb1d1b7)",
        # Serving requests, cli eval's batches and the detect request.
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
            "shape": r["shape"], "ms": r["k1"]["event_ms"],
            "device_ms": r["k1"]["device_ms"], "host_ms": r["k1"]["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "all_pairs_bound_ms": r["all_pairs_bound_ms"],
            "valid_mean": r["valid_mean"], "valid_max": r["valid_max"],
            "library_ms": None} for r in tm["k1"]],
    }, {
        "name": "dw_conv3x3p1",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/dw_conv3x3.cu",
        "replaces": "objectdetection_ssd_tpu/ops/dw_pallas.py:151",
        "launches": tr["launches"],
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
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

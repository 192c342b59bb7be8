#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`objectdetection_ssd_torch`) on one CUDA
card: builds every hand kernel (K1 greedy NMS, K2 the 3x3 filter
gradient), holds each against its plain PyTorch version, serves SSD300
requests through `Detector`, takes SSD300 train steps with K2 on the
routed convs, and times both paths.

    python3 chip_smoke.py          # from the repo root, one card, nvcc

Phases, one line each: device, build, K1 vs plain, K2 vs plain, the
serving slice, serving timing, the train slice, the frozen-conv1 step,
train timing.  Then one JSON line with each kernel's numbers, the card's
name and power limit as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  Without CUDA it exits 1 at once.  It imports no JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
SERVE_BATCHES = (1, 8, 256)     # detect_batch request sizes in the slice
TIMING_BATCH = 256
NMS_SHAPES = ((256, 20, 64), (8, 20, 200))   # serving K, exact-eval K
THR = 0.45
# K2 shapes (N, H, W, Cin, Cout): conv1_1, conv1_2, conv2_1, conv2_2 of
# SSD300 at the train slice's batch, and one ragged shape.
ROUTED = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
TRAIN_BATCH = 2
TRAIN_STEPS = 3
TIMING_TRAIN_BATCH = 32
MAX_BOXES = 24


def dw_shapes(batch: int) -> tuple:
    return ((batch, 300, 300, 3, 64), (batch, 300, 300, 64, 64),
            (batch, 150, 150, 64, 128), (batch, 150, 150, 128, 128))


DW_SHAPES = dw_shapes(TRAIN_BATCH) + ((3, 37, 41, 5, 7),)
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
        if expected is None and not (valid & ~kern).any():
            fail(f"nothing suppressed in {name}: the check is vacuous")
        if boxes.shape[-2] == 200 or expected is not None:
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


def phase_dw_vs_plain(device, shapes=DW_SHAPES, seed: int = SEED) -> list:
    """K2 against its plain version on the same card tensors, in f32 and
    bf16, at ``shapes``; fails past `DW_TOL`."""
    from objectdetection_ssd_torch.ops import dw_cuda
    gen = torch.Generator().manual_seed(seed + 3)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w, cin, cout in shapes:
            x = torch.randn(n, h, w, cin, generator=gen).relu()
            g = torch.randn(n, h, w, cout, generator=gen) * 1e-3
            x, g = x.to(device, dtype), g.to(device, dtype)
            kern = dw_cuda.dw_conv3x3p1(x, g)
            plain = dw_cuda.dw_conv3x3p1_plain(x, g)
            err = float((kern - plain).abs().max())
            scale = float(plain.abs().max())
            rel = err / scale
            if not (scale > 0 and math.isfinite(err) and rel <= DW_TOL[dtype]):
                fail(f"K2 {dtype} {(n, h, w, cin, cout)}: {rel:.3e} of "
                     f"max|dW| {scale:.3e} differs from the plain version")
            rows.append({"dtype": str(dtype).replace("torch.", ""),
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
    out = {"losses": losses, "launches": launches, "layout_copies": copies,
           "loss_rel": 0.0, "delta_rel": 0.0, "delta_norm_rel": 0.0,
           "delta_worst": None,
           "wgrad_rel": 0.0}
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


def phase_train_timing(batch: int = TIMING_TRAIN_BATCH) -> dict:
    """bf16 train steps at ``batch`` with the four convs routed and with
    dw_pallas_convs=(): 4 windows of 10 steps each, in turns (routed,
    plain, plain, routed, twice), the median window per configuration;
    then K2, its plain version and cuDNN's wgrad at each routed conv's
    shape."""
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
    del states

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
        rows.append({"conv": conv, "shape": [n, h, w, cin, cout], "ms": ms,
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
            "launches_per_step": launches_per_step, "k2": rows}


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


def nms_bound_ms(sets: int, k: int) -> tuple:
    """Least time for K1's work: bytes (boxes + valid in, keep out, each
    once) over HBM rate, or the f32 operations of the pairwise tests
    (13 per pair, 3 per box area) over the non-tensor f32 peak."""
    bytes_moved = sets * k * (16 + 1 + 1)
    ops = sets * (k * (k - 1) // 2 * 13 + 3 * k)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_timing(state_dict) -> dict:
    """bf16, channels_last, batch 256: end to end with bench.py's chained
    dependency, forward alone, postprocess alone, and K1 alone."""
    from objectdetection_ssd_torch.config import Config, ModelConfig
    from objectdetection_ssd_torch.infer import nms_cuda
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

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: det.forward(x), iters=10)
        loc, conf = det.forward(x)
        pp_ms = cuda_ms(lambda: pp.postprocess(loc, conf, det.priors,
                                               det.pp_config), iters=20)
        cand, _, valid = pp.select_candidates(loc, conf, det.priors,
                                              det.pp_config)
        k1_ms = cuda_ms(lambda: nms_cuda.greedy_nms_keep(cand, valid, THR),
                        iters=200)
        plain_ms = cuda_ms(lambda: plain_keep(cand, valid), iters=5,
                           warmup=1)
    sets, k = valid.numel() // valid.shape[-1], valid.shape[-1]
    bound_ms, bound_by = nms_bound_ms(sets, k)
    flops = conv_flops_per_image(det.model, x[:1]) * TIMING_BATCH
    return {"images_per_s": TIMING_BATCH / best, "step_ms": best * 1e3,
            "forward_ms": fwd_ms, "postprocess_ms": pp_ms,
            "forward_tflops": flops / (fwd_ms * 1e-3) / 1e12,
            "gflop_per_image": flops / TIMING_BATCH / 1e9,
            "k1_ms": k1_ms, "k1_plain_ms": plain_ms,
            "k1_bound_ms": bound_ms, "k1_bound_by": bound_by,
            "k1_shape": [*valid.shape]}


def main() -> int:
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
    t0 = time.perf_counter()
    cuda_build.compile_sources(sources.values())
    nms_cuda.build()
    dw_cuda.build()
    build_s = time.perf_counter() - t0
    for kid, src in sources.items():
        ptxas = [ln.strip() for ln in cuda_build.library_path(
            src).with_suffix(".log").read_text().splitlines()
            if "registers" in ln]
        print(f"build: {kid} {src.name}: {'; '.join(ptxas)}")
    print(f"build: K1 and K2 in {build_s:.2f} s (parallel nvcc)")

    worst = phase_kernel_vs_plain(device)
    print(f"kernel vs plain: K1 keep masks bit-equal on random "
          f"{list(NMS_SHAPES)} and crafted sets (max_abs_err {worst})")

    dw_rows = phase_dw_vs_plain(device)
    for r in dw_rows:
        print(f"kernel vs plain: K2 {r['dtype']} {r['shape']}: max_abs_err "
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
          f"K2 vs cuDNN wgrad dW {tr['wgrad_rel']:.3e} of max|dW|")
    fr = phase_frozen_step(device)
    print(f"train slice: freeze_stages=1 step: K2 launches {fr['launches']} "
          f"(conv2_1, conv2_2), conv1 gradients none, conv2 gradients "
          f"present")

    tm = phase_timing(sd)
    print(f"timing: bf16 channels_last batch {TIMING_BATCH} ({smi}): "
          f"{tm['images_per_s']:.1f} images/s end to end "
          f"({tm['step_ms']:.3f} ms/step), forward {tm['forward_ms']:.3f} ms"
          f" ({tm['gflop_per_image']:.2f} GFLOP/image of convs, "
          f"{tm['forward_tflops']:.1f} TFLOP/s, "
          f"{tm['forward_tflops'] / 989 * 100:.1f}% of the 989 TFLOP/s bf16 "
          f"peak), postprocess {tm['postprocess_ms']:.3f} ms, K1 "
          f"{tm['k1_ms'] * 1e3:.2f} us at {tm['k1_shape']} (bound "
          f"{tm['k1_bound_ms'] * 1e3:.2f} us by {tm['k1_bound_by']}, plain "
          f"{tm['k1_plain_ms'] * 1e3:.1f} us); library_ms null: no PyTorch "
          f"call computes fixed-shape batched greedy NMS")

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
    for r in tt["k2"]:
        print(f"train timing: K2 {r['conv']} {r['shape']} bf16: "
              f"{r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.1f} us "
              f"by {r['bound_by']}; {r['gflop']:.1f} GFLOP, "
              f"{r['mbytes']:.1f} MB), plain {r['plain_ms'] * 1e3:.1f} us, "
              f"cuDNN wgrad (library) {r['library_ms'] * 1e3:.1f} us, "
              f"kernel vs plain {r['rel']:.3e} of max|dW|")
    k2 = tt["k2"]
    k2_ops = sum(r["ops_ms"] for r in k2)
    k2_bytes = sum(r["bytes_ms"] for r in k2)

    print(json.dumps({"kernels": [{
        "name": "greedy_nms_keep",
        "route": "cuda",
        "source": "objectdetection_ssd_torch/csrc/nms.cu",
        "replaces": "objectdetection_ssd_tpu/infer/nms_pallas.py:139 "
                    "(git eb1d1b7)",
        "launches": sl["launches"],
        "max_abs_err": worst,
        "ms": tm["k1_ms"],
        "plain_ms": tm["k1_plain_ms"],
        "bound_ms": tm["k1_bound_ms"],
        "bound_by": tm["k1_bound_by"],
        "library_ms": None,
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
            "conv", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in k2],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

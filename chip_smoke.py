#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`objectdetection_ssd_torch`) on one CUDA
card: builds every hand kernel of the serving path, holds each against its
plain PyTorch version, serves SSD300 requests through `Detector`, and times
the path.

    python3 chip_smoke.py          # from the repo root, one card, nvcc

Phases, one line each: device, build, kernel vs plain, the slice, timing.
Then one JSON line with each kernel's numbers, the card's name and power
limit as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  Without CUDA it exits 1 at once.  It imports no JAX.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import torch

SEED = 0
SERVE_BATCHES = (1, 8, 256)     # detect_batch request sizes in the slice
TIMING_BATCH = 256
NMS_SHAPES = ((256, 20, 64), (8, 20, 200))   # serving K, exact-eval K
THR = 0.45
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, non-tensor f32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    from objectdetection_ssd_torch.infer import nms_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    # Build from the checkout's source, not from an earlier build.
    shutil.rmtree(nms_cuda.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    nms_cuda.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in nms_cuda.library_path().with_suffix(
        ".log").read_text().splitlines() if "registers" in ln]
    print(f"build: K1 {nms_cuda.SOURCE.name} in {build_s:.2f} s; "
          f"{'; '.join(ptxas)}")

    worst = phase_kernel_vs_plain(device)
    print(f"kernel vs plain: K1 keep masks bit-equal on random "
          f"{list(NMS_SHAPES)} and crafted sets (max_abs_err {worst})")

    sd = seeded_state_dict()
    sl = phase_slice(device, sd)
    if sl["launches"] < len(SERVE_BATCHES):
        fail(f"K1 launched {sl['launches']} times on the main path")
    print(f"slice: detect_batch f32 on {list(SERVE_BATCHES)}: valid "
          f"{sl['valid']}, suppressed {sl['suppressed']}, K1 launches "
          f"{sl['launches']}, kernel == plain-NMS detections, card vs CPU "
          f"loc/conf {sl['card_vs_cpu_rel']:.3e} of scale")

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
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

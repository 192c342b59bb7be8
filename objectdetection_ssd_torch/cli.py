"""Command-line interface: train / eval / detect / export — the port of
`objectdetection_ssd_tpu/cli.py` for the ported features, on one CUDA card
(``--device cpu`` runs on the CPU).

Usage:
  python -m objectdetection_ssd_torch.cli train --voc-root VOCdevkit --epochs 5
  python -m objectdetection_ssd_torch.cli eval --voc-root VOCdevkit
  python -m objectdetection_ssd_torch.cli detect img1.jpg img2.jpg
  python -m objectdetection_ssd_torch.cli export --out-dir artifact

Both model families (``--backbone vgg16 | resnet34``), remat, Soft-NMS
and flip TTA, the ``--init-*`` weight loaders, int8 serving (``eval`` /
``detect --int8``, on kernel K3), QAT (``train --qat``) and the serving
artifact (``export``, ``--latency-profile``; `infer/export.py`) are
ported.  Flags of features that are not ported yet (the mesh and pipeline
strategies, TensorBoard, profiling, ``--draw``, ``doctor``) are not
accepted.

This module imports no torch at import time: the Loader's spawn workers
import the ``__main__`` module, which is this one under ``python -m``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from objectdetection_ssd_torch import config as config_lib


def _common_flags(p: argparse.ArgumentParser):
    p.add_argument("--voc-root", default="VOCdevkit")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--backbone", choices=["vgg16", "resnet34"], default=None)
    p.add_argument("--parity-split", action="store_true",
                   help="replicate the reference's with-replacement val split")
    p.add_argument("--allow-partial-voc", action="store_true",
                   help="proceed when a whole VOC year's list file is "
                        "missing (default: hard error)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (params stay f32)")
    p.add_argument("--transfer-dtype", choices=["uint8", "float32"],
                   default=None,
                   help="image batch dtype shipped to the card (default "
                        "uint8: raw pixels, normalized on the card)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic VOC fixture at --voc-root "
                        "(for smoke tests without the dataset)")
    p.add_argument("--nms-method",
                   choices=["hard", "soft_gaussian", "soft_linear"],
                   default=None,
                   help="NMS flavor (default hard = reference parity; "
                        "soft_* decays overlapping candidates' scores "
                        "instead of dropping them — Soft-NMS)")
    p.add_argument("--soft-nms-sigma", type=float, default=None,
                   help="gaussian decay width for --nms-method "
                        "soft_gaussian (default 0.5)")
    p.add_argument("--tta-flip", action="store_true",
                   help="test-time augmentation: also run the horizontal "
                        "mirror of each image and merge both views (costs "
                        "a second forward)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="per-update EMA of the weights, e <- d*e + (1-d)*p "
                        "(0 = off); eval/detect read it with --use-ema")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")


def build_config(args) -> config_lib.Config:
    cfg = config_lib.Config()
    data_kw = {"voc_root": args.voc_root,
               "parity_split": args.parity_split,
               "allow_partial_voc": getattr(args, "allow_partial_voc",
                                            False)}
    if args.batch_size is not None:
        data_kw["batch_size"] = args.batch_size
    if args.num_workers is not None:
        data_kw["num_workers"] = args.num_workers
    if getattr(args, "transfer_dtype", None):
        data_kw["transfer_dtype"] = args.transfer_dtype
    if getattr(args, "image_cache", None):
        data_kw["image_cache"] = args.image_cache
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    train_kw = {}
    if args.checkpoint_dir is not None:
        train_kw["checkpoint_dir"] = args.checkpoint_dir
    if getattr(args, "device_prefetch", None) is not None:
        train_kw["device_prefetch"] = args.device_prefetch
    if getattr(args, "ema_decay", None) is not None:
        train_kw["ema_decay"] = args.ema_decay
    if getattr(args, "remat", False):
        train_kw["remat"] = True
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    if args.backbone is not None:
        image_size = 300 if args.backbone == "vgg16" else 224
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, backbone=args.backbone, image_size=image_size))
    if getattr(args, "bf16", False):
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
    if getattr(args, "freeze_trunk_stages", None):
        if cfg.model.backbone != "vgg16":
            raise SystemExit(
                "--freeze-trunk-stages is a VGG-16 stage control; the "
                "resnet34 backbone freezes its whole trunk by default "
                "(ModelConfig.freeze_backbone)")
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, freeze_stages=args.freeze_trunk_stages))
    optim_kw = {}
    if getattr(args, "grad_accum", 0) and args.grad_accum > 1:
        optim_kw["grad_accum_steps"] = args.grad_accum
    if getattr(args, "lr", None) is not None:
        optim_kw["lr"] = args.lr
    if getattr(args, "warmup_steps", None) is not None:
        optim_kw["warmup_steps"] = args.warmup_steps
    if getattr(args, "no_lr_decay", False):
        optim_kw["use_lr_schedule"] = False
    if optim_kw:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, **optim_kw))
    if getattr(args, "hnm_topk", None) is not None:
        cfg = cfg.replace(loss=dataclasses.replace(
            cfg.loss, hnm_topk=args.hnm_topk))
    if getattr(args, "latency_profile", False):
        # The JAX package's serving preset (`cli.py:142-152`): per-class
        # candidates 32 and int8; `cmd_export` also defaults the artifact's
        # batch to 1.  The flags below still override their pieces.
        cfg = cfg.replace(
            postprocess=dataclasses.replace(cfg.postprocess,
                                            per_class_top_k=32),
            quant=dataclasses.replace(cfg.quant, int8=True))
    pp_kw = {}
    if getattr(args, "nms_method", None) is not None:
        pp_kw["nms_method"] = args.nms_method
    if getattr(args, "soft_nms_sigma", None) is not None:
        pp_kw["soft_nms_sigma"] = args.soft_nms_sigma
    if getattr(args, "tta_flip", False):
        pp_kw["tta_flip"] = True
    if pp_kw:
        cfg = cfg.replace(postprocess=dataclasses.replace(
            cfg.postprocess, **pp_kw))
    q_kw = {}
    if getattr(args, "int8", False):
        q_kw["int8"] = True
    if getattr(args, "int8_calib_images", None) is not None:
        q_kw["calib_images"] = args.int8_calib_images
    if getattr(args, "int8_quantize_heads", False):
        q_kw["quantize_heads"] = True
    if getattr(args, "no_int8_chain", False):
        q_kw["chain_requant"] = False
    if getattr(args, "recalibrate", False):
        q_kw["recalibrate"] = True
    if getattr(args, "qat", False):
        q_kw["qat"] = True
    if q_kw:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, **q_kw))
    return cfg


def _build_quant(cfg: config_lib.Config, weights, device,
                 records=None, image_paths=None):
    """The int8 scale tree for ``--int8`` (None when it is off).

    A ``quant_scales.json`` in the checkpoint directory (written by
    ``train --qat``) is used when its fingerprint matches ``weights``; one
    that does not is a hard error, and ``--recalibrate`` ignores the file.
    Otherwise the scales are calibrated on ``weights`` from ``records``
    (eval: the train split, the usual PTQ recipe) or ``image_paths``
    (detect: its own input images)."""
    if not cfg.quant.int8:
        return None
    import os
    import numpy as np
    from objectdetection_ssd_torch.data import pipeline as data_pipeline
    from objectdetection_ssd_torch.infer import quant as quant_lib
    from objectdetection_ssd_torch.models.ssd import build_model
    saved = os.path.join(cfg.train.checkpoint_dir, quant_lib.SCALES_FILENAME)
    if os.path.exists(saved) and not cfg.quant.recalibrate:
        try:
            quant_lib.verify_scales_binding(saved, weights)
        except ValueError as e:
            raise SystemExit(f"error: {e}")
        qtree = quant_lib.load_scales(saved)
        # A QAT run saves the chained tree: --no-int8-chain strips it.
        qtree = (quant_lib.chain_scales(qtree, cfg.model.backbone)
                 if cfg.quant.chain_requant
                 else quant_lib.unchain_scales(qtree))
        print(f"int8: using QAT-trained scales from {saved} "
              f"({quant_lib.count_quantized(qtree)} convs)", file=sys.stderr)
        return qtree
    paths = (image_paths if image_paths is not None
             else [r.image_path for r in records])
    n = max(1, min(cfg.quant.calib_images, len(paths)))
    paths = paths[:n]
    size = cfg.model.image_size
    u8 = cfg.data.transfer_dtype == "uint8"
    bs = min(cfg.data.batch_size, n)

    def batches():
        for start in range(0, n, bs):
            imgs = []
            for p in paths[start:start + bs]:
                img = data_pipeline.preprocess_image(
                    data_pipeline.load_image(p), size, normalize=not u8)
                imgs.append(data_pipeline.quantize_uint8(img) if u8 else img)
            while len(imgs) < bs:           # one batch shape, as in JAX
                imgs.append(imgs[-1])
            yield np.stack(imgs)

    # The float model the Detector quantizes: f32 weights, compute dtype.
    model = build_model(cfg.model, device=device, train=True)
    model.load_state_dict(weights, strict=True)
    stats = quant_lib.calibrate(model, batches())
    del model
    qtree = quant_lib.act_scales(stats,
                                 quantize_heads=cfg.quant.quantize_heads)
    if cfg.quant.chain_requant:
        qtree = quant_lib.chain_scales(qtree, cfg.model.backbone)
    print(f"int8: calibrated {quant_lib.count_quantized(qtree)} convs "
          f"on {n} images", file=sys.stderr)
    return qtree


def _int8_flags(p: argparse.ArgumentParser):
    """int8 serving flags (eval / detect)."""
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization of the conv stack "
                        "(kernel K3; calibrates activation scales first, "
                        "see infer/quant.py)")
    p.add_argument("--int8-calib-images", type=int, default=None,
                   metavar="N",
                   help="calibration set size (default 64; eval draws from "
                        "the train split, detect from the input images)")
    p.add_argument("--int8-quantize-heads", action="store_true",
                   help="also quantize the loc/conf heads (default keeps "
                        "them float, the usual PTQ accuracy recipe)")
    p.add_argument("--no-int8-chain", action="store_true",
                   help="disable the int8 requant chain (consecutive "
                        "quantized convs passing int8 directly, bit-exact; "
                        "default on; this flag exists for A/B measurement)")
    p.add_argument("--recalibrate", action="store_true",
                   help="ignore the checkpoint dir's saved "
                        "quant_scales.json and calibrate fresh activation "
                        "scales (the escape when its param fingerprint no "
                        "longer matches the checkpoint)")


def _load_init_weights(args, cfg: config_lib.Config):
    """The state_dict entries an ``--init-*`` flag names, converted to the
    port's names (`models/convert.py`), or None.  The reference's recipe
    starts from torchvision trunks (`Model.py:131-161` VGG-16,
    `Model.py:21-30` ResNet-34) or from one of its own checkpoints
    (`train_function.py:23-34`)."""
    if not (args.init_torch_vgg16 or args.init_torch_resnet34
            or args.init_reference_ckpt):
        return None
    import torch
    from objectdetection_ssd_torch.models import convert

    def _state_dict(path):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        return obj.state_dict() if hasattr(obj, "state_dict") else obj

    if args.init_torch_vgg16:
        if cfg.model.backbone != "vgg16":
            raise SystemExit("--init-torch-vgg16 requires --backbone vgg16")
        return convert.vgg16_trunk_params(_state_dict(args.init_torch_vgg16))
    if args.init_torch_resnet34:
        if cfg.model.backbone != "resnet34":
            raise SystemExit(
                "--init-torch-resnet34 requires --backbone resnet34")
        return convert.resnet34_trunk_params(
            _state_dict(args.init_torch_resnet34))
    if cfg.model.backbone != "vgg16":
        raise SystemExit("--init-reference-ckpt requires --backbone vgg16")
    return convert.load_reference_checkpoint(args.init_reference_ckpt)


def _eval_weights(state):
    """Weights the in-training mAP eval (--eval-map-every) scores: the EMA
    average when --ema-decay is on (the weights --use-ema serves), the raw
    ones otherwise; as a state_dict."""
    weights = state.model.state_dict()
    if state.ema is not None:
        weights = {**weights, **state.ema}
    return weights


def _load_split(cfg: config_lib.Config, args):
    from objectdetection_ssd_torch.data import synthetic, voc
    if args.synthetic:
        synthetic.generate_voc(cfg.data.voc_root, num_2007=32, num_2012=16)
    records = voc.load_records(cfg.data.voc_root, train=True,
                               num_workers=cfg.data.num_workers,
                               allow_partial=cfg.data.allow_partial_voc)
    train_ids, val_ids = voc.train_val_split(
        len(records), cfg.data.val_fraction, cfg.data.split_seed,
        parity=cfg.data.parity_split)
    return ([records[i] for i in train_ids],
            [records[i] for i in val_ids])


def _restore_params(cfg: config_lib.Config, allow_random_init: bool = False,
                    use_ema: bool = False):
    """The latest checkpoint's weights (the EMA average with
    ``use_ema``) as a state_dict on the CPU.

    Exits when no checkpoint exists unless ``--allow-random-init`` was
    passed: a typo'd --checkpoint-dir must not silently eval/detect with
    random weights."""
    from objectdetection_ssd_torch.infer.detector import checkpoint_weights
    try:
        weights, epoch = checkpoint_weights(cfg, None, allow_random_init,
                                            use_ema)
    except FileNotFoundError:
        raise SystemExit(
            f"error: no checkpoint found under "
            f"{cfg.train.checkpoint_dir!r} (use --allow-random-init to "
            "run with fresh random weights)")
    except ValueError:
        raise SystemExit(
            "error: --use-ema needs an EMA-enabled checkpoint — train with "
            "--ema-decay > 0")
    if epoch is None:
        print("no checkpoint found; using random init", file=sys.stderr)
    else:
        print(f"restored checkpoint epoch {epoch}", file=sys.stderr)
    return weights


def cmd_train(args) -> int:
    from objectdetection_ssd_torch.data.pipeline import Loader
    from objectdetection_ssd_torch.train.trainer import Trainer
    cfg = build_config(args)
    if args.epochs is not None:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, num_epochs=args.epochs))
    init_state_dict = _load_init_weights(args, cfg)
    train_recs, val_recs = _load_split(cfg, args)
    val_cache = (cfg.data.image_cache + ".val" if cfg.data.image_cache
                 else None)

    epoch_callback = None
    if args.eval_map_every:
        from objectdetection_ssd_torch.eval.evaluate import (
            evaluate_records, exact_eval_postprocess)
        from objectdetection_ssd_torch.infer.detector import Detector
        cached_detector = []

        def epoch_callback(epoch, trainer):
            if (epoch + 1) % args.eval_map_every:
                return
            weights = _eval_weights(trainer.state)
            if not cached_detector:
                cached_detector.append(Detector(
                    cfg, weights, postprocess_config=exact_eval_postprocess(
                        cfg.postprocess), device=trainer.device))
            _, mean_ap = evaluate_records(
                cfg, weights, val_recs, detector=cached_detector[0],
                # The val split's cache, shared with the loss-eval loader.
                image_cache=val_cache)
            print(f"epoch {epoch}: val mAP = {mean_ap:.4f}")

    train_loader = Loader(train_recs, cfg.data, cfg.model.image_size,
                          train=True, seed=cfg.train.seed,
                          cache_path=cfg.data.image_cache)
    # The loss-eval phase pads the tail batch (Trainer._run_phase), so
    # every val image is covered.
    eval_loader = Loader(val_recs, cfg.data, cfg.model.image_size,
                         train=False, drop_last=False, cache_path=val_cache)
    try:
        trainer = Trainer(cfg, train_loader, eval_loader,
                          epoch_callback=epoch_callback, device=args.device,
                          init_state_dict=init_state_dict)
        if args.resume:
            trainer.maybe_resume()
        if cfg.quant.qat:
            qtree = _start_qat(cfg, trainer, train_recs)
        state = trainer.fit()
        if cfg.quant.qat:
            _save_qat_scales(cfg, trainer, state, qtree)
    finally:
        train_loader.close()
        eval_loader.close()
    return 0


def _start_qat(cfg: config_lib.Config, trainer, train_recs):
    """Calibrate on the weights about to be fine-tuned (after init and
    resume), switch the Trainer to fake-quant convs and save the scales
    before `fit` (no binding yet: the final weights do not exist)."""
    import os
    from objectdetection_ssd_torch.infer import quant as quant_lib
    qcfg = cfg.replace(quant=dataclasses.replace(cfg.quant, int8=True))
    qtree = _build_quant(qcfg, trainer.state.model.state_dict(),
                         trainer.device, records=train_recs)
    trainer.enable_qat(qtree)
    os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
    quant_lib.save_scales(qtree, os.path.join(cfg.train.checkpoint_dir,
                                              quant_lib.SCALES_FILENAME))
    return qtree


def _save_qat_scales(cfg: config_lib.Config, trainer, state, qtree) -> None:
    """Re-save the scales bound to the finished checkpoint: the raw
    weights' fingerprint and, with an EMA, the averaged weights' (which
    ``--use-ema`` serves), and the epoch."""
    import os
    from objectdetection_ssd_torch.infer import quant as quant_lib
    weights = state.model.state_dict()
    fps = [quant_lib.param_fingerprint(weights)]
    if state.ema is not None:
        fps.append(quant_lib.param_fingerprint({**weights, **state.ema}))
    quant_lib.save_scales(
        qtree, os.path.join(cfg.train.checkpoint_dir,
                            quant_lib.SCALES_FILENAME),
        fingerprint=fps, epoch=trainer.ckpt.latest_epoch())


def cmd_eval(args) -> int:
    from objectdetection_ssd_torch.eval.evaluate import evaluate_records
    cfg = build_config(args)
    train_recs, val_recs = _load_split(cfg, args)
    # The reference reports mAP on both splits (README.md:134-190).
    records = train_recs if args.split == "train" else val_recs
    weights = _restore_params(cfg, args.allow_random_init,
                              use_ema=args.use_ema)
    quant = _build_quant(cfg, weights, args.device, records=train_recs)
    # Per-split cache suffix: the cache is keyed on the split's path list.
    cache = (cfg.data.image_cache + f".{args.split}"
             if cfg.data.image_cache else None)
    out = evaluate_records(cfg, weights, records, iou_sweep=args.iou_sweep,
                           pr_curves_path=args.pr_curves, image_cache=cache,
                           device=args.device, quant=quant)
    aps, mean_ap = out[0], out[1]
    for name, ap in aps.items():
        print(f"{name:>12s}  AP = {ap:.4f}")
    print(f"{'mAP':>12s} = {mean_ap:.4f}")
    if args.iou_sweep:
        per_thr, sweep_mean = out[2], out[3]
        for thr, m in per_thr.items():
            print(f"{'mAP@' + format(thr, '.2f'):>12s} = {m:.4f}")
        print(f"{'mAP@[.5:.95]':>12s} = {sweep_mean:.4f}")
    if args.pr_curves:
        print(f"PR curves -> {args.pr_curves}")
    return 0


def cmd_detect(args) -> int:
    from objectdetection_ssd_torch.infer.detector import Detector
    cfg = build_config(args)
    weights = _restore_params(cfg, args.allow_random_init,
                              use_ema=args.use_ema)
    quant = _build_quant(cfg, weights, args.device, image_paths=args.images)
    det = Detector(cfg, weights, device=args.device, quant=quant)
    results = det.detect_images(args.images)
    for path, res in zip(args.images, results):
        print(path)
        for box, label, score in zip(res["boxes_xyxy"], res["labels"],
                                     res["scores"]):
            print(f"  {label:>12s} {score:.3f} "
                  f"[{box[0]:.0f}, {box[1]:.0f}, {box[2]:.0f}, {box[3]:.0f}]")
    return 0


def cmd_export(args) -> int:
    import os
    from objectdetection_ssd_torch.infer import quant as quant_lib
    from objectdetection_ssd_torch.infer.export import export_detector
    cfg = build_config(args)
    weights = _restore_params(cfg, args.allow_random_init,
                              use_ema=args.use_ema)
    quant = None
    if cfg.quant.int8:
        saved = os.path.join(cfg.train.checkpoint_dir,
                             quant_lib.SCALES_FILENAME)
        if os.path.exists(saved) and not cfg.quant.recalibrate:
            # A QAT checkpoint's scales: no dataset needed.
            quant = _build_quant(cfg, weights, args.device)
        else:
            # Post-training calibration on the train split.
            train_recs, _ = _load_split(cfg, args)
            quant = _build_quant(cfg, weights, args.device,
                                 records=train_recs)
    batch_size = args.serve_batch_size
    if batch_size is None:
        batch_size = 1 if args.latency_profile else 8
    out = export_detector(cfg, weights, args.out_dir, batch_size=batch_size,
                          quant=quant, device=args.device)
    print(f"exported serving artifact -> {out}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="objectdetection_ssd_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train SSD on VOC07+12")
    _common_flags(p_train)
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("--resume", action="store_true")
    p_train.add_argument("--image-cache", default=None,
                         help="path prefix for the packed decoded-image "
                              "cache (decode-free epochs); the val split "
                              "uses PREFIX.val")
    p_train.add_argument("--eval-map-every", type=int, default=0,
                         help="run val mAP evaluation every N epochs "
                              "(0 = off)")
    p_train.add_argument("--device-prefetch", dest="device_prefetch",
                         action="store_true", default=None,
                         help="copy each batch to the card on its own "
                              "thread and CUDA stream, overlapping host "
                              "prep and the step "
                              "(TrainConfig.device_prefetch)")
    p_train.add_argument("--no-device-prefetch", dest="device_prefetch",
                         action="store_false",
                         help="disable the copy stage (A/B)")
    p_train.add_argument("--lr", type=float, default=None,
                         help="base learning rate (default 1e-4, the "
                              "reference's fine-tune lr)")
    p_train.add_argument("--warmup-steps", type=int, default=None,
                         help="linear lr warmup steps (0 = off)")
    p_train.add_argument("--no-lr-decay", action="store_true",
                         help="disable the StepLR(7, 0.1) epoch decay (the "
                              "reference never calls scheduler.step(), "
                              "train.py:57)")
    p_train.add_argument("--hnm-topk", type=int, default=None,
                         help="hard-negative-mining partial top-k cap "
                              "(0 = always the full sort; exact either way)")
    p_train.add_argument("--grad-accum", type=int, default=1,
                         help="accumulate gradients over N micro-batches "
                              "per optimizer update")
    p_train.add_argument("--freeze-trunk-stages", type=int, default=0,
                         choices=range(0, 6),
                         help="freeze the first N VGG stages (1=conv1 .. "
                              "5=whole trunk)")
    p_train.add_argument("--remat", action="store_true",
                         help="gradient-checkpoint the VGG trunk at stage "
                              "boundaries (recompute the stage interiors "
                              "in the backward; less activation memory)")
    p_train.add_argument("--init-torch-vgg16", default=None,
                         help="initialize the VGG trunk from a torchvision "
                              "vgg16 state_dict/.pth (the reference's "
                              "pretrained-backbone recipe, Model.py:131-161)")
    p_train.add_argument("--init-torch-resnet34", default=None,
                         help="initialize the ResNet-34 trunk (params + BN "
                              "stats) from a torchvision resnet34 "
                              "state_dict/.pth")
    p_train.add_argument("--init-reference-ckpt", default=None,
                         help="initialize ALL SSD300 weights from a "
                              "reference torch checkpoint "
                              "(train_function.py:114-120 format)")
    p_train.add_argument("--qat", action="store_true",
                         help="quantization-aware fine-tuning: calibrate "
                              "int8 activation scales on the current "
                              "weights, then train through fake-quant "
                              "convs (straight-through estimator); the "
                              "scales persist as quant_scales.json next to "
                              "the checkpoint, bound to its weights, and "
                              "--int8 serves them")
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval", help="evaluate mAP on the val split")
    _common_flags(p_eval)
    p_eval.add_argument("--split", choices=["val", "train"], default="val",
                        help="which split to score (the reference reports "
                             "both, README.md:134-190)")
    p_eval.add_argument("--pr-curves", default=None, metavar="OUT_JSON",
                        help="write per-class cumulative precision/recall "
                             "curves (score-descending, IoU 0.5) as JSON")
    p_eval.add_argument("--iou-sweep", action="store_true",
                        help="also report mAP over the 0.50:0.05:0.95 IoU "
                             "ladder and its mean")
    p_eval.add_argument("--allow-random-init", action="store_true",
                        help="proceed with random weights when no "
                             "checkpoint is found (smoke tests)")
    p_eval.add_argument("--image-cache", default=None,
                        help="path prefix for a packed decoded-image cache; "
                             "the scored split uses PREFIX.<split>")
    p_eval.add_argument("--use-ema", action="store_true",
                        help="read the EMA-averaged weights (requires an "
                             "EMA-enabled checkpoint)")
    _int8_flags(p_eval)
    p_eval.set_defaults(fn=cmd_eval)

    p_det = sub.add_parser("detect", help="detect objects in images")
    _common_flags(p_det)
    p_det.add_argument("images", nargs="+")
    p_det.add_argument("--allow-random-init", action="store_true",
                       help="proceed with random weights when no "
                            "checkpoint is found (smoke tests)")
    p_det.add_argument("--use-ema", action="store_true",
                       help="read the EMA-averaged weights (requires an "
                            "EMA-enabled checkpoint)")
    _int8_flags(p_det)
    p_det.set_defaults(fn=cmd_detect)

    p_exp = sub.add_parser(
        "export", help="export the inference program (weights baked in) "
                       "as a torch.export serving artifact")
    _common_flags(p_exp)
    p_exp.add_argument("--out-dir", required=True)
    p_exp.add_argument("--serve-batch-size", type=int, default=None,
                       help="artifact batch shape (default 8; "
                            "--latency-profile defaults it to 1)")
    p_exp.add_argument("--latency-profile", action="store_true",
                       help="latency preset: per-class NMS candidates 32 "
                            "+ int8 quantization + a batch-1 artifact; any "
                            "explicit flag still overrides its piece")
    p_exp.add_argument("--allow-random-init", action="store_true",
                       help="export with random weights when no checkpoint "
                            "is found (smoke tests)")
    p_exp.add_argument("--use-ema", action="store_true",
                       help="read the EMA-averaged weights (requires an "
                            "EMA-enabled checkpoint)")
    _int8_flags(p_exp)
    p_exp.set_defaults(fn=cmd_export)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

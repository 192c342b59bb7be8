"""End-to-end evaluation: run the detector over a record set, compute mAP —
the port of `objectdetection_ssd_tpu/eval/evaluate.py` for one device (the
multi-host path is not ported).

The forward and the postprocess (with the greedy-NMS kernel K1 on the
card) run batched on the device; the fixed-size detection tensors come
back to the host once per batch, and `voc_map` scores them in numpy.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from objectdetection_ssd_torch.config import Config, PostprocessConfig
from objectdetection_ssd_torch.data import cache as cache_lib
from objectdetection_ssd_torch.data import pipeline as data_pipeline
from objectdetection_ssd_torch.data.voc import ImageRecord
from objectdetection_ssd_torch.device import DeviceLike
from objectdetection_ssd_torch.eval.voc_map import voc_map, voc_map_sweep
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.infer.postprocess import Detections
from objectdetection_ssd_torch.utils.metrics import logger

def exact_eval_postprocess(pp: PostprocessConfig) -> PostprocessConfig:
    """Reference-comparable postprocess settings for mAP evaluation: exact
    top-k over every anchor and >= 200 candidates per class (the reference
    NMSes every anchor above threshold, `Losses.py:32-56`)."""
    return dataclasses.replace(
        pp, use_approx_top_k=False, anchor_prefilter=0,
        per_class_top_k=max(200, pp.per_class_top_k))


def _bounded_map(pool, fn, items, window: int):
    """Ordered ``pool.map`` with at most ``window`` submissions in flight
    (``Executor.map`` submits everything up front, and a slow consumer
    would hold every prepared image)."""
    it = iter(items)
    pending: deque = deque()

    def fill() -> None:
        while len(pending) < window:
            try:
                item = next(it)
            except StopIteration:
                return
            pending.append(pool.submit(fn, item))

    fill()
    while pending:
        result = pending.popleft().result()
        fill()
        yield result


def _evaluate_local(detector, records, bs, prep,
                    det_boxes, det_classes, det_scores,
                    gt_boxes, gt_classes) -> int:
    """The batch loop; returns the number of batches."""
    # Threads: decode and the native resample release the GIL, so host
    # preprocessing overlaps the device batches.
    batches = 0
    with ThreadPoolExecutor(max_workers=4) as pool:
        prepared = _bounded_map(pool, prep, enumerate(records),
                                window=max(2 * bs, 8))
        for start in range(0, len(records), bs):
            chunk = [next(prepared) for _ in
                     range(min(bs, len(records) - start))]
            imgs = [c[0] for c in chunk]
            for _, norm, classes in chunk:
                gt_boxes.append(norm)
                gt_classes.append(classes)
            # Pad the tail batch to the batch size (one shape).
            n_real = len(imgs)
            while len(imgs) < bs:
                imgs.append(imgs[-1])
            dets = detector.detect_batch(np.stack(imgs))
            # One host pull for the whole batch, not four per row.
            dets = Detections(*(t.cpu().numpy() for t in dets))
            batches += 1
            for i in range(n_real):
                valid = dets.valid[i]
                det_boxes.append(dets.boxes_xyxy[i][valid])
                det_classes.append(dets.classes[i][valid])
                det_scores.append(dets.scores[i][valid])
    return batches


def evaluate_records(config: Config,
                     state_dict: Optional[Mapping[str, torch.Tensor]],
                     records: List[ImageRecord],
                     batch_size: Optional[int] = None,
                     keep_difficult: Optional[bool] = None,
                     detector: Optional[Detector] = None,
                     iou_sweep: bool = False,
                     pr_curves_path: Optional[str] = None,
                     image_cache: Optional[str] = None,
                     device: DeviceLike = None,
                     quant: Optional[Mapping] = None):
    """Returns (per-class AP, mAP) over ``records``.

    Ground truth as the reference protocol has it: difficult objects are
    dropped before matching (`Dataset.py:29-31`), and detections and ground
    truth are compared in normalized [0, 1] coordinates.

    ``detector``: reuse a Detector (its model takes ``state_dict`` when one
    is given); otherwise one is built on ``device`` (default ``cuda``) with
    `exact_eval_postprocess` and the int8 scale tree ``quant``
    (`infer/quant.py`; None: float).

    ``iou_sweep=True`` also scores the detections over the 0.50:0.05:0.95
    IoU ladder (`voc_map_sweep`) and returns
    ``(per_class_ap, mAP, {threshold: mAP}, mAP_mean_over_thresholds)``.

    ``pr_curves_path``: write the per-class cumulative precision/recall
    curves (score-descending, IoU 0.5) as JSON.

    ``image_cache``: path prefix of a packed decoded-image cache over
    ``records`` (`data/cache.py`), built on first use; it serves the same
    pixels as decoding the files.
    """
    if detector is None:
        detector = Detector(config, state_dict,
                            postprocess_config=exact_eval_postprocess(
                                config.postprocess),
                            device=device, quant=quant)
    elif state_dict is not None:
        detector.model.load_state_dict(state_dict, strict=True)
    bs = batch_size or config.data.batch_size
    size = config.model.image_size
    if keep_difficult is None:
        keep_difficult = config.data.keep_difficult
    u8 = config.data.transfer_dtype == "uint8"
    if image_cache is not None:
        cache_lib.build([r.image_path for r in records], image_cache,
                        num_workers=config.data.num_workers)

    def prep(item: Tuple[int, ImageRecord]):
        idx, rec = item
        r = rec if keep_difficult else rec.without_difficult()
        if image_cache is not None:
            raw = cache_lib.get_image(image_cache, idx)
        else:
            raw = data_pipeline.load_image(r.image_path)
        h, w = raw.shape[:2]
        norm = (r.boxes_xyxy /
                np.asarray([w, h, w, h], np.float32)).astype(np.float32)
        img = data_pipeline.preprocess_image(raw, size, normalize=not u8)
        if u8:
            img = data_pipeline.quantize_uint8(img)
        return img, norm, r.classes

    det_boxes, det_classes, det_scores = [], [], []
    gt_boxes, gt_classes = [], []
    t0 = time.perf_counter()
    batches = _evaluate_local(detector, records, bs, prep,
                              det_boxes, det_classes, det_scores,
                              gt_boxes, gt_classes)
    logger.info("eval: %d images in %d batches, %.3f s", len(records),
                batches, time.perf_counter() - t0)

    if pr_curves_path:
        aps, mean_ap, curves = voc_map(det_boxes, det_classes, det_scores,
                                       gt_boxes, gt_classes,
                                       return_curves=True)
        with open(pr_curves_path, "w") as f:
            json.dump({
                "iou_threshold": 0.5,
                "map": mean_ap,
                "classes": {
                    name: {"ap": aps[name],
                           **{k: np.asarray(v).round(6).tolist()
                              for k, v in c.items()}}
                    for name, c in curves.items()},
            }, f)
    else:
        aps, mean_ap = voc_map(det_boxes, det_classes, det_scores,
                               gt_boxes, gt_classes)
    if not iou_sweep:
        return aps, mean_ap
    per_thr, sweep_mean = voc_map_sweep(det_boxes, det_classes, det_scores,
                                        gt_boxes, gt_classes,
                                        known={0.5: mean_ap})
    return aps, mean_ap, per_thr, sweep_mean

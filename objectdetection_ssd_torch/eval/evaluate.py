"""End-to-end evaluation: run the detector over a record set, compute mAP —
the port of `objectdetection_ssd_tpu/eval/evaluate.py`.

The forward and the postprocess (with the greedy-NMS kernel K1 on the
card) run batched on the device; the fixed-size detection tensors come
back to the host once per batch, and `voc_map` scores them in numpy.

Under a process group (one process per card,
`parallel.distributed.initialize`) each data shard prepares and detects
its rows of every batch, and the detections and the padded ground truth
are gathered to every rank (`_gather_batch`), so each rank computes the
same mAP.  Without a mesh every rank is a data shard; on a ``data x
model`` or ``data x spatial`` mesh (the Detector's) the ranks of one
``model`` or ``spatial`` group detect the same rows together and only the
first of them contributes its rows to the gather, so each row is counted
once.  ``local_only=True`` keeps one process's evaluation (the
primary-only side eval of ``train --eval-map-every``).
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
import torch.distributed as dist

from objectdetection_ssd_torch.config import Config, PostprocessConfig
from objectdetection_ssd_torch.data import cache as cache_lib
from objectdetection_ssd_torch.data import pipeline as data_pipeline
from objectdetection_ssd_torch.data.voc import ImageRecord
from objectdetection_ssd_torch.device import DeviceLike
from objectdetection_ssd_torch.eval.voc_map import voc_map, voc_map_sweep
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.infer.postprocess import Detections
from objectdetection_ssd_torch.parallel import distributed
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
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


def local_detection_rows(dets: Detections) -> Detections:
    """This process's rows of a batch's detections, as numpy: one host
    pull per tensor, not four per row."""
    return Detections(*(t.cpu().numpy() for t in dets))


def _gather_rows(t: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Every ``stride``-th rank's rows of ``t`` (on the process group's
    device), in rank order: every data shard's once, on a mesh whose
    ``model`` or ``spatial`` groups are ``stride`` ranks wide."""
    parts = [torch.empty_like(t) for _ in range(distributed.process_count())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts[::stride])


def _data_shard(detector) -> Tuple[int, int]:
    """(index, count) of this rank's data shard: its coordinate on the
    Detector's mesh, else one shard per process."""
    if getattr(detector, "mesh", None) is not None:
        return mesh_lib.data_shard(detector.mesh)
    return distributed.process_index(), distributed.process_count()


def _gather_batch(dets: Detections, local, dev, stride: int = 1):
    """Every data shard's detections and ground truth of one global batch
    (``stride``: the ranks per data shard): the ground truth padded to the
    batch's largest count (agreed by an all-reduce).  Returns the
    detections as numpy and ``(boxes, classes)`` per row."""
    maxb = torch.tensor([max(1, max(len(c) for _, _, c in local))],
                        device=dev)
    dist.all_reduce(maxb, op=dist.ReduceOp.MAX)
    maxb = int(maxb)
    gtb = np.zeros((len(local), maxb, 4), np.float32)
    gtc = np.zeros((len(local), maxb), np.int32)
    gtn = np.zeros((len(local),), np.int32)
    for r, (_, norm, classes) in enumerate(local):
        gtn[r] = len(classes)
        gtb[r, :len(classes)] = norm
        gtc[r, :len(classes)] = classes
    # Gloo takes no bool: the valid mask travels as uint8.
    rows = Detections(*(_gather_rows(
        t.to(torch.uint8) if t.dtype == torch.bool else t, stride)
        for t in dets))
    g_dets = local_detection_rows(rows._replace(valid=rows.valid.bool()))
    g_gtb, g_gtc, g_gtn = (
        _gather_rows(torch.from_numpy(a).to(dev), stride).cpu().numpy()
        for a in (gtb, gtc, gtn))
    return g_dets, [(g_gtb[i, :n], g_gtc[i, :n])
                    for i, n in enumerate(g_gtn.tolist())]


def _evaluate_batches(detector, records, bs, prep, multihost,
                      det_boxes, det_classes, det_scores,
                      gt_boxes, gt_classes) -> int:
    """The batch loop: this process prepares and detects its data shard's
    rows of each batch of ``bs`` (all of them without ``multihost``), the
    tail padded by repeating the last record (one shape); under
    ``multihost`` the detections and the ground truth are gathered to
    every rank (`_gather_batch`).  Returns the number of batches."""
    lo, hi, stride = 0, bs, 1
    if multihost:
        index, count = _data_shard(detector)
        per = bs // count
        lo, hi = index * per, (index + 1) * per
        stride = distributed.process_count() // count
    local_records = [(i, records[i])
                     for start in range(0, len(records), bs)
                     for k in range(lo, hi)
                     for i in [min(start + k, len(records) - 1)]]
    batches = 0
    # Threads: decode and the native resample release the GIL, so host
    # preprocessing overlaps the device batches.
    with ThreadPoolExecutor(max_workers=4) as pool:
        prepared = _bounded_map(pool, prep, local_records,
                                window=max(2 * (hi - lo), 8))
        for start in range(0, len(records), bs):
            n_real = min(bs, len(records) - start)
            local = [next(prepared) for _ in range(hi - lo)]
            dets = detector.detect_batch(np.stack([l[0] for l in local]))
            if multihost:
                # The comm device: NCCL gathers on the card, gloo on the CPU.
                dets, gt = _gather_batch(dets, local, detector.device,
                                         stride)
            else:
                dets = local_detection_rows(dets)
                gt = [(norm, classes) for _, norm, classes in local]
            batches += 1
            for i in range(n_real):
                gt_boxes.append(gt[i][0])
                gt_classes.append(gt[i][1])
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
                     quant: Optional[Mapping] = None,
                     local_only: bool = False, mesh=None):
    """Returns (per-class AP, mAP) over ``records``.

    Ground truth as the reference protocol has it: difficult objects are
    dropped before matching (`Dataset.py:29-31`), and detections and ground
    truth are compared in normalized [0, 1] coordinates.

    ``detector``: reuse a Detector (its model takes ``state_dict`` when one
    is given); otherwise one is built on ``device`` (default ``cuda``) with
    `exact_eval_postprocess`, the int8 scale tree ``quant``
    (`infer/quant.py`; None: float) and ``mesh`` (a ``data x model`` or
    ``data x spatial`` mesh: the Detector's tensor or spatial
    parallelism, with the batches split over the ``data`` axis).

    ``iou_sweep=True`` also scores the detections over the 0.50:0.05:0.95
    IoU ladder (`voc_map_sweep`) and returns
    ``(per_class_ap, mAP, {threshold: mAP}, mAP_mean_over_thresholds)``.

    ``pr_curves_path``: write the per-class cumulative precision/recall
    curves (score-descending, IoU 0.5) as JSON.

    ``image_cache``: path prefix of a packed decoded-image cache over
    ``records`` (`data/cache.py`), built on first use; it serves the same
    pixels as decoding the files.

    Under a process group the evaluation is data-parallel
    (`_evaluate_batches`; the batch size rounds up to a multiple of the
    data shards) and collective: every rank calls it and gets the same
    result.  ``local_only``: this process alone, as without a group.
    """
    if detector is None:
        detector = Detector(config, state_dict,
                            postprocess_config=exact_eval_postprocess(
                                config.postprocess),
                            device=device, quant=quant, mesh=mesh)
    elif state_dict is not None:
        detector.load_weights(state_dict)
    bs = batch_size or config.data.batch_size
    multihost = dist.is_initialized() and not local_only
    if multihost:
        ways = _data_shard(detector)[1]
        bs = -(-bs // ways) * ways      # round up: every shard gets rows
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
    batches = _evaluate_batches(detector, records, bs, prep, multihost,
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

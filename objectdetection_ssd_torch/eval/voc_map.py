"""VOC mAP evaluation: 11-point interpolated AP at IoU 0.5, per-class report
— a copy of `objectdetection_ssd_tpu/eval/voc_map.py` (numpy only).

Reference semantics reproduced (`get_map`, `Util.py:783-885`):
  * detections pooled across images per class, sorted by descending score
    (`Util.py:828-830`);
  * each detection greedily matched to the best-IoU ground truth OF ITS
    CLASS in its image; TP iff IoU > 0.5 (strict) AND that GT is unclaimed;
    claiming marks the GT used (`Util.py:835-868`);
  * cumulative precision/recall; AP = mean over the 11-point recall grid
    0:0.1:1 of the max precision at recall >= r, 0 where unreachable
    (`Util.py:870-882`);
  * difficult GT are expected to be dropped upstream, as the reference's
    dataset does (`Dataset.py:29-31`); standard-VOC "ignore difficult"
    matching is available via ``difficulties`` for completeness.

Host-side numpy (evaluation is not a device hot path), fully vectorized:
the reference's per-detection Python loop (`Util.py:835-868`) is millions of
iterations at VOC scale.  Its sequential greedy claim collapses exactly —
each detection is only ever compared against its single best-IoU GT
(`Util.py:855-856`), so "greedy in score order" is precisely "the
first-by-score detection per (image, best-GT) pair is the TP, every other
above-threshold match of that pair is FP", which is one `np.unique` over
sorted keys.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from objectdetection_ssd_torch.config import NUM_CLASSES, VOC_CLASSES


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (aa[:, None] + ab[None, :] - inter)


def eleven_point_ap(cum_precision: np.ndarray,
                    cum_recall: np.ndarray) -> float:
    """11-point interpolated AP (`Util.py:870-882`)."""
    ap = 0.0
    for rec in np.arange(0.0, 1.1, 0.1):
        mask = cum_recall >= rec
        ap += float(cum_precision[mask].max()) if mask.any() else 0.0
    return ap / 11.0


def voc_map(det_boxes: Sequence[np.ndarray],
            det_classes: Sequence[np.ndarray],
            det_scores: Sequence[np.ndarray],
            gt_boxes: Sequence[np.ndarray],
            gt_classes: Sequence[np.ndarray],
            difficulties: Optional[Sequence[np.ndarray]] = None,
            iou_threshold: float = 0.5,
            return_curves: bool = False):
    """Compute per-class AP and mAP over per-image detection/GT lists.

    Args:
      det_boxes[i]: (n_i, 4) xyxy detections for image i (any scale, must
        match gt scale).
      det_classes[i], det_scores[i]: (n_i,) class ids / scores.
      gt_boxes[i], gt_classes[i]: ground truth for image i.
      difficulties: optional per-image bool arrays; when given, difficult GT
        are ignored (neither claimable-as-TP-counted nor penalized) per
        standard VOC.  The reference instead drops difficult GT upstream —
        pass pre-filtered GT and leave this None for reference parity.

    Returns: ({class_name: AP}, mAP); with ``return_curves=True``,
    ({class_name: AP}, mAP, {class_name: {"scores", "precision",
    "recall"}}) — the score-descending cumulative PR arrays each class's
    AP integrates (production debugging: pick an operating threshold, see
    which classes saturate recall early, etc.).
    """
    n_images = len(det_boxes)
    aps: Dict[str, float] = {}
    curves: Dict[str, Dict[str, np.ndarray]] = {}

    # Normalize inputs once (not per class).
    det_classes = [np.asarray(c).reshape(-1) for c in det_classes]
    det_boxes = [np.asarray(b, np.float32).reshape(-1, 4) for b in det_boxes]
    det_scores = [np.asarray(s, np.float32).reshape(-1) for s in det_scores]
    gt_classes_np = [np.asarray(c).reshape(-1) for c in gt_classes]
    gt_boxes_np = [np.asarray(b, np.float32).reshape(-1, 4) for b in gt_boxes]

    for cls in range(NUM_CLASSES):
        # Gather this class's GT per image.
        gt_per_image: List[np.ndarray] = []
        ignore_per_image: List[np.ndarray] = []
        n_positive = 0
        for i in range(n_images):
            sel = gt_classes_np[i] == cls
            g = gt_boxes_np[i][sel]
            gt_per_image.append(g)
            if difficulties is not None:
                ign = np.asarray(difficulties[i], bool)[sel]
            else:
                ign = np.zeros(len(g), bool)
            ignore_per_image.append(ign)
            n_positive += int((~ign).sum())

        # Pool + score-sort this class's detections (stable sort = the
        # reference's pooled-order tiebreak, `Util.py:828-830`).
        sel_per_image = [det_classes[i] == cls for i in range(n_images)]
        imgs = np.concatenate(
            [np.full(int(s.sum()), i, np.int64)
             for i, s in enumerate(sel_per_image)] or [np.zeros(0, np.int64)])
        if len(imgs) == 0:
            aps[VOC_CLASSES[cls]] = 0.0
            curves[VOC_CLASSES[cls]] = {
                "scores": np.zeros(0, np.float32),
                "precision": np.zeros(0, np.float64),
                "recall": np.zeros(0, np.float64)}
            continue
        boxes = np.concatenate(
            [det_boxes[i][s] for i, s in enumerate(sel_per_image)])
        scores = np.concatenate(
            [det_scores[i][s] for i, s in enumerate(sel_per_image)])
        order = np.argsort(-scores, kind="stable")
        imgs, boxes = imgs[order], boxes[order]
        n = len(imgs)

        # Best-IoU GT per detection in ONE vectorized op (`Util.py:855-856`
        # computes this one detection at a time): pad each image's class-GT
        # to maxG rows, gather per detection, mask pads to IoU -1 (they can
        # never win, and an all-pad row yields best_iou=-1 -> FP).  Valid GT
        # stay at the front per image, so argmax tie-breaking (first
        # occurrence) is unchanged.
        best_iou = np.full(n, -1.0, np.float32)
        best_gt = np.zeros(n, np.int64)
        maxg = max((len(g) for g in gt_per_image), default=0)
        if maxg:
            gt_pad = np.zeros((n_images, maxg, 4), np.float32)
            gt_valid = np.zeros((n_images, maxg), bool)
            for i, g in enumerate(gt_per_image):
                gt_pad[i, :len(g)] = g
                gt_valid[i, :len(g)] = True
            g_sel = gt_pad[imgs]                       # (n, maxG, 4)
            lo = np.maximum(boxes[:, None, :2], g_sel[..., :2])
            hi = np.minimum(boxes[:, None, 2:], g_sel[..., 2:])
            wh = np.clip(hi - lo, 0, None)
            inter = wh[..., 0] * wh[..., 1]
            area_d = ((boxes[:, 2] - boxes[:, 0])
                      * (boxes[:, 3] - boxes[:, 1]))[:, None]
            area_g = ((g_sel[..., 2] - g_sel[..., 0])
                      * (g_sel[..., 3] - g_sel[..., 1]))
            iou = inter / (area_d + area_g - inter)
            iou = np.where(gt_valid[imgs], iou, -1.0)
            best_iou = iou.max(axis=1)
            best_gt = iou.argmax(axis=1)

        # Greedy claim, vectorized: a detection is only ever matched to its
        # best-IoU GT, so the first (highest-score) above-threshold match of
        # each (image, gt) pair is the TP; later matches of the same pair
        # are FP; sub-threshold detections are FP; matches to ignored GT
        # are neither (`continue` in the scalar formulation).
        tp = np.zeros(n, np.float64)
        fp = np.zeros(n, np.float64)
        over = best_iou > iou_threshold
        ign_match = np.zeros(n, bool)
        if difficulties is not None and over.any():
            idx = np.flatnonzero(over)
            ign_match[idx] = np.asarray(
                [ignore_per_image[imgs[d]][best_gt[d]] for d in idx])
        fp[~over] = 1.0
        cand = np.flatnonzero(over & ~ign_match)
        if len(cand):
            max_gt = int(best_gt[cand].max()) + 1
            keys = imgs[cand] * max_gt + best_gt[cand]
            _, first = np.unique(keys, return_index=True)
            fp[cand] = 1.0
            tp[cand[first]] = 1.0
            fp[cand[first]] = 0.0

        cum_tp = tp.cumsum()
        cum_fp = fp.cumsum()
        cum_precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
        cum_recall = cum_tp / max(n_positive, 1)
        aps[VOC_CLASSES[cls]] = eleven_point_ap(cum_precision, cum_recall)
        curves[VOC_CLASSES[cls]] = {"scores": scores[order],
                                    "precision": cum_precision,
                                    "recall": cum_recall}

    mean_ap = float(np.mean(list(aps.values())))
    if return_curves:
        return aps, mean_ap, curves
    return aps, mean_ap


def voc_map_sweep(det_boxes: Sequence[np.ndarray],
                  det_classes: Sequence[np.ndarray],
                  det_scores: Sequence[np.ndarray],
                  gt_boxes: Sequence[np.ndarray],
                  gt_classes: Sequence[np.ndarray],
                  difficulties: Optional[Sequence[np.ndarray]] = None,
                  iou_thresholds: Sequence[float] = tuple(
                      np.arange(0.5, 1.0, 0.05).round(2)),
                  known: Optional[Dict[float, float]] = None,
                  ) -> Tuple[Dict[float, float], float]:
    """mAP over an IoU-threshold sweep — a COCO-style strictness summary.

    Runs the VOC protocol above (11-point interpolation, strict ``IoU >
    threshold`` matching — NOT COCO's 101-point/>= variant; this is the
    reference's own AP math, `Util.py:783-885`, swept over thresholds) and
    returns ``({threshold: mAP}, mean over thresholds)``.  The default grid
    0.50:0.05:0.95 is the COCO localization-quality ladder, so the mean
    plays the role of "mAP@[.5:.95]" for models trained/evaluated under
    VOC semantics.  The reference evaluates 0.5 only.

    Cost: one full voc_map pass per threshold, on already-collected
    detections: no model re-runs.
    ``known`` lets a caller that already scored some thresholds (the usual
    0.5 headline pass) skip recomputing them.
    """
    per_thr: Dict[float, float] = {}
    for thr in iou_thresholds:
        thr = float(thr)
        if known is not None and thr in known:
            per_thr[thr] = known[thr]
            continue
        _, m = voc_map(det_boxes, det_classes, det_scores,
                       gt_boxes, gt_classes, difficulties=difficulties,
                       iou_threshold=thr)
        per_thr[thr] = m
    return per_thr, float(np.mean(list(per_thr.values())))

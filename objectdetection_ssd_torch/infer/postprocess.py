"""Detection post-processing — the port of
`objectdetection_ssd_tpu/infer/postprocess.py`.

decode -> softmax -> per-class threshold -> per-class greedy NMS -> global
top-k, all with fixed shapes and no host round-trip (reference `inference`,
`Losses.py:11-98`).  Sub-threshold slots carry score 0 with a validity mask.

Every top-k here is a stable descending sort: among equal values the lower
index comes first, which is `lax.top_k`'s order (`torch.topk` promises
none).  Ties are certain in the final top-200, where every suppressed or
invalid slot scores 0.0; the boxes of invalid rows are unspecified.

The greedy suppression runs the CUDA kernel on the card and the plain
recurrence on the CPU (`infer/nms_cuda.py:greedy_nms_keep`).  Soft-NMS
(`soft_nms_scores`), which the JAX package leaves to XLA, is plain PyTorch
on both: K data-independent rounds over the batched candidate sets.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from objectdetection_ssd_torch.config import NUM_CLASSES, PostprocessConfig
from objectdetection_ssd_torch.infer.nms_cuda import (greedy_nms_keep,
                                                      greedy_nms_mask)
from objectdetection_ssd_torch.ops import boxes as box_ops

__all__ = ["Detections", "greedy_nms_mask", "soft_nms_scores", "postprocess",
           "select_candidates", "finalize", "scale_detections"]


class Detections(NamedTuple):
    """Fixed-size detection set for a batch of images.

    boxes_xyxy: (B, top_k, 4) f32 in [0, 1] image-normalized corner coords.
    scores:     (B, top_k) f32 softmax scores (0 where invalid).
    classes:    (B, top_k) int32 class ids in [0, 20) (0 where invalid).
    valid:      (B, top_k) bool.
    """

    boxes_xyxy: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last dim: descending, lower index first on ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k].contiguous(), idx[..., :k].contiguous()


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, P, ...) gathered along dim 1 by idx (B, ...) -> (B, ..., ...)."""
    batch = torch.arange(x.shape[0], device=x.device)
    return x[batch.view(-1, *([1] * (idx.dim() - 1))), idx]


def select_candidates(pred_offsets: torch.Tensor, pred_logits: torch.Tensor,
                      priors_cxcywh: torch.Tensor,
                      config: PostprocessConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, P, 4), (B, P, C) -> per-class candidates sorted by score:
    boxes (B, 20, K, 4) f32 xyxy, scores (B, 20, K) f32, valid (B, 20, K)."""
    p = pred_offsets.shape[1]
    k = min(config.per_class_top_k, p)
    logz = torch.logsumexp(pred_logits.float(), dim=-1)       # (B, P)

    m = config.anchor_prefilter
    if config.use_approx_top_k and 0 < m < p:
        # Two-stage selection: keep the top-M anchors by best foreground
        # log-score, then rank per class among those M only.
        max_fg = pred_logits[..., :NUM_CLASSES].float().amax(dim=-1) - logz
        _, anchor_idx = _top_k(max_fg, m)                      # (B, M)
        logits_m = _rows(pred_logits, anchor_idx).float()      # (B, M, C)
        logz_m = _rows(logz, anchor_idx)                       # (B, M)
        offsets_m = _rows(pred_offsets, anchor_idx)            # (B, M, 4)
        priors_m = priors_cxcywh[anchor_idx]                   # (B, M, 4)
        decoded = box_ops.cxcywh_to_xyxy(box_ops.decode(offsets_m, priors_m))
        cls_scores = torch.exp(
            logits_m.transpose(1, 2)[:, :NUM_CLASSES]
            - logz_m[:, None, :])                              # (B, 20, M)
    else:
        decoded = box_ops.cxcywh_to_xyxy(
            box_ops.decode(pred_offsets, priors_cxcywh))       # (B, P, 4)
        # The JAX package ranks in bf16 on this path in approx mode (half
        # the bytes of the dominant (B, 20, P) ranking); exact mode is f32.
        score_dtype = (torch.bfloat16 if config.use_approx_top_k
                       else torch.float32)
        cls_scores = torch.exp(
            pred_logits.transpose(1, 2)[:, :NUM_CLASSES].float()
            - logz[:, None, :]).to(score_dtype)                # (B, 20, P)
    top_scores, top_idx = _top_k(cls_scores, k)                # (B, 20, K)
    top_scores = top_scores.float()
    cand_boxes = _rows(decoded, top_idx)                       # (B, 20, K, 4)
    valid = top_scores >= config.score_threshold
    return cand_boxes, top_scores, valid


def soft_nms_scores(iou: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, method: str = "soft_gaussian",
                    sigma: float = 0.5, iou_threshold: float = 0.45
                    ) -> torch.Tensor:
    """Soft-NMS (Bodla et al. 2017), fixed-shape and batched — the JAX
    `soft_nms_scores` in its unrolled form.

    ``iou`` (..., K, K), ``scores`` / ``valid`` (..., K) in descending
    candidate order.  K rounds, each: pick the alive candidate of the
    highest current (decayed) score, the first one on ties, as
    ``jnp.argmax``; record that score; decay the alive rest by
    ``exp(-iou^2 / sigma)`` ("soft_gaussian") or by ``1 - iou`` where
    ``iou >= iou_threshold`` ("soft_linear").  A round with nothing
    positive left is a no-op.  Returns each candidate's score at the
    moment it was picked (0 for never picked or invalid).
    """
    if method not in ("soft_gaussian", "soft_linear"):
        raise ValueError(f"unknown soft-NMS method {method!r}")
    k = scores.shape[-1]
    index = torch.arange(k, device=scores.device)
    work = torch.where(valid, scores, 0.0)
    alive = valid.clone()
    out = torch.zeros_like(scores)
    for _ in range(k):
        masked = torch.where(alive, work, -1.0)
        best = masked.amax(dim=-1)                             # (...,)
        # First index of the maximum: torch.argmax names no tie rule.
        i = torch.where(masked == best[..., None], index, k).amin(dim=-1)
        has = best > 0.0                                       # anything left?
        pick = (index == i[..., None]) & has[..., None]
        out = torch.where(pick, work, out)
        alive = alive & ~pick
        row = torch.gather(iou, -2, i[..., None, None].expand(
            *i.shape, 1, k))[..., 0, :]                        # (..., K)
        if method == "soft_gaussian":
            decay = torch.exp(-(row * row) / sigma)
        else:
            decay = torch.where(row >= iou_threshold, 1.0 - row, 1.0)
        decay = torch.where(has[..., None], decay, 1.0)        # no-op rounds
        work = torch.where(alive, work * decay, work)
    return out


def finalize(cand_boxes: torch.Tensor, top_scores: torch.Tensor,
             keep: torch.Tensor, top_k: int) -> Detections:
    """Kept per-class candidates -> the global top-k `Detections`."""
    bs, _, k = keep.shape
    kept_scores = torch.where(keep, top_scores, 0.0)
    flat_scores = kept_scores.reshape(bs, -1)                  # (B, 20*K)
    flat_boxes = cand_boxes.reshape(bs, -1, 4)
    final_scores, final_idx = _top_k(flat_scores, top_k)
    final_boxes = _rows(flat_boxes, final_idx)
    final_classes = torch.div(final_idx, k, rounding_mode="floor").to(
        torch.int32)
    final_valid = final_scores > 0.0
    return Detections(final_boxes, final_scores,
                      torch.where(final_valid, final_classes, 0), final_valid)


def postprocess(pred_offsets: torch.Tensor, pred_logits: torch.Tensor,
                priors_cxcywh: torch.Tensor,
                config: PostprocessConfig = PostprocessConfig()
                ) -> Detections:
    """Batched post-processing: (B, P, 4), (B, P, C) -> Detections, on the
    device of the inputs.  ``config.nms_method`` "hard" keeps by greedy NMS
    (kernel K1 on the card); the soft methods keep every candidate whose
    decayed score still clears ``score_threshold``, at that score."""
    cand_boxes, top_scores, valid = select_candidates(
        pred_offsets, pred_logits, priors_cxcywh, config)
    if config.nms_method == "hard":
        keep = greedy_nms_keep(cand_boxes, valid, config.nms_iou_threshold)
        return finalize(cand_boxes, top_scores, keep, config.top_k)
    decayed = soft_nms_scores(box_ops.pairwise_iou(cand_boxes, cand_boxes),
                              top_scores, valid, method=config.nms_method,
                              sigma=config.soft_nms_sigma,
                              iou_threshold=config.nms_iou_threshold)
    return finalize(cand_boxes, decayed, decayed >= config.score_threshold,
                    config.top_k)


def scale_detections(dets: Detections, image_sizes_wh: torch.Tensor
                     ) -> Detections:
    """Scale normalized boxes to pixel coords (reference `Losses.py:87-89`).

    image_sizes_wh: (B, 2) original (width, height) per image.
    """
    wh = torch.as_tensor(image_sizes_wh, device=dets.boxes_xyxy.device).to(
        dets.boxes_xyxy.dtype)
    scale = torch.cat([wh, wh], dim=-1)[:, None, :]            # (B, 1, 4)
    return dets._replace(boxes_xyxy=dets.boxes_xyxy * scale)

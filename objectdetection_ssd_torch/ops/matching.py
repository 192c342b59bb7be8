"""Prior <-> ground-truth matching, batched and padded — the port of
`objectdetection_ssd_tpu/ops/matching.py`.

SSD matching semantics of the reference (`Losses.py:150-171`):

  1. per-prior best object: argmax over objects of the IoU matrix;
  2. per-object best prior override: each object claims its highest-IoU
     prior with overlap pinned to 1.0 (`Losses.py:164-167`); when two
     objects share a best prior, the LAST object (highest index) wins, as
     the reference's in-place loop makes it;
  3. priors whose (possibly overridden) overlap is below the threshold are
     background, class id 20 (`Losses.py:171`).

Ground truth is padded to a fixed ``M`` with a validity mask; padded rows
get IoU -1 so that they never win an argmax.  The JAX package vmaps over
images; here the batch dimension is written out.  The override is a max
over masked object ids, never a scatter with duplicate indices (whose
winner a CUDA scatter leaves unspecified).  ``torch.argmax``, like
``jnp.argmax``, returns the first maximal index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from objectdetection_ssd_torch.config import BACKGROUND_CLASS


class MatchResult(NamedTuple):
    """Per-prior matching targets.

    Attributes:
      matched_class: (..., P) int32 — class id per prior, 20 = background.
      matched_box:   (..., P, 4) f32 — matched GT box, xyxy normalized.
      matched_iou:   (..., P) f32 — overlap used for the decision (1.0 where
        force-assigned).
      matched_obj:   (..., P) int32 — index of the matched GT row.
    """

    matched_class: torch.Tensor
    matched_box: torch.Tensor
    matched_iou: torch.Tensor
    matched_obj: torch.Tensor


def _iou_gt_priors(gt_boxes_xyxy: torch.Tensor,
                   priors_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (P, 4) -> (..., M, P) IoU, coordinate-separated, in the
    JAX function's operation order."""
    ax1, ay1, ax2, ay2 = (gt_boxes_xyxy[..., i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (priors_xyxy[:, i] for i in range(4))
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0.0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0.0)
    inter = ix * iy                                             # (..., M, P)
    area_a = (ax2 - ax1) * (ay2 - ay1)                          # (..., M, 1)
    area_b = (bx2 - bx1) * (by2 - by1)                          # (P,)
    return inter / (area_a + area_b - inter)


def match_batch(gt_boxes_xyxy: torch.Tensor, gt_classes: torch.Tensor,
                gt_mask: torch.Tensor, priors_xyxy: torch.Tensor,
                iou_threshold: float = 0.5) -> MatchResult:
    """Match a padded GT batch against shared priors.

    Args:
      gt_boxes_xyxy: (B, M, 4) normalized corner boxes; padded rows arbitrary
        (finite).
      gt_classes: (B, M) int class ids in [0, 20).
      gt_mask: (B, M) bool — True for real objects.
      priors_xyxy: (P, 4) prior boxes in corner form.
      iou_threshold: background threshold (reference 0.5).
    """
    num_gt = gt_boxes_xyxy.shape[-2]
    num_priors = priors_xyxy.shape[0]
    device = gt_boxes_xyxy.device

    iou = _iou_gt_priors(gt_boxes_xyxy, priors_xyxy)           # (B, M, P)
    iou = torch.where(gt_mask[..., None], iou, iou.new_tensor(-1.0))

    # 1. per-prior best object (`Losses.py:153`).
    overlap_per_prior = torch.amax(iou, dim=-2)                 # (B, P)
    obj_per_prior = torch.argmax(iou, dim=-2).to(torch.int32)   # (B, P)

    # 2. per-object best prior (`Losses.py:157`) and the forced override
    #    (`Losses.py:164-167`): per prior, the highest claiming object id.
    best_prior_per_obj = torch.argmax(iou, dim=-1)              # (B, M)
    obj_ids = torch.arange(num_gt, dtype=torch.int32, device=device)
    claim = gt_mask[..., None] & (
        best_prior_per_obj[..., None]
        == torch.arange(num_priors, device=device))             # (B, M, P)
    claimant = torch.amax(
        torch.where(claim, obj_ids[:, None], obj_ids.new_tensor(-1)),
        dim=-2)                                                 # (B, P)
    forced = claimant >= 0
    obj_per_prior = torch.where(forced, claimant, obj_per_prior)
    overlap_per_prior = torch.where(forced, iou.new_tensor(1.0),
                                    overlap_per_prior)

    # 3. the matched class and box per prior, background below the
    #    threshold (`Losses.py:171`).
    index = obj_per_prior.long()
    matched_class = torch.gather(gt_classes.to(torch.int32), -1, index)
    matched_class = torch.where(
        overlap_per_prior < iou_threshold,
        matched_class.new_tensor(BACKGROUND_CLASS), matched_class)
    matched_box = torch.gather(
        gt_boxes_xyxy, -2, index[..., None].expand(*index.shape, 4))
    return MatchResult(matched_class, matched_box, overlap_per_prior,
                       obj_per_prior)


def match_single(gt_boxes_xyxy: torch.Tensor, gt_classes: torch.Tensor,
                 gt_mask: torch.Tensor, priors_xyxy: torch.Tensor,
                 iou_threshold: float = 0.5) -> MatchResult:
    """One image's padded GT set, (M, 4), (M,), (M,), against all priors."""
    out = match_batch(gt_boxes_xyxy[None], gt_classes[None], gt_mask[None],
                      priors_xyxy, iou_threshold)
    return MatchResult(*(t[0] for t in out))

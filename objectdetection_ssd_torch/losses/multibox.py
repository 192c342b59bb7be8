"""Multibox loss: match, localization, classification with hard-negative
mining — the port of `objectdetection_ssd_tpu/losses/multibox.py`.

Reference semantics (`Losses.py:119-199`):
  * localization: PLAIN L1 (the reference names it `smooth_l1` but
    instantiates `nn.L1Loss()`, `Losses.py:147`) between predicted offsets
    and encoded GT offsets, the MEAN over the (N_pos, 4) gathered elements
    (`Losses.py:181-182`); huber behind `LossConfig.loc_loss`;
  * classification: per-anchor cross entropy over 21 logits
    (`Losses.py:184`); the positives' CE plus hard-negative mining — zero
    the positives, rank each image's CE row descending, keep the top
    3 * N_pos(image) negatives (`Losses.py:188-195`);
    c_loss = (sum HN + sum pos) / N_pos_total (`Losses.py:197`).

The JAX package's layout choices for the TPU's lanes (class-major CE,
coordinate-major encode, one-hot gathers) are plain gathers here; the
arithmetic of every element is the same.  Callers pass f32 inputs (the
train step upcasts the model's outputs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from objectdetection_ssd_torch.config import (BACKGROUND_CLASS, LossConfig,
                                              NUM_CLASSES_WITH_BG)
from objectdetection_ssd_torch.ops import boxes as box_ops
from objectdetection_ssd_torch.ops import matching


class MultiboxLoss(NamedTuple):
    total: torch.Tensor       # scalar: cls + loc (reference `train_function.py:84`)
    cls: torch.Tensor         # scalar confidence loss
    loc: torch.Tensor         # scalar localization loss
    num_pos: torch.Tensor     # scalar int: total positive anchors in batch


def _cross_entropy_class_major(logits: torch.Tensor, labels: torch.Tensor
                               ) -> torch.Tensor:
    """Per-anchor CE; logits (B, P, C), labels (B, P) -> (B, P)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def _hard_negative_sum(neg_cce: torch.Tensor, keep_per_image: torch.Tensor,
                       hnm_topk: int) -> torch.Tensor:
    """Sum of each image's top ``keep_per_image`` values of ``neg_cce``.

    A partial top-k over ``hnm_topk`` candidates when every image needs at
    most that many (the usual case), else the exact full sort
    (`multibox.py:140-165`); both sum the same multiset.  Choosing the
    branch reads one scalar from the device.
    """
    num_priors = neg_cce.shape[1]
    if 0 < hnm_topk < num_priors and int(keep_per_image.max()) <= hnm_topk:
        vals = torch.topk(neg_cce, hnm_topk, dim=1, sorted=True).values
    else:
        vals = torch.sort(neg_cce, dim=1, descending=True).values
    rank = torch.arange(vals.shape[1], device=neg_cce.device)
    keep = rank[None, :] < keep_per_image[:, None]
    return torch.sum(torch.where(keep, vals, vals.new_tensor(0.0)))


def multibox_loss(pred_offsets: torch.Tensor,
                  pred_logits: torch.Tensor,
                  gt_boxes_xyxy: torch.Tensor,
                  gt_classes: torch.Tensor,
                  gt_mask: torch.Tensor,
                  priors_cxcywh: torch.Tensor,
                  config: LossConfig = LossConfig()) -> MultiboxLoss:
    """The SSD multibox loss of a padded batch.

    Args:
      pred_offsets: (B, P, 4) predicted gcxgcy regression outputs.
      pred_logits:  (B, P, 21) class logits.
      gt_boxes_xyxy: (B, M, 4) normalized GT corner boxes (padded).
      gt_classes:   (B, M) int class ids.
      gt_mask:      (B, M) bool validity mask.
      priors_cxcywh: (P, 4) priors in center form.
    """
    if pred_logits.shape[-1] != NUM_CLASSES_WITH_BG:
        raise ValueError(f"expected {NUM_CLASSES_WITH_BG} logits, got "
                         f"{pred_logits.shape[-1]}")
    priors_xyxy = box_ops.cxcywh_to_xyxy(priors_cxcywh)
    match = matching.match_batch(gt_boxes_xyxy, gt_classes, gt_mask,
                                 priors_xyxy, config.match_iou_threshold)

    pos = match.matched_class != BACKGROUND_CLASS          # (B, P)
    num_pos_per_image = torch.sum(pos, dim=1)              # (B,)
    num_pos = torch.sum(num_pos_per_image)
    pos_f = pos.to(pred_offsets.dtype)

    # ---- localization (`Losses.py:181-182`) -------------------------------
    # Negative priors' matched boxes can be zero-area pads, whose log()
    # would be -inf and inf * 0-mask = NaN: background priors take the prior
    # itself as their target (zero offsets); they never reach the sum.
    gx1, gy1, gx2, gy2 = match.matched_box.unbind(-1)      # (B, P) each
    pcx, pcy, pw, ph = priors_cxcywh.unbind(-1)            # (P,) each
    cx = torch.where(pos, (gx1 + gx2) * 0.5, pcx)
    cy = torch.where(pos, (gy1 + gy2) * 0.5, pcy)
    w = torch.where(pos, gx2 - gx1, pw)
    h = torch.where(pos, gy2 - gy1, ph)
    cvar, svar = config.center_variance_inv, config.size_variance_inv
    target = torch.stack([
        (cx - pcx) * cvar / pw,
        (cy - pcy) * cvar / ph,
        torch.log(w / pw) * svar,
        torch.log(h / ph) * svar,
    ], dim=-1)                                             # (B, P, 4)
    diff = pred_offsets - target
    if config.loc_loss == "huber":
        elt = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                          diff.abs() - 0.5)
    elif config.loc_loss == "l1":
        elt = diff.abs()
    else:
        raise ValueError(f"unknown loc_loss {config.loc_loss!r}")
    # nn.L1Loss() means over the gathered (N_pos, 4) tensor: sum / (4*N_pos).
    loc_sum = torch.sum(elt * pos_f[..., None])
    safe_pos = torch.clamp(num_pos, min=1)
    loc_loss = loc_sum / (4.0 * safe_pos)

    # ---- classification with hard-negative mining (`Losses.py:184-197`) ---
    cce = _cross_entropy_class_major(pred_logits, match.matched_class)
    pos_loss_sum = torch.sum(cce * pos_f)
    neg_cce = torch.where(pos, cce.new_tensor(0.0), cce)
    keep_per_image = config.neg_pos_ratio * num_pos_per_image   # (B,)
    hn_loss_sum = _hard_negative_sum(neg_cce, keep_per_image,
                                     int(config.hnm_topk))
    cls_loss = (hn_loss_sum + pos_loss_sum) / safe_pos

    return MultiboxLoss(total=cls_loss + loc_loss, cls=cls_loss,
                        loc=loc_loss, num_pos=num_pos)


def multibox_loss_single(pred_offsets: torch.Tensor,
                         pred_logits: torch.Tensor,
                         gt_boxes_xyxy: torch.Tensor,
                         gt_classes: torch.Tensor,
                         priors_cxcywh: torch.Tensor,
                         config: LossConfig = LossConfig()) -> MultiboxLoss:
    """Single-image multibox loss (the reference's per-image path,
    `Losses.py:100-117,201-225`): the batched loss with a batch of one and
    every GT row valid.  Inputs: (P, 4), (P, 21), (n, 4), (n,)."""
    mask = torch.ones((1, gt_boxes_xyxy.shape[0]), dtype=torch.bool,
                      device=gt_boxes_xyxy.device)
    return multibox_loss(pred_offsets[None], pred_logits[None],
                         gt_boxes_xyxy[None], gt_classes[None], mask,
                         priors_cxcywh, config)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss (reference `Focal_Loss`, `Losses.py:228-242`).

    The reference defines but never uses it.  ``targets`` is a {0,1}
    tensor shaped like ``logits``; the focal weight is a detached
    multiplier of BCE-with-logits, as the reference's `w.detach()` is.
    """
    p = torch.sigmoid(logits)
    pt = p * targets + (1 - p) * (1 - targets)
    w = alpha * targets + (1 - alpha) * (1 - targets)
    w = (w * (1 - pt) ** gamma).detach()
    bce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    return torch.mean(w * bce)

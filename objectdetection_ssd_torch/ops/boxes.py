"""Box geometry on tensors — the port of `objectdetection_ssd_tpu/ops/boxes.py`.

Coordinate frames: ``xyxy`` corners (x_min, y_min, x_max, y_max), ``cxcywh``
centers (cx, cy, w, h), ``gcxgcy`` regression offsets against a prior.
Every function keeps the operation order of its JAX counterpart so that the
two agree bit for bit on f32 inputs:

  * decode: ``g_cxcy * p_wh / 10 + p_cxcy`` and ``exp(g_wh / 5) * p_wh``
    (reference `Util.py:86-91`);
  * encode: ``(cxcy - p_cxcy) / (p_wh / 10)`` and ``log(wh / p_wh) * 5``
    (reference `Util.py:98-102`);
  * IoU: ``inter / ((area_a + area_b) - inter)`` (reference
    `Util.py:288-301`).

The greedy-NMS kernel (`csrc/nms.cu`) computes its IoU with the same
expression.  The legacy ops of the reference's notebook code follow:
`decode_tanh`, `mixed_class_nms`, the (y, x, y, x) converters and
`pairwise_iou_rescaled`.
"""

from __future__ import annotations

import torch

CENTER_VARIANCE_INV = 10.0
SIZE_VARIANCE_INV = 5.0


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center boxes -> corner boxes (reference `Util.py:93-96`)."""
    xy = boxes[..., :2]
    half_wh = boxes[..., 2:] * 0.5
    return torch.cat([xy - half_wh, xy + half_wh], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner boxes -> center boxes (reference `Util.py:57-63`)."""
    lo = boxes[..., :2]
    hi = boxes[..., 2:]
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def encode(boxes_cxcywh: torch.Tensor, priors_cxcywh: torch.Tensor,
           *, center_variance_inv: float = CENTER_VARIANCE_INV,
           size_variance_inv: float = SIZE_VARIANCE_INV) -> torch.Tensor:
    """Box -> regression offsets vs priors (reference `Util.py:98-102`)."""
    g_xy = (boxes_cxcywh[..., :2] - priors_cxcywh[..., :2]) / (
        priors_cxcywh[..., 2:] / center_variance_inv)
    g_wh = torch.log(boxes_cxcywh[..., 2:] / priors_cxcywh[..., 2:]) * (
        size_variance_inv)
    return torch.cat([g_xy, g_wh], dim=-1)


def decode(offsets: torch.Tensor, priors_cxcywh: torch.Tensor,
           *, center_variance_inv: float = CENTER_VARIANCE_INV,
           size_variance_inv: float = SIZE_VARIANCE_INV) -> torch.Tensor:
    """Regression offsets -> cxcywh boxes (reference `Util.py:86-91`)."""
    xy = (offsets[..., :2] * priors_cxcywh[..., 2:] / center_variance_inv
          + priors_cxcywh[..., :2])
    wh = torch.exp(offsets[..., 2:] / size_variance_inv) * (
        priors_cxcywh[..., 2:])
    return torch.cat([xy, wh], dim=-1)


def area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,) box areas; negative extents are NOT clamped
    (matches reference `Util.py:294-295`)."""
    wh = boxes_xyxy[..., 2:] - boxes_xyxy[..., :2]
    return wh[..., 0] * wh[..., 1]


def pairwise_intersection(a_xyxy: torch.Tensor,
                          b_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., n1, 4) x (..., n2, 4) -> (..., n1, n2) intersection areas
    (reference `find_intersection`, `Util.py:252-265`)."""
    ax1, ay1, ax2, ay2 = (a_xyxy[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b_xyxy[..., None, :, i] for i in range(4))
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0.0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0.0)
    return ix * iy


def pairwise_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., n1, 4) x (..., n2, 4) -> (..., n1, n2) IoU
    (reference `get_jaccard_tensor1`, `Util.py:288-301`)."""
    inter = pairwise_intersection(a_xyxy, b_xyxy)
    union = area(a_xyxy)[..., :, None] + area(b_xyxy)[..., None, :] - inter
    return inter / union


def decode_tanh(pred: torch.Tensor, priors_cxcywh, grid_sizes
                ) -> torch.Tensor:
    """fastai-style tanh-bounded decode of the zoom/ratio anchor variant
    (reference `get_p_bbox_labels_za`, `Util.py:409-424`):

        xy = tanh(p)[..., :2] / 2 * grid_size + prior_xy
        wh = (tanh(p)[..., 2:] / 2 + 1) * prior_wh

    ``priors_cxcywh`` (P, 4) and ``grid_sizes`` (P,) are the pair that
    `ops.priors.zoom_ratio_priors` returns (arrays or tensors; they move to
    ``pred``'s device).  A legacy decode: both model families decode with
    `decode`."""
    priors = torch.as_tensor(priors_cxcywh, device=pred.device)
    gs = torch.as_tensor(grid_sizes, device=pred.device)[..., :, None]
    t = torch.tanh(pred)
    xy = t[..., :2] / 2.0 * gs + priors[..., :2]
    wh = (t[..., 2:] / 2.0 + 1.0) * priors[..., 2:]
    return torch.cat([xy, wh], dim=-1)


def mixed_class_nms(boxes_xyxy: torch.Tensor, classes: torch.Tensor,
                    probs: torch.Tensor,
                    overlap_threshold: float = 0.5) -> torch.Tensor:
    """Single-pass NMS over a mixed-class detection set: the suppression
    rule of the reference's standalone `nms` (`Util.py:519-553`, never
    called by its `inference`).

    A box is suppressed iff another box of the same class has IoU strictly
    greater than ``overlap_threshold`` with it and a probability greater
    than or equal to its own: ties suppress both, and a box never
    suppresses itself.  One comparison over all pairs, no sequential
    dependency.

    Args: boxes_xyxy (..., n, 4); classes (..., n) int; probs (..., n).
    Returns: the (..., n) bool keep mask."""
    iou = pairwise_iou(boxes_xyxy, boxes_xyxy)
    n = boxes_xyxy.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=boxes_xyxy.device)
    over = (iou > overlap_threshold) & ~eye
    same = classes[..., :, None] == classes[..., None, :]
    geq = probs[..., None, :] >= probs[..., :, None]     # prob_j >= prob_i
    return ~(over & same & geq).any(dim=-1)


# The reference's (y, x, y, x) converters, used only by its notebook cells
# (`Util.py:45-54, 65-84, 354-368`): pure axis shuffles over (..., 4).  A
# list, not a tuple: a tuple would index one dimension per entry.
_SWAP_XY = [1, 0, 3, 2]


def xyxy_to_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (y1, x1, y2, x2) (`Util.py:45-54`)."""
    return boxes[..., _SWAP_XY]


def yxyx_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(y1, x1, y2, x2) -> (x1, y1, x2, y2) (`Util.py:65-84`)."""
    return boxes[..., _SWAP_XY]


def cxcywh_to_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (y1, x1, y2, x2) corners (reference
    `xywh_to_yxyx`, `Util.py:87-96`; its "xywh" is center-based)."""
    return xyxy_to_yxyx(cxcywh_to_xyxy(boxes))


def yxyx_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(y1, x1, y2, x2) -> (cx, cy, w, h) (reference `get_xywh_from_yxyx`,
    `Util.py:354-368`)."""
    return xyxy_to_cxcywh(yxyx_to_xyxy(boxes))


def pairwise_iou_rescaled(raw_gt_xyxy: torch.Tensor, image_wh,
                          other_xyxy: torch.Tensor,
                          target_size: float = 300.0) -> torch.Tensor:
    """IoU of raw-pixel GT boxes (..., n1, 4) against ``target_size``-frame
    boxes (..., n2, 4): the reference's `get_jaccard_tensor`
    (`Util.py:267-286`) rescales the GT by the image's (w, h) into the
    300 x 300 frame first.

    ``image_wh`` is one (2,) size, or sizes that broadcast as (w, h, w, h)
    against the GT boxes: (..., 1, 2) per image, (..., n1, 2) per box.  It
    becomes f32 on the boxes' device."""
    dev = raw_gt_xyxy.device
    wh = torch.as_tensor(image_wh, dtype=torch.float32, device=dev)
    # A tensor numerator: a Python number over a tensor is computed as a
    # multiply by the reciprocal, which can round differently.
    target = torch.tensor(target_size, dtype=torch.float32, device=dev)
    scale = target / torch.cat([wh, wh], dim=-1)
    return pairwise_iou(raw_gt_xyxy * scale, other_xyxy)

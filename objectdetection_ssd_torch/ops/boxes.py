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
expression.
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

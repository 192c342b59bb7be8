"""SSD training augmentations in numpy — a copy of
`objectdetection_ssd_tpu/data/augment.py`, the path the Loader takes when
the native library is off (`DataConfig.use_native_augment=False`) or
unavailable.

The reference pipeline (`transform`, `Util.py:566-607`):

  1. photometric distortion: brightness, contrast, saturation, hue — each
     with p=0.5 in a random order; factors U(0.5, 1.5), hue delta
     U(-18/255, 18/255) (`Util.py:752-780`);
  2. zoom-out expand onto an ImageNet-mean canvas, scale U(1, 4), p=0.5
     (`Util.py:610-645`);
  3. SSD random crop: min-overlap from {0,.1,.3,.5,.7,.9,None}, <=50 trials
     per draw, scale U(0.3, 1) per axis, aspect ratio in (0.5, 2); keeps the
     boxes whose centers fall inside, clips them (`Util.py:648-729`);
  4. horizontal flip p=0.5 with x' = W - x - 1 and a column swap
     (`Util.py:732-748`).

Images are float32 RGB in [0, 1], HWC; boxes absolute-pixel xyxy.  The
brightness/contrast/saturation ops are torchvision's blend formulas; hue is
a float RGB->HSV->RGB roundtrip (torchvision quantizes through PIL's uint8
HSV).  The draws from ``rng`` are the JAX package's, in the same order, so
both packages give the same example for the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from objectdetection_ssd_torch.config import IMAGENET_MEAN

Array = np.ndarray

_GRAY_W = np.asarray([0.299, 0.587, 0.114], np.float32)


def adjust_brightness(img: Array, factor: float) -> Array:
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img: Array, factor: float) -> Array:
    mean = (img @ _GRAY_W).mean(dtype=np.float32)
    return np.clip(factor * img + (1 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img: Array, factor: float) -> Array:
    gray = (img @ _GRAY_W)[..., None]
    return np.clip(factor * img + (1 - factor) * gray, 0.0, 1.0)


def adjust_hue(img: Array, delta: float) -> Array:
    """Shift hue by ``delta`` (in turns, torchvision convention)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    span = maxc - minc
    s = np.where(maxc > 0, span / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(span, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + delta) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return np.clip(out, 0.0, 1.0)


def photometric_distort(img: Array, rng: np.random.Generator) -> Array:
    """Each distortion with p=0.5, random order (`Util.py:752-780`)."""
    ops = [adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue]
    order = rng.permutation(len(ops))
    for idx in order:
        if rng.random() < 0.5:
            op = ops[idx]
            if op is adjust_hue:
                factor = rng.uniform(-18 / 255.0, 18 / 255.0)
            else:
                factor = rng.uniform(0.5, 1.5)
            img = op(img, factor)
    return img


def expand(img: Array, boxes: Array, rng: np.random.Generator,
           max_scale: float = 4.0) -> Tuple[Array, Array]:
    """Zoom-out onto an ImageNet-mean canvas (`Util.py:610-645`)."""
    h, w = img.shape[:2]
    scale = rng.uniform(1.0, max_scale)
    new_h, new_w = int(scale * h), int(scale * w)
    canvas = np.empty((new_h, new_w, 3), np.float32)
    canvas[:] = np.asarray(IMAGENET_MEAN, np.float32)
    left = rng.integers(0, new_w - w + 1)
    top = rng.integers(0, new_h - h + 1)
    canvas[top:top + h, left:left + w] = img
    return canvas, boxes + np.asarray([left, top, left, top], np.float32)


def _iou_one_to_many(crop: Array, boxes: Array) -> Array:
    lo = np.maximum(crop[:2], boxes[:, :2])
    hi = np.minimum(crop[2:], boxes[:, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a_crop = (crop[2] - crop[0]) * (crop[3] - crop[1])
    a_box = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (a_crop + a_box - inter)


def random_crop(img: Array, boxes: Array, labels: Array,
                rng: np.random.Generator
                ) -> Tuple[Array, Array, Array]:
    """SSD min-IoU random crop (`Util.py:648-729`)."""
    h, w = img.shape[:2]
    while True:
        min_overlap = rng.choice(
            np.asarray([0.0, 0.1, 0.3, 0.5, 0.7, 0.9, np.nan]))
        if np.isnan(min_overlap):
            return img, boxes, labels
        for _ in range(50):
            scale_h = rng.uniform(0.3, 1.0)
            scale_w = rng.uniform(0.3, 1.0)
            new_h, new_w = int(scale_h * h), int(scale_w * w)
            if not 0.5 < new_h / new_w < 2:
                continue
            left = rng.integers(0, w - new_w + 1)
            top = rng.integers(0, h - new_h + 1)
            crop = np.asarray([left, top, left + new_w, top + new_h],
                              np.float32)
            if len(boxes) == 0:
                return (img[top:top + new_h, left:left + new_w],
                        boxes, labels)
            overlap = _iou_one_to_many(crop, boxes)
            if overlap.max() < min_overlap:
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            inside = ((centers[:, 0] > crop[0]) & (centers[:, 0] < crop[2]) &
                      (centers[:, 1] > crop[1]) & (centers[:, 1] < crop[3]))
            if not inside.any():
                continue
            new_boxes = boxes[inside].copy()
            new_boxes[:, :2] = np.maximum(new_boxes[:, :2], crop[:2]) - crop[:2]
            new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:], crop[2:]) - crop[:2]
            return (img[top:top + new_h, left:left + new_w],
                    new_boxes, labels[inside])


def hflip(img: Array, boxes: Array) -> Tuple[Array, Array]:
    """Horizontal flip with the reference's exact coordinate math
    (x' = width - x - 1, then swap x columns; `Util.py:732-748`)."""
    w = img.shape[1]
    new_boxes = boxes.copy()
    new_boxes[:, 0] = w - boxes[:, 0] - 1
    new_boxes[:, 2] = w - boxes[:, 2] - 1
    new_boxes = new_boxes[:, [2, 1, 0, 3]]
    return img[:, ::-1], new_boxes


def train_transform(img: Array, boxes: Array, labels: Array,
                    rng: np.random.Generator
                    ) -> Tuple[Array, Array, Array]:
    """Full training pipeline (`Util.py:566-607`):
    photometric -> expand(p=.5) -> random_crop -> hflip(p=.5)."""
    img = photometric_distort(img, rng)
    if rng.random() < 0.5:
        img, boxes = expand(img, boxes, rng)
    img, boxes, labels = random_crop(img, boxes, labels, rng)
    if rng.random() < 0.5:
        img, boxes = hflip(img, boxes)
    return img, boxes, labels

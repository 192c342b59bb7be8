"""Host data helpers — copies of `objectdetection_ssd_tpu/data/pipeline.py`:
the image loading that `Detector.detect_images` needs (`:35-76`), and
`Example` / `collate`, the train batch contract (`:79-85`, `:141-170`).

PIL is imported inside the functions: the package itself must import
without it.  The JAX package's native C++ resize is not ported yet; the
resize here is always PIL's bilinear one (`transforms.Resize`,
reference `Dataset.py:10`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode an image file to float32 RGB HWC in [0, 1]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to (size, size) — matches transforms.Resize
    (`Dataset.py:10`)."""
    from PIL import Image
    im = Image.fromarray((img * 255.0).astype(np.uint8))
    im = im.resize((size, size), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0


def quantize_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> raw uint8 RGB (round-to-nearest)."""
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


@dataclasses.dataclass
class Example:
    image: np.ndarray        # (S, S, 3): uint8 raw RGB or float32 normalized
    boxes: np.ndarray        # (n, 4) float32, xyxy in [0, 1]
    classes: np.ndarray      # (n,) int32
    image_id: int


def collate(examples: Sequence[Example], max_boxes: int,
            image_size: Optional[int] = None,
            image_dtype: Optional[np.dtype] = None) -> Dict[str, np.ndarray]:
    """Stack examples into one dense padded batch: ``images`` (B, S, S, 3),
    ``boxes`` (B, M, 4) f32 xyxy, ``classes`` (B, M) int32, ``mask`` (B, M)
    bool and ``image_ids`` (B,) int32; objects past ``max_boxes`` are
    dropped.

    ``image_size``/``image_dtype`` make an EMPTY example list collatable.
    """
    bs = len(examples)
    if bs == 0 and (image_size is None or image_dtype is None):
        raise ValueError(
            "empty example list needs explicit image_size + image_dtype")
    s = examples[0].image.shape[0] if examples else image_size
    dt = examples[0].image.dtype if examples else np.dtype(image_dtype)
    batch = {
        "images": np.zeros((bs, s, s, 3), dt),
        "boxes": np.zeros((bs, max_boxes, 4), np.float32),
        "classes": np.zeros((bs, max_boxes), np.int32),
        "mask": np.zeros((bs, max_boxes), bool),
        "image_ids": np.zeros((bs,), np.int32),
    }
    for i, ex in enumerate(examples):
        n = min(len(ex.boxes), max_boxes)
        batch["images"][i] = ex.image
        batch["boxes"][i, :n] = ex.boxes[:n]
        batch["classes"][i, :n] = ex.classes[:n]
        batch["mask"][i, :n] = True
        batch["image_ids"][i] = ex.image_id
    return batch

"""Image loading for serving — a copy of the helpers of
`objectdetection_ssd_tpu/data/pipeline.py:35-76` that `Detector.detect_images`
needs.

PIL is imported inside the functions: the package itself must import
without it.  The JAX package's native C++ resize is not ported yet; the
resize here is always PIL's bilinear one (`transforms.Resize`,
reference `Dataset.py:10`).
"""

from __future__ import annotations

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

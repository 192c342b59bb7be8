"""Synthetic VOC fixture — the port of `objectdetection_ssd_tpu/data/
synthetic.py`: a miniature VOCdevkit tree (images, XML annotations,
ImageSets lists) for hermetic tests and smoke runs.

The layout is what `voc.voc_file_lists` expects (reference
`DataLists.py:39-67`): VOC2007 ids numeric (zero-padded on read), VOC2012
ids arbitrary strings.  With the same arguments the XML, the lists and the
pixels equal the JAX package's: `render_image` draws from ``rng`` exactly
as its `_write_image` does.  Only the JPEG save needs PIL; a caller without
PIL passes ``image_sink`` and keeps the pixels (e.g. in a packed cache,
`cache.write`).
"""

from __future__ import annotations

import colorsys
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from objectdetection_ssd_torch.config import VOC_CLASSES

_XML_TEMPLATE = """<annotation>
  <folder>{year}</folder>
  <filename>{stem}.jpg</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
{objects}
</annotation>
"""

_OBJ_TEMPLATE = """  <object>
    <name>{name}</name>
    <pose>Unspecified</pose>
    <truncated>0</truncated>
    <difficult>{difficult}</difficult>
    <bndbox><xmin>{xmin}</xmin><ymin>{ymin}</ymin><xmax>{xmax}</xmax><ymax>{ymax}</ymax></bndbox>
  </object>"""


def class_color(class_id: int) -> np.ndarray:
    """Deterministic saturated colour per class id (learnable fixtures)."""
    h = (class_id * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 1.0, 1.0)
    return np.asarray([int(r * 255), int(g * 255), int(b * 255)], np.uint8)


def render_image(w: int, h: int, rng: np.random.Generator,
                 boxes: List[Tuple[int, int, int, int]],
                 colors: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """(h, w, 3) uint8: a flat background with each box filled (its class
    colour, or a random one)."""
    img = np.full((h, w, 3), rng.integers(40, 216, 3, dtype=np.uint8),
                  np.uint8)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        fill = (colors[i] if colors is not None
                else rng.integers(0, 256, 3, dtype=np.uint8))
        img[y1:y2, x1:x2] = fill
    return img


def save_jpeg(path: str, pixels: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(pixels).save(path, quality=90)


def generate_voc(root: str, num_2007: int = 8, num_2012: int = 4,
                 image_size: Tuple[int, int] = (160, 120),
                 max_objects: int = 4, seed: int = 0,
                 difficult_fraction: float = 0.1,
                 num_classes: int = len(VOC_CLASSES),
                 class_color_coding: bool = False,
                 image_sink: Callable[[str, np.ndarray], None] = save_jpeg
                 ) -> str:
    """Create a synthetic VOCdevkit under ``root``; returns the root path.

    ``class_color_coding=True`` fills each object's rectangle with a fixed
    colour per class, which makes the fixture learnable.  ``image_sink``
    receives each image's path and pixels (default: a JPEG at that path).
    """
    rng = np.random.default_rng(seed)
    w, h = image_size
    for year, count, id_fmt in (("VOC2007", num_2007, "{:06d}"),
                                ("VOC2012", num_2012, "2012_{:04d}")):
        base = os.path.join(root, year)
        os.makedirs(os.path.join(base, "JPEGImages"), exist_ok=True)
        os.makedirs(os.path.join(base, "Annotations"), exist_ok=True)
        os.makedirs(os.path.join(base, "ImageSets", "Main"), exist_ok=True)
        ids = []
        for i in range(count):
            stem = id_fmt.format(i + 1)
            ids.append(str(i + 1) if year == "VOC2007" else stem)
            n_obj = int(rng.integers(1, max_objects + 1))
            objs, boxes, colors = [], [], []
            for _ in range(n_obj):
                x1 = int(rng.integers(1, w - 32))
                y1 = int(rng.integers(1, h - 32))
                x2 = int(rng.integers(x1 + 16, min(x1 + 80, w)))
                y2 = int(rng.integers(y1 + 16, min(y1 + 80, h)))
                cid = int(rng.integers(0, num_classes))
                difficult = int(rng.random() < difficult_fraction)
                # VOC XML coords are 1-indexed; parse subtracts 1.
                objs.append(_OBJ_TEMPLATE.format(
                    name=VOC_CLASSES[cid], difficult=difficult,
                    xmin=x1 + 1, ymin=y1 + 1, xmax=x2 + 1, ymax=y2 + 1))
                boxes.append((x1, y1, x2, y2))
                colors.append(class_color(cid))
            with open(os.path.join(base, "Annotations", stem + ".xml"),
                      "w") as f:
                f.write(_XML_TEMPLATE.format(year=year, stem=stem, w=w, h=h,
                                             objects="\n".join(objs)))
            image_sink(os.path.join(base, "JPEGImages", stem + ".jpg"),
                       render_image(w, h, rng, boxes,
                                    colors if class_color_coding else None))
        with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
        if year == "VOC2012":
            with open(os.path.join(base, "ImageSets", "Main", "test.txt"),
                      "w") as f:
                f.write("\n".join(ids) + "\n")
    return root

"""PASCAL VOC ingestion: XML annotation parsing, file lists, splits — a copy
of `objectdetection_ssd_tpu/data/voc.py`.

Reference behaviour reproduced:
  * `parse_xml` (`DataLists.py:8-30`): per <object> read name/difficult/
    bndbox, subtract 1 from every coordinate (VOC is 1-indexed), drop
    labels outside the 20-class vocabulary;
  * file lists (`DataLists.py:39-67`): VOC2007 trainval ids zero-padded to 6
    digits, VOC2012 ids verbatim, 2007 first; the test split reads VOC2012
    test.txt;
  * split (`train.py:12-19`): seed 10; the reference samples the val ids
    WITH replacement via torch.randint (``parity=True``); the default is a
    without-replacement permutation split of the same fraction.

numpy and the standard library only (torch is imported inside the parity
split): the Loader's spawn workers import this module.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import xml.etree.ElementTree as ET
from concurrent.futures import ProcessPoolExecutor
from typing import List, Tuple

import numpy as np

from objectdetection_ssd_torch.config import CLASS_TO_ID


@dataclasses.dataclass
class ImageRecord:
    """One image with its ground truth (absolute pixel xyxy, 0-indexed)."""

    image_path: str
    boxes_xyxy: np.ndarray      # (n, 4) float32
    classes: np.ndarray         # (n,) int32, in [0, 20)
    difficulties: np.ndarray    # (n,) bool
    image_id: int = -1          # index into the source list

    def without_difficult(self) -> "ImageRecord":
        """Drop difficult objects (reference `Dataset.py:29-31`)."""
        keep = ~self.difficulties
        return dataclasses.replace(
            self, boxes_xyxy=self.boxes_xyxy[keep], classes=self.classes[keep],
            difficulties=self.difficulties[keep])


def parse_voc_xml(xml_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse one VOC annotation file -> (boxes_xyxy, class_ids, difficult),
    coordinates shifted by -1, unknown labels skipped (`DataLists.py:17-25`).
    """
    root = ET.parse(xml_path).getroot()
    boxes, classes, difficult = [], [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.lower().strip()
        cls = CLASS_TO_ID.get(name)
        if cls is None:
            continue
        bb = obj.find("bndbox")
        boxes.append([
            int(float(bb.find("xmin").text)) - 1,
            int(float(bb.find("ymin").text)) - 1,
            int(float(bb.find("xmax").text)) - 1,
            int(float(bb.find("ymax").text)) - 1,
        ])
        classes.append(cls)
        difficult.append(obj.find("difficult").text == "1")
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32),
            np.asarray(difficult, bool))


def _read_ids(path: str) -> List[str]:
    with open(path) as f:
        return [line.split()[0] for line in f if line.strip()]


def voc_file_lists(voc_root: str, train: bool = True,
                   allow_partial: bool = False
                   ) -> Tuple[List[str], List[str]]:
    """(image_paths, xml_paths) for VOC07+12 trainval (or VOC12 test).

    A missing year's list file is a hard error unless ``allow_partial``
    (CLI ``--allow-partial-voc``): a typo'd root must not silently train on
    a partial corpus.
    """
    images, xmls = [], []
    if train:
        years = [("VOC2007", "trainval.txt", "{:06d}"),
                 ("VOC2012", "trainval.txt", "{}")]
    else:
        years = [("VOC2012", "test.txt", "{}")]
    missing = []
    for year, list_name, fmt in years:
        base = os.path.join(voc_root, year)
        ids_file = os.path.join(base, "ImageSets", "Main", list_name)
        if not os.path.exists(ids_file):
            missing.append(ids_file)
            if allow_partial:
                logging.getLogger("objectdetection_ssd_torch").warning(
                    "VOC list file missing: %s — skipping %s "
                    "(--allow-partial-voc)", ids_file, year)
            continue
        for raw in _read_ids(ids_file):
            # 2007 ids are ints needing zero-padding (`DataLists.py:41`).
            sid = fmt.format(int(raw)) if fmt == "{:06d}" else raw
            images.append(os.path.join(base, "JPEGImages", sid + ".jpg"))
            xmls.append(os.path.join(base, "Annotations", sid + ".xml"))
    if missing and not allow_partial:
        raise FileNotFoundError(
            f"VOC list file(s) missing under {voc_root!r}: {missing} — "
            "fix the dataset root, or pass allow_partial=True "
            "(--allow-partial-voc) to train on the years present")
    if not images:
        raise FileNotFoundError(
            f"no VOC images found under {voc_root!r}: "
            + (f"missing list files {missing}" if missing
               else "the ImageSets lists are empty"))
    return images, xmls


def _best_parser():
    """The native single-pass C++ parser when built, else ElementTree (a
    counted fall-through, `native.note_fallback`)."""
    from objectdetection_ssd_torch import native
    if native.available():
        return native.parse_voc_xml
    native.note_fallback()
    return parse_voc_xml


def load_records(voc_root: str, train: bool = True,
                 num_workers: int = 0,
                 allow_partial: bool = False) -> List[ImageRecord]:
    """Parse all annotations into ImageRecords (parallel across processes)."""
    images, xmls = voc_file_lists(voc_root, train, allow_partial)
    parser = _best_parser()
    if num_workers and len(xmls) > 64:
        import multiprocessing
        with ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            parsed = list(pool.map(parser, xmls, chunksize=256))
    else:
        parsed = [parser(x) for x in xmls]
    return [
        ImageRecord(img, b, c, d, image_id=i)
        for i, (img, (b, c, d)) in enumerate(zip(images, parsed))
    ]


def train_val_split(n: int, val_fraction: float = 0.1, seed: int = 10,
                    parity: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (train_ids, val_ids) split over range(n).

    Default: a without-replacement permutation split.  ``parity=True``
    replicates the reference's torch.randint-with-replacement sampling
    (`train.py:13-19`) exactly: val ids WITH duplicates in torch's emission
    order, train the complement of the val id set, ascending.  It reseeds
    torch's global generator, as the reference does.
    """
    n_val = int(n * val_fraction)
    if parity:
        import torch
        torch.random.manual_seed(seed)
        val = torch.randint(0, n, (n_val,)).tolist()
        val_set = set(val)
        train = np.asarray([i for i in range(n) if i not in val_set],
                           np.int64)
        return train, np.asarray(val, np.int64)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])

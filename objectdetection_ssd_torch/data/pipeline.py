"""Batched input pipeline: decode -> augment -> resize -> normalize -> pad —
the port of `objectdetection_ssd_tpu/data/pipeline.py`.

  * ragged per-image ground truth becomes a dense ``(B, max_boxes)`` pad and
    a validity mask (`collate`), so a batch is a few fixed-shape arrays;
  * images are NHWC, 300x300, shipped as raw uint8 (the model normalizes on
    the card) or ImageNet-normalized float32 (`DataConfig.transfer_dtype`);
  * box coordinates are normalized by the post-augmentation image size
    (reference `Dataset.py:35-36`);
  * a spawn process pool prepares the examples of a batch in parallel
    (`Loader`), and `prefetch` overlaps host batching with the card's steps.

Resize and augmentation run in the native C++ library (`native.py`) when it
is built, as in the JAX package; each fall-through to PIL / numpy where the
native path was wanted is counted in `native.fallbacks`.

This module, and everything it imports, imports numpy and the standard
library only — not torch: the Loader's spawn workers import it, and so
start quickly and never touch the card.  PIL is imported inside the
functions that decode or resize through it.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from objectdetection_ssd_torch import native
from objectdetection_ssd_torch.config import (IMAGENET_MEAN, IMAGENET_STD,
                                              DataConfig)
from objectdetection_ssd_torch.data import augment
from objectdetection_ssd_torch.data import cache as cache_lib
from objectdetection_ssd_torch.data.voc import ImageRecord


def load_image(path: str) -> np.ndarray:
    """Decode an image file to float32 RGB HWC in [0, 1]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to (size, size) through PIL's uint8 image — matches
    transforms.Resize (`Dataset.py:10`)."""
    from PIL import Image
    im = Image.fromarray((img * 255.0).astype(np.uint8))
    im = im.resize((size, size), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0


def normalize_image(img: np.ndarray) -> np.ndarray:
    """ImageNet mean/std normalization (`Dataset.py:12`)."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (img - mean) / std


def preprocess_image(img: np.ndarray, size: int,
                     normalize: bool = True) -> np.ndarray:
    """Resize (+ normalize): the native resample of the float image when
    the library is built (no uint8 step), PIL's otherwise (a counted
    fall-through).  ``normalize=False`` returns the raw [0, 1] resample,
    which the uint8 transfer mode quantizes."""
    if native.available():
        try:
            return native.resize_normalize(img, size, normalize=normalize)
        except ValueError:              # an input the library cannot take
            pass
    native.note_fallback()
    resized = resize_image(img, size)
    return normalize_image(resized) if normalize else resized


def quantize_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> raw uint8 RGB (round-to-nearest)."""
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


@dataclasses.dataclass
class Example:
    image: np.ndarray        # (S, S, 3): uint8 raw RGB or float32 normalized
    boxes: np.ndarray        # (n, 4) float32, xyxy in [0, 1]
    classes: np.ndarray      # (n,) int32
    image_id: int


def prepare_example(record: ImageRecord, image_size: int,
                    augment_example: bool, keep_difficult: bool,
                    seed: Optional[int] = None,
                    cache_path: Optional[str] = None,
                    cache_index: int = -1,
                    use_native_augment: bool = True,
                    transfer_dtype: str = "uint8") -> Example:
    """Decode + (optionally) augment one record into a fixed-size example.

    With ``cache_path`` set, pixels come from the packed decoded-image cache
    (`data/cache.py`) instead of an image-file decode.  Augmentation runs
    in the native pipeline when built (one call including resize and
    normalize), in numpy otherwise.  ``transfer_dtype="uint8"`` emits raw
    0-255 pixels.
    """
    want_u8 = transfer_dtype == "uint8"
    rec = record if keep_difficult else record.without_difficult()
    if cache_path is not None and cache_index >= 0:
        img = cache_lib.get_image(cache_path, cache_index)
    else:
        img = load_image(rec.image_path)
    boxes = rec.boxes_xyxy.astype(np.float32)
    classes = rec.classes
    if augment_example and use_native_augment:
        if native.available():
            try:
                out_img, out_boxes, out_labels = native.train_augment(
                    img, boxes, classes, seed or 0, image_size,
                    normalize=not want_u8)
                if want_u8:
                    out_img = quantize_uint8(out_img)
                return Example(out_img, out_boxes,
                               out_labels.astype(np.int32), rec.image_id)
            except ValueError:          # the library refused the example
                pass
        native.note_fallback()               # the numpy pipeline below
    if augment_example:
        rng = np.random.default_rng(seed)
        img, boxes, classes = augment.train_transform(img, boxes, classes,
                                                      rng)
    h, w = img.shape[:2]
    # Normalize boxes by the post-augmentation size (`Dataset.py:35-36`).
    if len(boxes):
        boxes = boxes / np.asarray([w, h, w, h], np.float32)
        boxes = np.clip(boxes, 0.0, 1.0)
    img = preprocess_image(img, image_size, normalize=not want_u8)
    if want_u8:
        img = quantize_uint8(img)
    return Example(img, boxes.reshape(-1, 4), classes.astype(np.int32),
                   rec.image_id)


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


def _worker_init(omp_threads: int) -> None:
    """Share the cores among the workers: each one's native library (its
    OpenMP loops) gets ``omp_threads`` threads.  With every worker running
    all cores' threads, the spinning OpenMP teams oversubscribe the host
    several times over."""
    native.set_num_threads(omp_threads)


def _prepare_counted(args) -> Tuple[Example, int, float]:
    """A worker's `prepare_example`, with the native fall-throughs it made
    (the parent adds them to its own count) and the seconds it took."""
    before = native.fallbacks
    t0 = time.perf_counter()
    example = prepare_example(*args)
    return example, native.fallbacks - before, time.perf_counter() - t0


class Loader:
    """Epoch iterator over ImageRecords yielding dense padded batches.

    ``drop_last`` defaults to True in training, so every step has the same
    batch shape.  The permutation of an epoch and the augmentation seed of
    each example come from ``(seed, epoch)``, drawn for the whole batch in
    order, so a batch does not depend on ``num_workers``.
    ``worker_seconds`` sums the seconds the examples took to prepare, in
    the workers or in this process.
    """

    def __init__(self, records: List[ImageRecord], config: DataConfig,
                 image_size: int = 300, train: bool = True,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 cache_path: Optional[str] = None):
        self.records = records
        self.config = config
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.cache_path = cache_path
        if cache_path is not None:
            cache_lib.build([r.image_path for r in records], cache_path,
                            num_workers=max(config.num_workers, 4))
        self.worker_seconds = 0.0
        self._pool = None
        if config.num_workers > 0:
            # spawn, not fork: the parent holds CUDA and runtime threads,
            # and forking such a process can deadlock.  The workers import
            # numpy, PIL and the native library only.
            self._pool = ProcessPoolExecutor(
                max_workers=config.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(max(1, (os.cpu_count() or 1)
                              // config.num_workers),))

    def __len__(self) -> int:
        n = len(self.records)
        b = self.config.batch_size
        return n // b if self.drop_last else -(-n // b)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = (rng.permutation(len(self.records)) if self.train
                 else np.arange(len(self.records)))
        b = self.config.batch_size
        augment_now = self.train and self.config.augment
        for bi in range(len(self)):
            idx = order[bi * b:(bi + 1) * b]
            args = [
                (self.records[i], self.image_size, augment_now,
                 self.config.keep_difficult,
                 int(rng.integers(0, 2**31)) if augment_now else None,
                 self.cache_path, int(i),
                 self.config.use_native_augment,
                 self.config.transfer_dtype)
                for i in idx
            ]
            if self._pool is not None:
                done = list(self._pool.map(_prepare_counted, args))
                native.note_fallback(sum(n for _, n, _ in done))
            else:
                done = [_prepare_counted(a) for a in args]
            self.worker_seconds += sum(t for _, _, t in done)
            examples = [ex for ex, _, _ in done]
            yield collate(examples, self.config.max_boxes,
                          image_size=self.image_size,
                          image_dtype=(np.uint8
                                       if self.config.transfer_dtype
                                       == "uint8" else np.float32))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch so host batching overlaps the card's
    steps.

    A loader exception is relayed to the consumer and re-raised there, not
    taken for the end of the epoch.  If the consumer abandons the generator
    early (an exception mid-epoch, ``break``), the producer is cancelled
    instead of blocking forever on a full queue.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    cancelled = threading.Event()

    def _put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed, not swallowed
            _put(e)
            return
        _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()
        # Drain so a producer blocked mid-put can observe cancellation.
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)

"""ctypes binding for the native (C++) data-path functions — the port of
`objectdetection_ssd_tpu/native.py`, over the same source,
`native/src/voc_native.cpp`.

Exposes, with the JAX package's Python signatures:
  * `parse_voc_xml(path)` — reference-parity VOC annotation parsing
    (`DataLists.py:8-30`) without ElementTree;
  * `resize_normalize(img, size)` — PIL-BILINEAR-compatible resample of the
    float image (no uint8 step) fused with ImageNet normalization;
  * `train_augment(...)` — the whole training augmentation + preprocess
    (`Util.py:566-607` semantics) in one call.

The library is built with g++ on first use, with the JAX package's flags,
into this package's own ``_build/`` (never into ``native/build/``), named by
the hash of the source and the flags, under an fcntl lock so that spawn
workers never load a half-written file.  If g++ or the build fails,
`available()` is False and the callers take the numpy / PIL path; each such
fall-through is counted in `fallbacks` (`note_fallback`), so that a run
that must stay on the native path can check that it did.

This module imports numpy only: the Loader's spawn workers import it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from objectdetection_ssd_torch.config import IMAGENET_MEAN, IMAGENET_STD

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "src",
                      "voc_native.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
# The JAX package's flags (`objectdetection_ssd_tpu/native.py:57`).  No
# -ffast-math: its startup code sets FTZ/DAZ for the whole process when the
# library loads.
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17")

# Fall-throughs to the numpy / PIL path in this process since the last
# reset (`note_fallback`).
fallbacks = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def note_fallback(count: int = 1) -> None:
    """Count ``count`` fall-throughs from the native path to numpy / PIL
    (the Loader adds its spawn workers' counts here)."""
    global fallbacks
    with _lock:
        fallbacks += count


def library_path() -> str:
    """Where the library for this source and flag set is (to be) built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libvoc_native_{digest.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    """Compile the library unless it exists: an fcntl lock serializes
    concurrent builders, and g++ writes a per-pid temporary file that is
    renamed into place."""
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    try:
        with open(lib_path + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if os.path.exists(lib_path):
                    return True              # another process built it
                res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                                     capture_output=True, timeout=120)
                if res.returncode != 0 or not os.path.exists(tmp):
                    return False
                os.replace(tmp, lib_path)
                return True
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                fcntl.flock(lockf, fcntl.LOCK_UN)
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE):
            return None
        lib_path = library_path()
        if not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.voc_parse_xml.restype = ctypes.c_int
        lib.voc_parse_xml.argtypes = [
            ctypes.c_char_p, ctypes.c_long, fp, ip,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.resize_normalize.restype = None
        lib.resize_normalize.argtypes = [fp, ctypes.c_int, ctypes.c_int, fp,
                                         ctypes.c_int, fp, fp]
        lib.train_augment.restype = ctypes.c_int
        lib.train_augment.argtypes = [
            fp, ctypes.c_long, ctypes.c_long, fp, ip, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.c_long, fp, fp, fp, fp, fp, ip]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def set_num_threads(n: int) -> None:
    """Give the library's OpenMP loops ``n`` threads in the calling thread
    (``omp_set_num_threads`` of the OpenMP runtime it is bound to: the
    process's ``libgomp.so.1``, which may be one that torch loaded first and
    initialized, so OMP_NUM_THREADS set now would come too late)."""
    if _load() is None:
        return
    try:
        ctypes.CDLL("libgomp.so.1").omp_set_num_threads(int(n))
    except (OSError, AttributeError):
        pass


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _mean_std(normalize: bool) -> Tuple[np.ndarray, np.ndarray]:
    if normalize:
        return (np.asarray(IMAGENET_MEAN, np.float32),
                np.asarray(IMAGENET_STD, np.float32))
    return np.zeros(3, np.float32), np.ones(3, np.float32)


def parse_voc_xml(xml_path: str, max_objects: int = 256
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native VOC XML parse -> (boxes_xyxy f32, class_ids i32, difficult
    bool), equal to `data.voc.parse_voc_xml`; raises RuntimeError if the
    library is unavailable, ValueError on malformed XML."""
    lib = _require()
    with open(xml_path, "rb") as f:
        data = f.read()
    boxes = np.zeros((max_objects, 4), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    difficult = np.zeros((max_objects,), np.uint8)
    n = lib.voc_parse_xml(
        data, len(data),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        difficult.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        max_objects)
    if n < 0:
        raise ValueError(f"malformed VOC XML: {xml_path}")
    return boxes[:n].copy(), classes[:n].copy(), difficult[:n].astype(bool)


def train_augment(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                  seed: int, out_size: int, normalize: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native training augmentation + resize (+ normalize) of one example:
    photometric distortions, expand / min-IoU crop window, flip, triangle
    resample, box filtering.  The random stream is C++ mt19937_64 seeded
    with ``seed``.

    Returns (image (S, S, 3) f32 — ImageNet-normalized, or raw [0, 1] with
    ``normalize=False`` — boxes (n', 4) xyxy in [0, 1], labels (n',)
    int32).  The expand/crop filler is the ImageNet mean colour either way.
    """
    lib = _require()
    img = np.ascontiguousarray(img, np.float32)
    boxes = np.ascontiguousarray(boxes.reshape(-1, 4), np.float32)
    labels_in = np.ascontiguousarray(labels, np.int32)
    n = len(labels_in)
    h, w = img.shape[:2]
    out_img = np.empty((out_size, out_size, 3), np.float32)
    out_boxes = np.zeros((max(n, 1), 4), np.float32)
    out_labels = np.zeros((max(n, 1),), np.int32)
    fill = np.asarray(IMAGENET_MEAN, np.float32)
    mean, std = _mean_std(normalize)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n_out = lib.train_augment(
        img.ctypes.data_as(fp), h, w,
        boxes.ctypes.data_as(fp), labels_in.ctypes.data_as(ip), n,
        ctypes.c_ulonglong(seed & (2**64 - 1)), out_size,
        fill.ctypes.data_as(fp),
        mean.ctypes.data_as(fp), std.ctypes.data_as(fp),
        out_img.ctypes.data_as(fp), out_boxes.ctypes.data_as(fp),
        out_labels.ctypes.data_as(ip))
    if n_out < 0:
        raise ValueError("native train_augment failed")
    return out_img, out_boxes[:n_out].copy(), out_labels[:n_out].copy()


def resize_normalize(img: np.ndarray, size: int,
                     normalize: bool = True) -> np.ndarray:
    """(h, w, 3) float32 [0,1] -> (size, size, 3) float32 (ImageNet-
    normalized, or the raw [0,1] resample with ``normalize=False``)."""
    lib = _require()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    mean, std = _mean_std(normalize)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.resize_normalize(img.ctypes.data_as(fp), h, w,
                         out.ctypes.data_as(fp), size,
                         mean.ctypes.data_as(fp), std.ctypes.data_as(fp))
    return out

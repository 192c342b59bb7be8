"""Packed decoded-image cache — the port of
`objectdetection_ssd_tpu/data/cache.py`, in the same file layout, so either
package reads the other's cache:

  <path>.bin      concatenated C-order uint8 HWC pixel blobs
  <path>.idx.npz  offsets (n+1,), heights (n,), widths (n,), and
                  paths_sha256, the hash of the ordered image path list

Every image is decoded once; later epochs read raw pixels from a memory-map
of the .bin.  `write` lays out pixels that the caller already has (a
fixture rendered in memory); `build` decodes the image files into it.

numpy only (PIL is imported by `pipeline.load_image` when `build` decodes):
the Loader's spawn workers import this module.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np

_handles: Dict[str, Tuple[np.memmap, np.ndarray, np.ndarray, np.ndarray]] = {}
_lock = threading.Lock()


def paths_digest(image_paths: List[str]) -> str:
    return hashlib.sha256("\n".join(image_paths).encode()).hexdigest()


def is_current(image_paths: List[str], cache_path: str) -> bool:
    """True if the cache at ``cache_path`` holds exactly ``image_paths``, in
    order (the index's path hash and count)."""
    idx_path, bin_path = cache_path + ".idx.npz", cache_path + ".bin"
    if not (os.path.exists(idx_path) and os.path.exists(bin_path)):
        return False
    idx = np.load(idx_path)
    return ("paths_sha256" in idx
            and str(idx["paths_sha256"]) == paths_digest(image_paths)
            and len(idx["heights"]) == len(image_paths))


def build(image_paths: List[str], cache_path: str,
          num_workers: int = 0) -> str:
    """Decode all images into the packed cache (idempotent, streaming).

    Idempotence is keyed on the hash of the full ordered path list, so a
    changed split, order or root rebuilds.  Decoding streams: at most
    ~2x ``num_workers`` decoded images are in flight.  The rebuild runs
    under an fcntl lock, so two processes never pair one build's .bin with
    the other's index.
    """
    if is_current(image_paths, cache_path):
        return cache_path
    from objectdetection_ssd_torch.data.pipeline import load_image

    def decode(p):
        return (load_image(p) * 255.0 + 0.5).astype(np.uint8)

    def images():
        if not num_workers:
            yield from map(decode, image_paths)
            return
        # Windowed submission: bounded in-flight decodes, written in order.
        from concurrent.futures import ThreadPoolExecutor
        window = max(2 * num_workers, 4)
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            pending: deque = deque()
            it = iter(image_paths)
            for p in it:
                pending.append(pool.submit(decode, p))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    return write(image_paths, cache_path, images)


def write(image_paths: List[str], cache_path: str,
          images: Callable[[], Iterable[np.ndarray]]) -> str:
    """Write the pixels that ``images()`` yields — (h, w, 3) uint8, one per
    path, in order — as the cache of ``image_paths``, unless it is current.

    Under an fcntl lock: the .bin and then the index are written to
    temporary names and renamed, index last.
    """
    import fcntl
    with open(cache_path + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if is_current(image_paths, cache_path):   # built meanwhile
            return cache_path
        bin_path, idx_path = cache_path + ".bin", cache_path + ".idx.npz"
        heights: List[int] = []
        widths: List[int] = []
        tmp_bin = bin_path + f".tmp.{os.getpid()}"
        try:
            with open(tmp_bin, "wb") as sink:
                for im in images():
                    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
                        raise ValueError(f"cache images must be (h, w, 3) "
                                         f"uint8, got {im.dtype} {im.shape}")
                    heights.append(im.shape[0])
                    widths.append(im.shape[1])
                    sink.write(np.ascontiguousarray(im).tobytes())
            if len(heights) != len(image_paths):
                raise ValueError(f"{len(heights)} images for "
                                 f"{len(image_paths)} paths")
            os.replace(tmp_bin, bin_path)
        finally:
            if os.path.exists(tmp_bin):
                os.unlink(tmp_bin)
        h = np.asarray(heights, np.int64)
        w = np.asarray(widths, np.int64)
        offsets = np.concatenate([[0], np.cumsum(h * w * 3)])
        tmp_idx = idx_path + f".tmp.{os.getpid()}.npz"
        np.savez(tmp_idx, offsets=offsets, heights=h, widths=w,
                 paths_sha256=paths_digest(image_paths))
        os.replace(tmp_idx, idx_path)
        with _lock:
            _handles.pop(cache_path, None)       # drop any stale mmap
    return cache_path


def _open(cache_path: str):
    with _lock:
        h = _handles.get(cache_path)
        if h is None:
            idx = np.load(cache_path + ".idx.npz")
            data = np.memmap(cache_path + ".bin", dtype=np.uint8, mode="r")
            h = (data, idx["offsets"], idx["heights"], idx["widths"])
            _handles[cache_path] = h
        return h


def num_images(cache_path: str) -> int:
    return len(_open(cache_path)[2])


def get_image(cache_path: str, index: int) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1] — decoded pixels, no image-file work."""
    data, offsets, heights, widths = _open(cache_path)
    h, w = int(heights[index]), int(widths[index])
    blob = data[int(offsets[index]):int(offsets[index + 1])]
    return blob.reshape(h, w, 3).astype(np.float32) / 255.0

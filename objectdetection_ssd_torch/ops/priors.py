"""Prior (anchor) boxes — a numpy copy of
`objectdetection_ssd_tpu/ops/priors.py`.

* `ssd300_priors` reproduces the reference generator `create_priors_ssd300`
  (`Util.py:105-137`) including row order: 6 feature-map grids
  [38, 19, 10, 5, 3, 1], cells row-major (i outer, j inner) with
  cx = (j+.5)/g, cy = (i+.5)/g, per-cell boxes
  [ratio-1, extra, ratio-2, (ratio-3), ratio-1/2, (ratio-.333)]; 8732
  priors, clamped to [0, 1], cxcywh.
* `zoom_ratio_priors` is the reference's 189-prior generator
  `create_ancs_xywh_zoom_ratio` (`Util.py:144-164`): grids [4, 2, 1], x the
  slow axis, (y, x, w, h) columns in reference order.
* `resnet34_priors` pairs with `models.ssd.SSDResNet34`: the same 189
  boxes, cells row-major as the heads flatten them, (cx, cy, w, h), clipped
  to [0, 1].  The two generators order cells differently.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

from objectdetection_ssd_torch.config import ModelConfig, PriorConfig


def _cell_wh(scale: float, next_scale: float,
             ratios: Sequence[float]) -> np.ndarray:
    """Per-cell (k, 2) box sizes in the reference's emission order."""
    whs = []
    for a in ratios:
        whs.append((scale * math.sqrt(a), scale / math.sqrt(a)))
        if a == 1.0:
            extra = math.sqrt(scale * next_scale) if next_scale > 0 else 1.0
            whs.append((extra, extra))
    return np.asarray(whs, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _ssd300_priors_cached(cfg_key: Tuple) -> np.ndarray:
    sizes, scales, ratios = cfg_key
    per_map = []
    for idx, (g, s) in enumerate(zip(sizes, scales)):
        next_scale = scales[idx + 1] if idx + 1 < len(scales) else -1.0
        wh = _cell_wh(s, next_scale, ratios[idx])          # (k, 2)
        k = wh.shape[0]
        centers = (np.arange(g, dtype=np.float32) + 0.5) / g
        cy, cx = np.meshgrid(centers, centers, indexing="ij")  # (g, g)
        cxy = np.stack([cx, cy], axis=-1)                   # (g, g, 2)
        cell = np.concatenate(
            [np.broadcast_to(cxy[:, :, None, :], (g, g, k, 2)),
             np.broadcast_to(wh[None, None, :, :], (g, g, k, 2))],
            axis=-1)                                        # (g, g, k, 4)
        per_map.append(cell.reshape(-1, 4))
    priors = np.concatenate(per_map, axis=0)
    return np.clip(priors, 0.0, 1.0)


def ssd300_priors(config: PriorConfig | None = None) -> np.ndarray:
    """(P, 4) cxcywh priors in [0, 1]; P = 8732 for the default config."""
    cfg = config or PriorConfig()
    key = (tuple(cfg.feature_map_sizes), tuple(cfg.scales),
           tuple(tuple(r) for r in cfg.aspect_ratios))
    return _ssd300_priors_cached(key)


# The ResNet-34 variant's anchors: 9 zoom x ratio (w, h) scales per cell
# on grids 4, 2, 1 (`Util.py:144-164`).
_ZOOM_GRIDS = (4, 2, 1)
_ZOOMS = (0.75, 1.0, 1.3)
_RATIO_PAIRS = ((1.0, 1.0), (1.0, 0.5), (0.5, 1.0))


def _zoom_ratio_scales() -> np.ndarray:
    return np.asarray([(z * i, z * j) for z in _ZOOMS
                       for (i, j) in _RATIO_PAIRS], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def zoom_ratio_priors(reference_order: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(priors (189, 4), grid_sizes (189,)) of the reference generator.

    x is the slow axis (`Util.py:157-158`).  ``reference_order=True`` gives
    the reference's swapped (y, x, w, h) columns (`Util.py:164`);
    ``False`` gives (cx, cy, w, h).  ``grid_sizes`` is the per-anchor cell
    size 1/g (`Util.py:18,161`).
    """
    scales = _zoom_ratio_scales()                           # (9, 2)
    k = scales.shape[0]
    ctrs, sizes, grid_sizes = [], [], []
    for g in _ZOOM_GRIDS:
        offset = 1.0 / (2 * g)
        lin = np.linspace(offset, 1 - offset, g, dtype=np.float32)
        anc_x = np.repeat(lin, g)
        anc_y = np.tile(lin, g)
        ctrs.append(np.repeat(np.stack([anc_x, anc_y], axis=1), k, axis=0))
        sizes.append(np.tile(scales / g, (g * g, 1)))
        grid_sizes.append(np.full((g * g * k,), 1.0 / g, dtype=np.float32))
    ancs = np.concatenate(
        [np.concatenate(ctrs, 0), np.concatenate(sizes, 0)], axis=1)
    if reference_order:
        ancs = np.stack(
            [ancs[:, 1], ancs[:, 0], ancs[:, 2], ancs[:, 3]], axis=1)
    return ancs, np.concatenate(grid_sizes, 0)


@functools.lru_cache(maxsize=None)
def resnet34_priors() -> np.ndarray:
    """(189, 4) cxcywh priors aligned with `SSDResNet34`'s heads: taps
    4x4, 2x2, 1x1 in model order, cells row-major to match `flatten_head`'s
    (row, col, anchor) rows, 9 anchors per cell, clipped to [0, 1].  The
    clip makes two anchors of the 1x1 cell equal, (0.5, 0.5, 1, 1)."""
    scales = _zoom_ratio_scales()                           # (9, 2) (w, h)
    k = scales.shape[0]
    per_map = []
    for g in _ZOOM_GRIDS:
        centers = (np.arange(g, dtype=np.float32) + 0.5) / g
        cy, cx = np.meshgrid(centers, centers, indexing="ij")  # row-major
        cxy = np.stack([cx, cy], axis=-1)                   # (g, g, 2)
        wh = scales / g                                     # (k, 2)
        cell = np.concatenate(
            [np.broadcast_to(cxy[:, :, None, :], (g, g, k, 2)),
             np.broadcast_to(wh[None, None, :, :], (g, g, k, 2))],
            axis=-1)
        per_map.append(cell.reshape(-1, 4))
    return np.clip(np.concatenate(per_map, axis=0), 0.0, 1.0)


def priors_for_model(model_config: ModelConfig,
                     prior_config: PriorConfig | None = None) -> np.ndarray:
    """Priors matching ``model_config.backbone``'s head layout: 8732
    SSD300 priors for vgg16, the 189 `resnet34_priors` for resnet34."""
    if model_config.backbone == "vgg16":
        return ssd300_priors(prior_config)
    if model_config.backbone == "resnet34":
        return resnet34_priors()
    raise ValueError(f"unknown backbone: {model_config.backbone!r}")

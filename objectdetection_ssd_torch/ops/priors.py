"""Prior (anchor) boxes for SSD300 — a numpy copy of
`objectdetection_ssd_tpu/ops/priors.py:ssd300_priors`.

Reproduces the reference generator `create_priors_ssd300`
(`Util.py:105-137`) including row order: 6 feature-map grids
[38, 19, 10, 5, 3, 1], cells row-major (i outer, j inner) with
cx = (j+.5)/g, cy = (i+.5)/g, per-cell boxes
[ratio-1, extra, ratio-2, (ratio-3), ratio-1/2, (ratio-.333)]; 8732 priors,
clamped to [0, 1], cxcywh.
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


def priors_for_model(model_config: ModelConfig,
                     prior_config: PriorConfig | None = None) -> np.ndarray:
    """Priors matching ``model_config.backbone``'s head layout."""
    if model_config.backbone == "vgg16":
        return ssd300_priors(prior_config)
    if model_config.backbone == "resnet34":
        raise NotImplementedError(
            "the ResNet-34 family is not ported to PyTorch yet")
    raise ValueError(f"unknown backbone: {model_config.backbone!r}")

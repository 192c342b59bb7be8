"""User-facing detection API: images -> final boxes, on the card.

The port of `objectdetection_ssd_tpu/infer/detector.py:Detector` without
its mesh, int8 and TTA options.  The model forward and `postprocess` run on
one device (``cuda`` unless the caller passes ``device="cpu"``); only the
fixed-size detection tensors come back to the host, once per batch.
Building from an orbax checkpoint (``from_checkpoint``) is not ported:
weights come in as a ``state_dict``, e.g. from
`models.convert.from_flax_params`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from objectdetection_ssd_torch.config import (Config, ID_TO_CLASS,
                                              PostprocessConfig)
from objectdetection_ssd_torch.data import pipeline as data_pipeline
from objectdetection_ssd_torch.device import DeviceLike, resolve_device
from objectdetection_ssd_torch.infer.postprocess import (Detections,
                                                         postprocess,
                                                         scale_detections)
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops import priors as priors_lib


class Detector:
    """SSD300 forward + postprocess on one device."""

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 postprocess_config: Optional[PostprocessConfig] = None,
                 device: DeviceLike = None, priors: Optional[np.ndarray] = None):
        self.device = resolve_device(device)
        self.config = config
        self.pp_config = postprocess_config or config.postprocess
        if self.pp_config.tta_flip:
            raise NotImplementedError("flip TTA is not ported to PyTorch yet")
        self.model = build_model(config.model, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        if priors is None:
            priors = priors_lib.priors_for_model(config.model, config.priors)
        self.priors = torch.tensor(np.asarray(priors), dtype=torch.float32,
                                   device=self.device)

    @torch.inference_mode()
    def forward(self, images) -> tuple:
        """(B, S, S, 3) uint8 or normalized float NHWC -> (loc, conf)."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        return self.model(images)

    @torch.inference_mode()
    def detect_batch(self, images) -> Detections:
        """(B, S, S, 3) uint8 or normalized float NHWC -> Detections
        (normalized boxes), on this detector's device."""
        loc, conf = self.forward(images)
        return postprocess(loc, conf, self.priors, self.pp_config)

    def detect_images(self, paths: Sequence[str],
                      batch_size: int = 8) -> List[Dict[str, np.ndarray]]:
        """Decode, resize, run, and rescale to original pixel coords
        (reference `Losses.py:87-89`).

        Runs in chunks of exactly ``batch_size`` (the tail padded by
        repeating its last image, then sliced off), so every call sees one
        batch shape.  Images travel as uint8."""
        size = self.config.model.image_size
        out: List[Dict[str, np.ndarray]] = []
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            imgs, sizes = [], []
            for p in chunk:
                raw = data_pipeline.load_image(p)
                sizes.append((raw.shape[1], raw.shape[0]))     # (w, h)
                imgs.append(data_pipeline.quantize_uint8(
                    data_pipeline.resize_image(raw, size)))
            n_real = len(imgs)
            while len(imgs) < batch_size:
                imgs.append(imgs[-1])
                sizes.append(sizes[-1])
            dets = self.detect_batch(np.stack(imgs))
            dets = scale_detections(dets, torch.tensor(sizes,
                                                       dtype=torch.float32))
            # One host pull per batch, not per row.
            dets = Detections(*(t.cpu().numpy() for t in dets))
            for i in range(n_real):
                valid = dets.valid[i]
                classes = dets.classes[i][valid]
                out.append({
                    "boxes_xyxy": dets.boxes_xyxy[i][valid],
                    "classes": classes,
                    "labels": np.asarray(
                        [ID_TO_CLASS[int(c)] for c in classes]),
                    "scores": dets.scores[i][valid],
                })
        return out

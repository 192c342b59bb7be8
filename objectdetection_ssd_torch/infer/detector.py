"""User-facing detection API: images -> final boxes, on the card.

The port of `objectdetection_ssd_tpu/infer/detector.py:Detector` without
its mesh, int8 and TTA options.  The model forward and `postprocess` run on
one device (``cuda`` unless the caller passes ``device="cpu"``); only the
fixed-size detection tensors come back to the host, once per batch.
Weights come in as a ``state_dict`` (e.g. `models.convert.from_flax_params`)
or from a `train.checkpoint.CheckpointManager` directory
(`Detector.from_checkpoint`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


def checkpoint_weights(config: Config, checkpoint_dir: Optional[str] = None,
                       allow_random_init: bool = False, use_ema: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """(state_dict on the CPU, epoch) of the latest checkpoint under
    ``checkpoint_dir`` (default `TrainConfig.checkpoint_dir`): the EMA
    weights with ``use_ema``.  Without a checkpoint, FileNotFoundError —
    unless ``allow_random_init``, which gives the registry model's weights
    drawn from `TrainConfig.seed` and epoch None."""
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
    ckpt_dir = checkpoint_dir or config.train.checkpoint_dir
    try:
        payload, _, epoch = CheckpointManager(ckpt_dir).load()
    except FileNotFoundError:
        if not allow_random_init:
            raise FileNotFoundError(
                f"no checkpoint found under {ckpt_dir!r}; pass "
                "allow_random_init=True for an untrained detector")
        model = build_model(
            config.model, device="cpu", train=True,
            generator=torch.Generator().manual_seed(config.train.seed))
        return model.state_dict(), None
    weights = payload["model"]
    if use_ema:
        if payload["ema"] is None:
            raise ValueError("use_ema needs a checkpoint trained with EMA "
                             "(TrainConfig.ema_decay > 0)")
        weights = {**weights, **payload["ema"]}
    return weights, epoch


class Detector:
    """SSD300 forward + postprocess on one device."""

    @classmethod
    def from_checkpoint(cls, config: Config,
                        checkpoint_dir: Optional[str] = None,
                        allow_random_init: bool = False,
                        use_ema: bool = False, **kw) -> "Detector":
        """A Detector with the weights of the latest checkpoint
        (`checkpoint_weights`): FileNotFoundError when there is none, so a
        typo'd directory never serves random weights, unless
        ``allow_random_init``."""
        weights, _ = checkpoint_weights(config, checkpoint_dir,
                                        allow_random_init, use_ema)
        return cls(config, weights, **kw)

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
        """Decode, preprocess, run, and rescale to original pixel coords
        (reference `Losses.py:87-89`).

        Runs in chunks of exactly ``batch_size`` (the tail padded by
        repeating its last image, then sliced off), so every call sees one
        batch shape.  Images are resized by `data.pipeline.preprocess_image`
        (the native resample when built) and travel as uint8 or normalized
        float32, as `DataConfig.transfer_dtype` says."""
        size = self.config.model.image_size
        u8 = self.config.data.transfer_dtype == "uint8"
        out: List[Dict[str, np.ndarray]] = []
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            imgs, sizes = [], []
            for p in chunk:
                raw = data_pipeline.load_image(p)
                sizes.append((raw.shape[1], raw.shape[0]))     # (w, h)
                img = data_pipeline.preprocess_image(raw, size,
                                                     normalize=not u8)
                imgs.append(data_pipeline.quantize_uint8(img) if u8 else img)
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

"""User-facing detection API: images -> final boxes, on the card.

The port of `objectdetection_ssd_tpu/infer/detector.py` (`Detector`,
`mirror_permutation`, `forward_for_postprocess`).  The model forward and
`postprocess` run on one device (``cuda`` unless the caller passes
``device="cpu"``); only the fixed-size detection tensors come back to the
host, once per batch.  Data-parallel serving is one Detector per process
(one per card): each detects its rows of the global batch
(`parallel.mesh.data_shard`), and `eval/evaluate.py` gathers the rows to
every rank.  With ``mesh=`` holding a ``model`` or ``spatial`` axis (JAX
`detector.py:200-221`) the forward is partitioned over that axis: each
rank holds its output channels of every conv (tensor parallelism,
`parallel/tensor_parallel.py`) or computes its rows of every map
(`parallel/spatial.py`), and every rank of the group gets its data
shard's whole outputs, on which it runs `postprocess` (K1 once per
batch).  With ``quant=`` (a scale tree of `infer/quant.py`) the quantized
convs run int8 on kernel K3, on the channel or row shards under a mesh.
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
from objectdetection_ssd_torch.models.ssd import build_model, normalize_uint8
from objectdetection_ssd_torch.ops import boxes as box_ops
from objectdetection_ssd_torch.ops import priors as priors_lib
from objectdetection_ssd_torch.parallel.data_parallel import (
    partition_model, shard_like)


def mirror_permutation(priors_np: np.ndarray) -> Optional[np.ndarray]:
    """``perm[i]`` = index of the prior at the horizontally mirrored
    position ``(1-cx, cy, w, h)``, or None when some prior has no exact
    mirror partner.  Matched in integers (1e-5 quantization), so float
    noise gives the union fallback instead of a wrong pair.  Where priors
    repeat (`resnet34_priors` holds (0.5, 0.5, 1, 1) twice), the partner is
    the last of them, as in the JAX function."""
    k = np.rint(np.asarray(priors_np, np.float64) * 1e5).astype(np.int64)
    index = {tuple(row): i for i, row in enumerate(k)}
    perm = np.empty(len(k), np.int32)
    for i, (cx, cy, w, h) in enumerate(k):
        j = index.get((100000 - cx, cy, w, h))
        if j is None:
            return None
        perm[i] = j
    return perm


def forward_for_postprocess(model: torch.nn.Module, images: torch.Tensor,
                            priors: torch.Tensor,
                            pp_config: PostprocessConfig,
                            perm: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Model forward -> (loc, conf, priors) ready for `postprocess`.

    With ``pp_config.tta_flip`` the horizontally mirrored images
    (``images.flip(2)`` on NHWC) run too, and their decoded boxes are
    mirrored back (cx -> 1 - cx).  With ``perm`` (`mirror_permutation` of
    ``priors``, on their device) the views are averaged: each anchor's
    mirrored prediction is realigned to its partner anchor and the boxes
    and f32 logits are averaged.  Without it (an asymmetric grid) both
    views' candidates are concatenated along the anchor axis for one NMS
    pass.
    """
    loc, conf = model(images)
    if not pp_config.tta_flip:
        return loc, conf, priors
    loc_f, conf_f = model(images.flip(2))
    b = box_ops.decode(loc_f, priors)
    b = torch.cat([1.0 - b[..., :1], b[..., 1:]], dim=-1)
    if perm is not None:
        b = b[:, perm]                          # realign to direct anchors
        conf_f = conf_f[:, perm]
        b_avg = (box_ops.decode(loc, priors) + b) * 0.5
        loc = box_ops.encode(b_avg, priors)
        conf = ((conf.float() + conf_f.float()) * 0.5).to(conf.dtype)
        return loc, conf, priors
    loc = torch.cat([loc, box_ops.encode(b, priors)], dim=1)
    conf = torch.cat([conf, conf_f], dim=1)
    return loc, conf, torch.cat([priors, priors], dim=0)


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
    """SSD forward (the registry model of ``config.model``, or the
    caller's) + postprocess on one device, partitioned over a mesh's
    ``model`` or ``spatial`` axis when given one."""

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
                 mesh=None, quant: Optional[Mapping] = None,
                 model: Optional[torch.nn.Module] = None,
                 priors: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        """``mesh``: a `parallel.mesh.create_mesh` mesh over the joined
        process group (``device`` is then this rank's card).  With a
        ``model`` axis the weights are sharded over it after loading (each
        rank keeps its channels); with a ``spatial`` axis each rank
        computes its rows.  Every rank of the group calls `detect_batch`
        with the same images (its data shard's rows).

        ``quant``: an int8 scale tree (`infer.quant.act_scales`, chained
        or not): the convs it names run int8 on K3, the others float.  The
        model then holds its weights in f32, as the JAX package quantizes
        them from its f32 parameters, and casts the float convs' weights to
        the compute dtype at use.

        ``model`` / ``priors``: serve this module and prior set in place
        of the registry's (tests, custom architectures), as the Trainer
        takes them.  The module maps ImageNet-normalized NHWC float images
        to ``(loc, conf)``; uint8 batches are normalized before it (the
        registry models normalize them themselves).  It is moved to
        ``device``, put in eval mode and given ``state_dict``; ``quant``
        and flip TTA apply to it unchanged."""
        from objectdetection_ssd_torch.infer.quant import attach_scales
        self.device = resolve_device(device)
        self.config = config
        self.pp_config = postprocess_config or config.postprocess
        self.quant = quant
        self.mesh = mesh
        self.custom_model = model is not None
        if model is None:
            model = build_model(config.model, device=self.device,
                                train=quant is not None)
        self.model = model.to(self.device).eval()
        self.model.load_state_dict(state_dict, strict=True)
        if mesh is not None:
            partition_model(self.model, mesh)
        if quant is not None:
            attach_scales(self.model, quant)
        if priors is None:
            priors = priors_lib.priors_for_model(config.model, config.priors)
        self.priors = torch.tensor(np.asarray(priors), dtype=torch.float32,
                                   device=self.device)
        # Flip TTA's anchor pairing, found once (None: the union merge).
        self.mirror_perm = None
        if self.pp_config.tta_flip:
            perm = mirror_permutation(np.asarray(priors))
            if perm is not None:
                self.mirror_perm = torch.from_numpy(perm).long().to(
                    self.device)

    def load_weights(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load a whole (single-device) state_dict into the model, each
        tensor laid out as the model holds it (this rank's channels under
        tensor parallelism)."""
        live = self.model.state_dict()
        self.model.load_state_dict(
            {k: shard_like(v, live[k]) if k in live else v
             for k, v in state_dict.items()}, strict=True)

    def _images(self, images) -> torch.Tensor:
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        return normalize_uint8(images) if self.custom_model else images

    @torch.inference_mode()
    def forward(self, images) -> tuple:
        """(B, S, S, 3) uint8 or normalized float NHWC -> (loc, conf)."""
        return self.model(self._images(images))

    @torch.inference_mode()
    def detect_batch(self, images) -> Detections:
        """(B, S, S, 3) uint8 or normalized float NHWC -> Detections
        (normalized boxes), on this detector's device; with flip TTA when
        the postprocess config asks for it."""
        loc, conf, priors = forward_for_postprocess(
            self.model, self._images(images), self.priors, self.pp_config,
            self.mirror_perm)
        return postprocess(loc, conf, priors, self.pp_config)

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

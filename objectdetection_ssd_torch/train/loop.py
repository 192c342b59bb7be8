"""Train and eval steps — the port of `objectdetection_ssd_tpu/train/loop.py`
(`train_step`, `eval_step`) for one device.

One step: forward, the multibox loss in f32, backward (the routed convs'
filter gradients on kernel K2), SGD update and schedule step.  The batch
is the `data/pipeline.py:collate` contract: ``images`` uint8 (B, S, S, 3)
or normalized float, ``boxes`` (B, M, 4) f32 xyxy, ``classes`` (B, M)
int32, ``mask`` (B, M) bool, as numpy arrays or tensors; they are moved to
the model's device.  Gradient accumulation and the EMA live in
`train/state.py:TrainState`.  Remat and QAT's ``quant_ste`` are not ported
yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from objectdetection_ssd_torch.config import LossConfig
from objectdetection_ssd_torch.losses.multibox import (MultiboxLoss,
                                                       multibox_loss)
from objectdetection_ssd_torch.models.ssd import normalize_uint8
from objectdetection_ssd_torch.train.state import TrainState


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _forward(state: TrainState, images: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 image batches are normalized here in f32, so any model sees
    ImageNet-normalized floats (`loop.py:40-42`); float batches pass
    through."""
    return state.model(normalize_uint8(images))


def _loss(state: TrainState, batch: Mapping[str, object],
          priors: torch.Tensor, loss_config: LossConfig) -> MultiboxLoss:
    dev = _device_of(state)
    b = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
         for k in ("images", "boxes", "classes", "mask")}
    loc, conf = _forward(state, b["images"])
    # Loss math in f32 whatever the model's compute dtype.
    return multibox_loss(loc.float(), conf.float(), b["boxes"],
                         b["classes"], b["mask"],
                         torch.as_tensor(priors).to(dev), loss_config)


def _metrics(loss: MultiboxLoss) -> Dict[str, torch.Tensor]:
    return {"loss": loss.total.detach(), "cls_loss": loss.cls.detach(),
            "loc_loss": loss.loc.detach(),
            "num_pos": loss.num_pos.to(torch.float32)}


def train_step(state: TrainState, batch: Mapping[str, object],
               priors: torch.Tensor,
               loss_config: LossConfig = LossConfig(),
               ema_decay: float = 0.0
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One SGD step (or micro-step under gradient accumulation); returns
    ``(state, metrics)``, the state updated in place.  The EMA of the
    weights (``ema_decay`` > 0 and ``state.ema`` set) moves only when the
    parameters do.  Metrics are device scalars: ``loss``, ``cls_loss``,
    ``loc_loss`` and ``num_pos`` (f32).  The gradients stay in each
    parameter's ``.grad`` until the next step."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss = _loss(state, batch, priors, loss_config)
    loss.total.backward()
    if state.apply_gradients() and ema_decay:
        state.update_ema(ema_decay)
    return state, _metrics(loss)


@torch.no_grad()
def eval_step(state: TrainState, batch: Mapping[str, object],
              priors: torch.Tensor,
              loss_config: LossConfig = LossConfig()
              ) -> Dict[str, torch.Tensor]:
    """Loss-only eval step (the reference's 'test' phase,
    `train_function.py:47-52`); the state is not changed."""
    state.model.eval()
    return _metrics(_loss(state, batch, priors, loss_config))

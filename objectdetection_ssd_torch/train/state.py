"""Train state and optimizer: SGD with momentum, weight decay, 2x bias lr,
step decay and warmup — the port of `objectdetection_ssd_tpu/train/state.py`.

Reference semantics (`train.py:44-57`), which the JAX package expresses as
an optax chain (wd -> momentum -> bias scaling -> schedule):
  * parameters split into bias / non-bias by name; biases get 2x lr;
  * SGD(lr=1e-4, momentum=0.9, weight_decay=5e-4); torch applies the weight
    decay to the gradient BEFORE the momentum buffer, as the chain does;
  * StepLR(step_size=7 epochs, gamma=0.1) on the update clock, and a
    linear warmup ``(count + 1) / warmup_steps``: one `LambdaLR`, stepped
    once per update;
  * frozen parameters (`models/backbones.py:vgg_frozen_prefixes`) are set
    ``requires_grad=False`` and left out of the optimizer, so they get
    neither an update nor weight decay (the chain's `_zero_frozen`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
from objectdetection_ssd_torch.device import DeviceLike
from objectdetection_ssd_torch.models.backbones import vgg_frozen_prefixes
from objectdetection_ssd_torch.models.ssd import build_model


@dataclasses.dataclass
class TrainState:
    """What a train step reads and advances.  PyTorch updates in place: the
    step returns this same object with its model, optimizer and scheduler
    moved on and ``step`` (the count of updates) raised by one."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def is_bias_path(name: str) -> bool:
    """True for a bias parameter: the reference's
    ``param_name.endswith('.bias')`` (`train.py:46-51`).  Kernels and the
    conv4_3 L2Norm scale are not biases."""
    return name.rsplit(".", 1)[-1] == "bias"


def step_decay_schedule(base_lr: float, gamma: float, steps_per_epoch: int,
                        decay_epochs: int) -> Callable[[int], float]:
    """StepLR(step_size=decay_epochs, gamma) on an epoch clock."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // decay_epochs)

    return schedule


def _is_frozen(name: str, frozen_prefixes: Iterable[str]) -> bool:
    return any(name == pre or name.startswith(pre + ".")
               for pre in frozen_prefixes)


def make_optimizer(named_params: Iterable[Tuple[str, nn.Parameter]],
                   config: OptimConfig, steps_per_epoch: int = 1,
                   frozen_prefixes: Tuple[str, ...] = ()
                   ) -> Tuple[torch.optim.SGD,
                              torch.optim.lr_scheduler.LambdaLR]:
    """SGD over ``named_params`` (e.g. ``model.named_parameters()``) and its
    schedule.  Parameters under ``frozen_prefixes`` (dotted names) are set
    ``requires_grad=False`` and get no param group."""
    if config.use_lr_schedule:
        decay = step_decay_schedule(1.0, config.lr_decay_gamma,
                                    steps_per_epoch, config.lr_decay_epochs)
    else:
        decay = lambda count: 1.0  # noqa: E731 — reference parity
    warm = config.warmup_steps

    def factor(count: int) -> float:
        ramp = min((count + 1) / warm, 1.0) if warm > 0 else 1.0
        return decay(count) * ramp

    weights, biases = [], []
    for name, param in named_params:
        if _is_frozen(name, frozen_prefixes):
            param.requires_grad_(False)
        elif param.requires_grad:
            (biases if is_bias_path(name) else weights).append(param)
    groups = [{"params": weights, "lr": config.lr},
              {"params": biases,
               "lr": config.lr * config.bias_lr_multiplier}]
    optimizer = torch.optim.SGD([g for g in groups if g["params"]],
                                lr=config.lr, momentum=config.momentum,
                                weight_decay=config.weight_decay)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def create_train_state(model_config: ModelConfig, optim_config: OptimConfig,
                       device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       steps_per_epoch: int = 1) -> TrainState:
    """Build the train model (`build_model(train=True)`: f32 parameters on
    ``device``, default ``cuda``), its weights drawn from ``generator`` or
    loaded from ``state_dict`` (strictly), and its optimizer, with the VGG
    stages of ``model_config.freeze_stages`` frozen.
    """
    model = build_model(model_config, device=device, generator=generator,
                        train=True)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(), optim_config, steps_per_epoch,
        vgg_frozen_prefixes(model_config.freeze_stages))
    return TrainState(model, optimizer, scheduler)

"""Train state and optimizer: SGD with momentum, weight decay, 2x bias lr,
step decay and warmup, gradient accumulation and an EMA of the weights —
the port of `objectdetection_ssd_tpu/train/state.py`.

Reference semantics (`train.py:44-57`), which the JAX package expresses as
an optax chain (wd -> momentum -> bias scaling -> schedule):
  * parameters split into bias / non-bias by name; biases get 2x lr;
  * SGD(lr=1e-4, momentum=0.9, weight_decay=5e-4); torch applies the weight
    decay to the gradient BEFORE the momentum buffer, as the chain does;
  * StepLR(step_size=7 epochs, gamma=0.1) on the update clock, and a
    linear warmup ``(count + 1) / warmup_steps``: one `LambdaLR`, stepped
    once per update;
  * frozen parameters (`frozen_prefixes`: the VGG stages of
    ``freeze_stages``, or the whole ResNet-34 trunk with
    ``freeze_backbone``) are set ``requires_grad=False`` and left out of
    the optimizer, so they get neither an update nor weight decay (the
    chain's `_zero_frozen`).

Gradient accumulation (`OptimConfig.grad_accum_steps` = k, JAX
`optax.MultiSteps`): each micro-step folds its gradients into a running
mean, ``acc + (g - acc) / (n + 1)`` as optax does; every k-th micro-step
applies one SGD update with that mean and steps the schedule, so the
schedule counts real updates.  In between, parameters do not move.

EMA (`TrainConfig.ema_decay` = d, JAX `train/loop.py:_apply_update`): seeded
with a copy of the initial weights, ``e <- d * e + (1 - d) * p`` after each
real update only.  It covers parameters only, as JAX's ``ema_params`` holds
no ``batch_stats``: BN running statistics are served live.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

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
    moved on.  ``step`` counts train steps (micro-batches under gradient
    accumulation, as the JAX state's ``step`` does); ``mini_step`` is the
    position in the accumulation window, ``acc_grads`` its running mean
    (one tensor per optimized parameter, in param-group order) and ``ema``
    the averaged weights by parameter name (None = EMA off)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    grad_accum_steps: int = 1
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    ema: Optional[Dict[str, torch.Tensor]] = None

    def apply_gradients(self) -> bool:
        """Consume the gradients in each parameter's ``.grad``: an SGD
        update and a schedule step, or under accumulation a fold into the
        running mean (the update comes on the window's last micro-step).
        Returns True when the parameters moved."""
        self.step += 1
        k = self.grad_accum_steps
        if k > 1:
            params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in params]
            n = self.mini_step
            for p, acc in zip(params, self.acc_grads):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return False
            for p, acc in zip(params, self.acc_grads):
                p.grad = acc.clone()
                acc.zero_()
        self.optimizer.step()
        self.scheduler.step()
        return True

    def update_ema(self, decay: float) -> None:
        """``e <- e * d + p * (1 - d)`` for every parameter, in f32."""
        if self.ema is None:
            return
        params = dict(self.model.named_parameters())
        names = list(self.ema)
        ema = [self.ema[n] for n in names]
        new = [params[n].detach() for n in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - decay))


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
    ``requires_grad=False`` and get no param group.  ``steps_per_epoch``
    counts optimizer updates (micro-batches / ``grad_accum_steps``)."""
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


def frozen_prefixes(model_config: ModelConfig) -> Tuple[str, ...]:
    """Dotted parameter-name prefixes the optimizer freezes: ``trunk`` for
    the ResNet-34 family with ``freeze_backbone``, else the VGG stages of
    ``freeze_stages`` (JAX `create_train_state`)."""
    if model_config.backbone == "resnet34":
        return ("trunk",) if model_config.freeze_backbone else ()
    return vgg_frozen_prefixes(model_config.freeze_stages)


def create_train_state(model_config: ModelConfig, optim_config: OptimConfig,
                       device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       steps_per_epoch: int = 1,
                       model: Optional[nn.Module] = None,
                       ema: bool = False) -> TrainState:
    """Build the train model (`build_model(train=True)`: f32 parameters on
    ``device``, default ``cuda``), its weights drawn from ``generator`` or
    loaded from ``state_dict`` (strictly), and its optimizer, with the
    parameters under `frozen_prefixes` frozen.

    ``model``: use this module (already on its device) instead of the
    registry's; `train/loop.py` calls it as ``model(images, generator,
    remat)``, as it calls the registry's models.  ``ema``: seed `TrainState.ema` with a copy of the initial
    weights.
    """
    if model is None:
        model = build_model(model_config, device=device, generator=generator,
                            train=True)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(), optim_config, steps_per_epoch,
        frozen_prefixes(model_config))
    ema_weights = ({n: p.detach().clone()
                    for n, p in model.named_parameters()} if ema else None)
    return TrainState(model, optimizer, scheduler,
                      grad_accum_steps=max(optim_config.grad_accum_steps, 1),
                      ema=ema_weights)

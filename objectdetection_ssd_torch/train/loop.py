"""Train and eval steps — the port of `objectdetection_ssd_tpu/train/loop.py`
(`train_step`, `eval_step`) for one device.

One step: forward, the multibox loss in f32, backward (the routed convs'
filter gradients on kernel K2), SGD update and schedule step.  The batch
is the `data/pipeline.py:collate` contract: ``images`` uint8 (B, S, S, 3)
or normalized float, ``boxes`` (B, M, 4) f32 xyxy, ``classes`` (B, M)
int32, ``mask`` (B, M) bool, as numpy arrays or tensors; they are moved to
the model's device.  Gradient accumulation and the EMA live in
`train/state.py:TrainState`.  With ``quant_ste`` (a scale tree of
`infer/quant.py`) the convs it names run the straight-through fake-quant
branch for that step (quantization-aware training).

The model is called as ``model(images, generator, remat)``, the forward
signature of both registry models.  Dropout (the ResNet-34 family) draws
its masks from ``generator``, on the model's device and seeded from
``(seed, state.step)``: the same seed and step give the same masks,
another step other masks.  JAX's own stream
(``fold_in(PRNGKey(seed), step)``) is not reproduced.  A model without
dropout ignores the generator.

Under a mesh (``state.parallel``, `parallel/data_parallel.py`) the batch
is this rank's rows of the global batch and the step is the global-batch
step: the loss divides by the global positive count, the gradients are
reduced over the ranks, and the metrics are those of the global batch.
Under tensor or spatial parallelism (JAX `loop.py:279-287`) the batch is
the rows of this rank's data shard, the same on every rank of its
``model`` or ``spatial`` group; the model takes its rows of the images
itself (`parallel/spatial.py:SpatialParallel.enter`) and gathers its
heads, and `MeshParallel.backward` sums the gradients over the ranks that
hold parts of them.

`make_pp_steps` gives the same ``(state, batch) -> (state, metrics)``
steps over a `parallel/pipeline.py:PipelineRunner` (``train --pp``, JAX
`loop.py:make_pp_steps`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from objectdetection_ssd_torch.config import LossConfig
from objectdetection_ssd_torch.infer.quant import scales_attached
from objectdetection_ssd_torch.losses.multibox import (MultiboxLoss,
                                                       multibox_loss)
from objectdetection_ssd_torch.models.ssd import normalize_uint8
from objectdetection_ssd_torch.train.state import TrainState


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def dropout_generator(state: TrainState, seed: int) -> torch.Generator:
    """The generator of this step's dropout masks, on the model's device,
    seeded from ``(seed, state.step)``."""
    # splitmix64 of (seed, step): the CPU generator keeps only the low 32
    # bits of its seed, so both numbers must reach them.
    mask = (1 << 64) - 1
    z = ((((seed & 0xFFFFFFFF) << 32) | (state.step & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    gen = torch.Generator(device=_device_of(state))
    return gen.manual_seed(z ^ (z >> 31))


def _forward(state: TrainState, images: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 image batches are normalized here in f32, so any model sees
    ImageNet-normalized floats (`loop.py:40-42`); float batches pass
    through."""
    module = state.model if state.parallel is None else state.parallel.module
    return module(normalize_uint8(images), generator, remat)


def _loss(state: TrainState, batch: Mapping[str, object],
          priors: torch.Tensor, loss_config: LossConfig,
          generator: Optional[torch.Generator] = None,
          remat: bool = False) -> MultiboxLoss:
    dev = _device_of(state)
    b = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
         for k in ("images", "boxes", "classes", "mask")}
    loc, conf = _forward(state, b["images"], generator, remat)
    # Loss math in f32 whatever the model's compute dtype.
    group = None if state.parallel is None else state.parallel.group
    return multibox_loss(loc.float(), conf.float(), b["boxes"],
                         b["classes"], b["mask"],
                         torch.as_tensor(priors).to(dev), loss_config,
                         group=group)


def _metrics(state: TrainState, loss: MultiboxLoss
             ) -> Dict[str, torch.Tensor]:
    metrics = {"loss": loss.total.detach(), "cls_loss": loss.cls.detach(),
               "loc_loss": loss.loc.detach(),
               "num_pos": loss.num_pos.to(torch.float32)}
    if state.parallel is not None:
        metrics = state.parallel.global_metrics(metrics)
    return metrics


def train_step(state: TrainState, batch: Mapping[str, object],
               priors: torch.Tensor,
               loss_config: LossConfig = LossConfig(),
               seed: int = 0, remat: bool = False, ema_decay: float = 0.0,
               quant_ste: Optional[Mapping] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One SGD step (or micro-step under gradient accumulation); returns
    ``(state, metrics)``, the state updated in place.  The EMA of the
    weights (``ema_decay`` > 0 and ``state.ema`` set) moves only when the
    parameters do.  Metrics are device scalars: ``loss``, ``cls_loss``,
    ``loc_loss`` and ``num_pos`` (f32).  The gradients stay in each
    parameter's ``.grad`` until the next step.

    ``seed`` roots the dropout masks (`dropout_generator`).  ``remat``
    recomputes the VGG trunk's stage interiors in the backward
    (`models/backbones.py:VGG16Trunk`); the ResNet-34 family ignores it.
    ``quant_ste``: QAT's scale tree: the convs it names run the
    straight-through fake-quant branch with the scales held constant,
    through the backward too (remat recomputes the forward there)."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    with scales_attached(state.model, quant_ste, straight_through=True):
        loss = _loss(state, batch, priors, loss_config,
                     dropout_generator(state, seed), remat)
        if state.parallel is None:
            loss.total.backward()
        else:
            state.parallel.backward(loss.total)
    if state.apply_gradients() and ema_decay:
        state.update_ema(ema_decay)
    return state, _metrics(state, loss)


@torch.no_grad()
def eval_step(state: TrainState, batch: Mapping[str, object],
              priors: torch.Tensor,
              loss_config: LossConfig = LossConfig(),
              quant_ste: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """Loss-only eval step (the reference's 'test' phase,
    `train_function.py:47-52`), through QAT's fake-quant convs with
    ``quant_ste``; the state is not changed."""
    state.model.eval()
    with scales_attached(state.model, quant_ste, straight_through=True):
        return _metrics(state, _loss(state, batch, priors, loss_config))


def make_pp_steps(runner, priors, loss_config: LossConfig = LossConfig(),
                  ema_decay: float = 0.0
                  ) -> Tuple[Callable, Callable]:
    """Train and eval steps driven by a GPipe ``runner`` — the ``--pp``
    training surface, with `train_step`'s ``(state, batch) -> (state,
    metrics)`` contract (``eval_step``'s for the eval step).

    ``state.model`` is the monolith whose modules the runner's stages are
    (`parallel/pipeline.py:ssd300_stages`): its parameters stay on their
    stage devices across steps.  Per step the runner streams the
    microbatches through its stages and the rematerialized backward; the
    mean gradients are written into each parameter's ``.grad`` and applied
    by `TrainState.apply_gradients` and `update_ema`, so the schedule,
    warmup, gradient accumulation, the EMA and checkpointing apply
    unchanged.  Metrics: the mean ``loss``, ``cls_loss`` and ``loc_loss``
    over the microbatches and the summed ``num_pos``, on the last stage's
    device.  With one microbatch the step is `train_step`'s; with M the
    gradients follow ``--grad-accum``'s mean.  Dropout-free models only:
    no generator reaches the stages.

    The eval step is the runner's forward, then the loss.  The priors are
    copied once to the last stage's device."""
    last = runner.aux_device
    priors = torch.as_tensor(priors).to(last)

    def pp_loss(out, aux) -> Tuple[torch.Tensor, MultiboxLoss]:
        loc, conf = out
        # Loss math in f32 whatever the model's compute dtype.
        loss = multibox_loss(loc.float(), conf.float(), aux["boxes"],
                             aux["classes"], aux["mask"], priors,
                             loss_config)
        return loss.total, loss

    def _aux(batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(last, non_blocking=True)
                for k in ("boxes", "classes", "mask")}

    def _metrics(parts: Sequence[MultiboxLoss]) -> Dict[str, torch.Tensor]:
        inv = 1.0 / len(parts)
        mean = {key: sum(getattr(p, attr).detach() for p in parts) * inv
                for key, attr in (("loss", "total"), ("cls_loss", "cls"),
                                  ("loc_loss", "loc"))}
        return {**mean, "num_pos": sum(p.num_pos for p in parts)
                .to(torch.float32)}

    def pp_train_step(state: TrainState, batch: Mapping[str, object]
                      ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        _, grads, parts = runner.loss_and_grads(
            torch.as_tensor(batch["images"]), pp_loss, aux=_aux(batch),
            has_aux=True)
        for stage, stage_grads in zip(runner.stages, grads):
            params = dict(stage.named_parameters())
            for name, g in stage_grads.items():
                params[name].grad = g
        if state.apply_gradients() and ema_decay:
            state.update_ema(ema_decay)
        return state, _metrics(parts)

    @torch.no_grad()
    def pp_eval_step(state: TrainState, batch: Mapping[str, object]
                     ) -> Dict[str, torch.Tensor]:
        state.model.eval()
        out = runner.forward(torch.as_tensor(batch["images"]))
        return _metrics([pp_loss(out, _aux(batch))[1]])

    return pp_train_step, pp_eval_step

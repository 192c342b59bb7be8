"""Pipeline parallelism (GPipe) — the port of
`objectdetection_ssd_tpu/parallel/pipeline.py`.

Consecutive stages of the model live on different devices and microbatches
stream through them.  As in the JAX package the runner is
single-controller: one process drives every stage, activations move
device to device with explicit copies, and CUDA's asynchronous launches
let stage s work on microbatch m while stage s+1 works on microbatch m-1.
It is not `torch.distributed.pipelining`, whose stages are processes.

The backward is the rematerialized pipeline: the forward fill runs under
``torch.no_grad()`` and keeps only each stage's input per microbatch (the
GPipe stash); the backward drains the newest microbatch first and
recomputes each stage's forward from its stash before backpropagating the
output gradient through it.  Gradients and the loss are the mean over the
microbatches, the `--grad-accum` semantics; with one microbatch the step
is the monolithic step.

SSD300's stages are views over the monolith's own submodules, not copies
(`SSD300TrunkSliceStage`, `SSD300HeadStage`; the two-stage split's
`SSD300TrunkStage`, `build_ssd300_pipeline`), under the monolith's
parameter names.  So the optimizer, the EMA and the checkpoints go on
seeing one monolithic model, `freeze_stages` detaches at the same
boundaries, and a conv that ``ModelConfig.dw_pallas_convs`` routes through
kernel K2 stays routed (the JAX stages drop the Pallas route; the filter
gradient is the same function either way).  The cuts sit where the carry
is one tensor or the (conv4_3, x) pair (`SSD300_STAGE_CUTS`), so no dead
bytes cross a stage boundary.

With ``dp > 1`` each stage runs on ``dp`` devices: the lead device holds
the monolith's modules and ``dp - 1`` replicas are refreshed from it at
each call; each microbatch's rows split over the replicas, the last
stage's outputs are joined on its lead device so that the loss is the loss
of the whole microbatch, and the replicas' parameter gradients are summed
onto the lead.  The same global batch then gives plain PP's step.

A stage carry is a tensor, or a tuple, list or dict of them.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from objectdetection_ssd_torch.device import DeviceLike
from objectdetection_ssd_torch.models.backbones import (VGG_STAGE_PARAMS,
                                                        VGG16Trunk)
from objectdetection_ssd_torch.models.ssd import (SSD300, prepare_input,
                                                  ssd300_post_trunk)

# Trunk cut points per --pp stage count: each (first, last) is an inclusive
# 1-based VGG stage range (`models/backbones.py:VGG16Trunk._stage`); the
# head stage (L2Norm + pyramid + heads) is always appended.
SSD300_STAGE_CUTS = {
    2: ((1, 5),),
    3: ((1, 3), (4, 5)),
    4: ((1, 2), (3, 4), (5, 5)),
}

SINGLE_CONTROLLER = ("--pp is single-controller (one process drives all "
                     "stages); it does not compose with multi-host runs")


# ------------------------------------------------------------ carry trees


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    raise TypeError(f"a stage carry holds tensors, not {type(tree).__name__}")


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def _unflatten(tree: Any, leaves: Sequence[torch.Tensor]) -> Any:
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def _to(tree: Any, device: torch.device) -> Any:
    return _map(lambda t: t.to(device, non_blocking=True), tree)


def _rows(tree: Any, lo: int, hi: int) -> Any:
    return _map(lambda t: t[lo:hi], tree)


def _cat(trees: Sequence[Any], device: torch.device) -> Any:
    if len(trees) == 1:
        return _to(trees[0], device)
    cols = zip(*(_leaves(_to(t, device)) for t in trees))
    return _unflatten(trees[0], [torch.cat(c, dim=0) for c in cols])


def _grad_leaf(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.requires_grad_() if t.is_floating_point() else t


# ----------------------------------------------------- SSD300's partition


def _stage_prefixes(num_stages: int) -> List[Optional[Tuple[str, ...]]]:
    """Per stage, the dotted module prefixes of its parameters; None for
    the head stage (every name outside the trunk)."""
    cuts = SSD300_STAGE_CUTS.get(num_stages)
    if cuts is None:
        raise ValueError(
            f"unsupported SSD300 stage count {num_stages}; "
            f"choose from {sorted(SSD300_STAGE_CUTS)}")
    trunk = [tuple(f"trunk.{n}" for grp in VGG_STAGE_PARAMS[a - 1:b]
                   for n in grp) for a, b in cuts]
    return trunk + [None]


def split_ssd300_params_n(state_dict: Dict[str, Any], num_stages: int
                          ) -> List[Dict[str, Any]]:
    """Partition a monolithic SSD300 ``state_dict`` (or any map keyed by
    its names, e.g. gradients) into ``num_stages`` stage dicts along
    `SSD300_STAGE_CUTS`: the trunk slices, then every name outside the
    trunk.  Pure key partition, no copies and no renames;
    `merge_ssd300_stage_trees` is its exact inverse."""
    prefixes = _stage_prefixes(num_stages)
    stages: List[Dict[str, Any]] = [{} for _ in prefixes]
    for name, value in state_dict.items():
        for s, pre in enumerate(prefixes):
            if pre is None:
                if not name.startswith("trunk."):
                    stages[s][name] = value
                    break
            elif any(name.startswith(p + ".") for p in pre):
                stages[s][name] = value
                break
        else:
            raise ValueError(f"{name!r} belongs to no SSD300 stage")
    return stages


def split_ssd300_params(state_dict: Dict[str, Any]
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(trunk, head)``: the two-stage partition of a monolithic SSD300
    ``state_dict`` (every ``trunk.*`` name, then every other name);
    `split_ssd300_params_n` with 2 stages."""
    trunk, head = split_ssd300_params_n(state_dict, 2)
    return trunk, head


def merge_ssd300_stage_trees(stage_dicts: Sequence[Dict[str, Any]]
                             ) -> Dict[str, Any]:
    """Inverse of `split_ssd300_params_n`: one monolithic dict."""
    out: Dict[str, Any] = {}
    for d in stage_dicts:
        out.update(d)
    return out


class _TrunkSlice(VGG16Trunk):
    """The convs of VGG stages [first..last] of ``trunk`` (its own modules,
    under its names), running `VGG16Trunk._stage`."""

    def __init__(self, trunk: VGG16Trunk, first: int, last: int):
        nn.Module.__init__(self)
        self.freeze_stages = trunk.freeze_stages
        self.part = trunk.part
        for grp in VGG_STAGE_PARAMS[first - 1:last]:
            for name in grp:
                self.add_module(name, getattr(trunk, name))


class SSD300TrunkSliceStage(nn.Module):
    """Pipeline stage holding VGG stages [first..last] of ``model``'s trunk
    (parameters ``trunk.<conv>.*``, the monolith's own).  It normalizes
    the input when ``first == 1``.

    Carry (JAX `models/backbones.py:apply_vgg_stages`): in, ``x`` for
    ``first <= 4`` and ``conv4_3`` for ``first == 5``; out, ``x`` for
    ``last <= 3``, ``conv4_3`` for ``last == 4`` and the pair
    ``(conv4_3, x)`` for ``last == 5``."""

    def __init__(self, model: SSD300, first: int, last: int):
        super().__init__()
        self.first, self.last = first, last
        self.dtype = model.dtype
        self.trunk = _TrunkSlice(model.trunk, first, last)

    def forward(self, carry):
        x = prepare_input(carry, self.dtype) if self.first == 1 else carry
        conv4_3 = x if self.first == 5 else None
        for stage in range(self.first, self.last + 1):
            x = self.trunk._stage(x, stage)
            if stage == 4:
                conv4_3 = x
        return (conv4_3, x) if self.last == 5 else x


class SSD300TrunkStage(SSD300TrunkSliceStage):
    """Stage 0 of the two-stage split: the input adapter and the whole VGG
    trunk of ``model``, its own modules.  Carry in, the images; out,
    ``(conv4_3, x)``."""

    def __init__(self, model: SSD300):
        super().__init__(model, 1, 5)


class SSD300HeadStage(nn.Module):
    """Pipeline stage after the trunk: L2Norm, extra pyramid and heads
    (`models/ssd.py:ssd300_post_trunk`) over ``model``'s own non-trunk
    modules, under their names.  Carry in ``(conv4_3, x)``, out
    ``(loc, conf)``."""

    def __init__(self, model: SSD300):
        super().__init__()
        self.num_classes = model.num_classes
        self.part = model.part
        for name, child in model.named_children():
            if name != "trunk":
                self.add_module(name, child)

    def forward(self, carry):
        conv4_3, x = carry
        return ssd300_post_trunk(self, conv4_3, x)


def ssd300_stages(model: SSD300, num_stages: int) -> List[nn.Module]:
    """The ``num_stages`` stage modules of ``model`` along
    `SSD300_STAGE_CUTS`."""
    if num_stages not in SSD300_STAGE_CUTS:
        raise ValueError(
            f"--pp {num_stages} unsupported for SSD300; choose from "
            f"{sorted(SSD300_STAGE_CUTS)}")
    return [SSD300TrunkSliceStage(model, a, b)
            for a, b in SSD300_STAGE_CUTS[num_stages]] + [
                SSD300HeadStage(model)]


def build_ssd300_pipeline(model: SSD300,
                          devices: Optional[Sequence[DeviceLike]] = None,
                          microbatches: int = 1) -> "PipelineRunner":
    """Two-stage GPipe runner over ``model`` (`SSD300TrunkStage`,
    `SSD300HeadStage`), whose parameters it moves to their stage devices.
    ``devices=None`` takes the first two CUDA cards and raises when there
    are fewer; the CPU is only ever an explicit ``["cpu", "cpu"]``."""
    if devices is None:
        n = torch.cuda.device_count()
        if n < 2:
            raise RuntimeError(
                f"a two-stage pipeline needs 2 CUDA devices; {n} available "
                "(pass devices explicitly, e.g. ['cpu', 'cpu'])")
        devices = ["cuda:0", "cuda:1"]
    return PipelineRunner([SSD300TrunkStage(model), SSD300HeadStage(model)],
                          devices, microbatches=microbatches)


def build_pipeline_for(model: nn.Module, num_stages: int,
                       devices: Sequence[DeviceLike], microbatches: int = 1,
                       dp: int = 1) -> "PipelineRunner":
    """Model-family dispatch for `train --pp`: a runner over ``model``'s
    stages, whose parameters it moves to their stage devices.  SSD300
    only: the ResNet-34 family has dropout, and the pipeline is
    dropout-free, as JAX's is."""
    if not isinstance(model, SSD300):
        raise ValueError(
            "--pp supports the SSD300 family; got "
            f"{type(model).__name__} (supply a custom pp_build to Trainer "
            "for other models)")
    return PipelineRunner(ssd300_stages(model, num_stages), devices,
                          microbatches=microbatches, dp=dp)


# ----------------------------------------------------------------- runner


class PipelineRunner:
    """Single-controller GPipe executor over heterogeneous stages.

    ``stages[s]`` is a module mapping a carry to the next carry; its
    parameters move to ``devices[s * dp]`` (in place: the stages of
    `ssd300_stages` are the monolith's modules).  ``devices`` is explicit,
    and a device may repeat (every stage on one card, or on the CPU).
    With ``dp > 1``, ``devices[s * dp + r]`` holds replica ``r`` of stage
    ``s`` (replica 0 the stage itself)."""

    def __init__(self, stages: Sequence[nn.Module],
                 devices: Sequence[DeviceLike], microbatches: int = 1,
                 dp: int = 1):
        if dist.is_available() and dist.is_initialized():
            raise ValueError(SINGLE_CONTROLLER)
        if microbatches < 1:
            raise ValueError("microbatches must be >= 1")
        if dp < 1:
            raise ValueError("dp must be >= 1")
        devs = [torch.device(d) for d in devices]
        nstage = len(stages)
        if len(devs) < nstage * dp:
            raise ValueError(
                f"{nstage} stages x {dp} data ways need {nstage * dp} "
                f"devices, got {len(devs)}")
        self.dp = dp
        self.microbatches = microbatches
        self.stages = list(stages)
        # Lead device per stage: where its parameters and gradients live.
        self.devices = [devs[s * dp] for s in range(nstage)]
        self.replica_devices = [devs[s * dp:(s + 1) * dp]
                                for s in range(nstage)]
        for stage, dev in zip(self.stages, self.devices):
            stage.to(dev)
        self.replicas = [
            [stage] + [copy.deepcopy(stage).to(d) for d in rdevs[1:]]
            for stage, rdevs in zip(self.stages, self.replica_devices)]

    @property
    def aux_device(self) -> torch.device:
        """Where the loss reads its per-example targets: the last stage's
        lead device."""
        return self.devices[-1]

    # -- helpers ----------------------------------------------------------

    def _split(self, batch: Any) -> List[Any]:
        n = _leaves(batch)[0].shape[0]
        m = self.microbatches
        if n % m:
            raise ValueError(f"batch {n} not divisible by {m} microbatches")
        k = n // m
        if k % self.dp:
            raise ValueError(
                f"microbatch rows {k} (batch {n} / {m} microbatches) not "
                f"divisible by the per-stage data ways dp={self.dp}")
        return [_rows(batch, i * k, (i + 1) * k) for i in range(m)]

    def _chunks(self, tree: Any) -> List[Any]:
        """A microbatch's rows split over the ``dp`` replicas."""
        k = _leaves(tree)[0].shape[0] // self.dp
        return [_rows(tree, r * k, (r + 1) * k) for r in range(self.dp)]

    @torch.no_grad()
    def refresh(self) -> None:
        """Copy each stage's parameters and buffers to its replicas."""
        for reps in self.replicas:
            lead = list(reps[0].parameters()) + list(reps[0].buffers())
            for rep in reps[1:]:
                mine = list(rep.parameters()) + list(rep.buffers())
                for dst, src in zip(mine, lead):
                    dst.copy_(src, non_blocking=True)

    def _fill(self, microbatch: Any, stash: Optional[list]) -> Any:
        """One microbatch through every stage (no graph); appends each
        stage's per-replica inputs to ``stash`` when given.  Returns the
        last stage's outputs joined on its lead device."""
        chunks = self._chunks(microbatch)
        row = []
        for s, reps in enumerate(self.replicas):
            chunks = [_to(c, d) for c, d in
                      zip(chunks, self.replica_devices[s])]
            row.append(chunks)
            chunks = [rep(c) for rep, c in zip(reps, chunks)]
        if stash is not None:
            stash.append(row)
        return _cat(chunks, self.devices[-1])

    # -- inference --------------------------------------------------------

    def forward(self, batch: Any) -> Any:
        """Pipelined forward of the current weights, without a graph; the
        last stage's outputs concatenated over microbatches on its lead
        device."""
        self.refresh()
        with torch.no_grad():
            outs = [self._fill(mb, None) for mb in self._split(batch)]
        return _cat(outs, self.devices[-1])

    # -- training ---------------------------------------------------------

    def _stage_backward(self, s: int, inputs: list, grads: list
                        ) -> Tuple[Optional[list], List[Optional[list]]]:
        """Recompute stage ``s`` on each replica's stashed input and
        backpropagate the output gradients: (input gradients per replica,
        or None when nothing flows further back; parameter gradients per
        replica, aligned with ``stage.parameters()``, None where unused)."""
        back, pgrads = [], []
        for rep, h, g in zip(self.replicas[s], inputs, grads):
            params = [p for p in rep.parameters() if p.requires_grad]
            h = _map(_grad_leaf, h) if s else h
            with torch.enable_grad():
                y = rep(h)
            pairs = [(a, b) for a, b in zip(_leaves(y), _leaves(g))
                     if a.requires_grad]
            hs = [t for t in _leaves(h) if t.requires_grad] if s else []
            if not pairs:
                back.append(None)
                pgrads.append(None)
                continue
            got = torch.autograd.grad([a for a, _ in pairs], params + hs,
                                      [b for _, b in pairs],
                                      allow_unused=True)
            pgrads.append(list(got[:len(params)]))
            dh = got[len(params):]
            if not hs or all(d is None for d in dh):
                back.append(None)
                continue
            it = iter(dh)
            back.append(_fill_none(_map(lambda t: (
                next(it) if t.requires_grad else None), h), h))
        return (None if all(b is None for b in back) else back), pgrads

    def loss_and_grads(self, batch: Any, loss_fn: Callable[..., Any],
                       aux: Any = None, has_aux: bool = False):
        """GPipe forward and backward of the current weights.

        ``loss_fn(out)`` (``loss_fn(out, aux_mb)`` with ``aux``) maps the
        last stage's output of one microbatch to a scalar, or to
        ``(scalar, extras)`` with ``has_aux``.  ``aux`` holds per-example
        targets with the batch's leading dim, split into the same rows as
        the inputs and moved to the last stage's lead device.

        Returns ``(loss, grads)``, or ``(loss, grads, extras)`` with
        ``has_aux`` (one per microbatch, newest first, the drain order):
        ``loss`` is the mean microbatch loss, a detached scalar tensor on
        the last stage's lead device (no host sync); ``grads[s]`` maps each
        trained parameter name of ``stages[s]`` to its mean gradient over
        the microbatches, on the stage's lead device, summed over the
        replicas; a parameter the loss does not reach is left out, as
        autograd leaves its ``.grad`` None."""
        self.refresh()
        mbs = self._split(batch)
        aux_mbs = (None if aux is None else
                   [_to(a, self.aux_device) for a in self._split(aux)])
        stash: list = []
        with torch.no_grad():
            outs = [self._fill(mb, stash) for mb in mbs]

        nstage = len(self.stages)
        named = [[(n, p) for n, p in stage.named_parameters()
                  if p.requires_grad] for stage in self.stages]
        gsum: List[List[Optional[torch.Tensor]]] = [
            [None] * len(ps) for ps in named]
        loss_sum = None
        extras: List[Any] = []
        for m in reversed(range(len(outs))):
            out = _map(_grad_leaf, outs[m])
            with torch.enable_grad():
                val = (loss_fn(out) if aux_mbs is None
                       else loss_fn(out, aux_mbs[m]))
            loss_m, extra = val if has_aux else (val, None)
            if has_aux:
                extras.append(extra)
            leaves = [t for t in _leaves(out) if t.requires_grad]
            g_out = torch.autograd.grad(loss_m, leaves, allow_unused=True)
            it = iter(g_out)
            g = _fill_none(_map(lambda t: (
                next(it) if t.requires_grad else None), out), out)
            loss_m = loss_m.detach()
            loss_sum = loss_m if loss_sum is None else loss_sum + loss_m
            grads = self._chunks(g)
            for s in reversed(range(nstage)):
                grads = [_to(c, d) for c, d in
                         zip(grads, self.replica_devices[s])]
                back, pgrads = self._stage_backward(s, stash[m][s], grads)
                lead = self.devices[s]
                for rep_grads in pgrads:
                    if rep_grads is None:
                        continue
                    for i, d in enumerate(rep_grads):
                        if d is None:
                            continue
                        d = d.to(lead)
                        gsum[s][i] = d if gsum[s][i] is None else \
                            gsum[s][i] + d
                if back is None:
                    break
                grads = back
            stash[m] = None

        inv = 1.0 / len(outs)
        loss = loss_sum * inv
        out_grads = [{n: g * inv for (n, _), g in zip(ps, gs)
                      if g is not None} for ps, gs in zip(named, gsum)]
        if has_aux:
            return loss, out_grads, extras
        return loss, out_grads


def _fill_none(grad_tree: Any, like: Any) -> Any:
    """``grad_tree`` with each None leaf (no gradient reached it) replaced
    by zeros shaped as the matching leaf of ``like``."""
    if grad_tree is None or isinstance(grad_tree, torch.Tensor):
        return torch.zeros_like(like) if grad_tree is None else grad_tree
    if isinstance(grad_tree, (tuple, list)):
        return type(grad_tree)(_fill_none(g, l)
                               for g, l in zip(grad_tree, like))
    return {k: _fill_none(grad_tree[k], like[k]) for k in grad_tree}

"""The train step's model wrappers under a mesh: DDP on a ``data`` mesh,
FSDP2 (HSDP with a ``data`` axis too) on a ``data x fsdp`` mesh
(`DataParallel`); tensor or spatial parallelism on a ``data x model`` or
``data x spatial`` mesh (`MeshParallel`).  `wrap` picks one.

JAX's data parallelism is GSPMD over one global batch, so its step is the
single-device step of the whole batch.  `DataParallel` gives the port's
step the same gradient, one process per card:

* the loss divides by the positives of the global batch
  (`losses/multibox.py`, ``group``): each rank's loss is its share of the
  global-batch loss, and the step backpropagates ``count`` times that
  share, because DDP and FSDP2 average the gradients over the ``count``
  ranks;
* train-mode BatchNorm takes its statistics over the global batch
  (`models/layers.py:BatchNorm`, ``group``);
* dropout draws its masks at the global batch shape and keeps this rank's
  rows (`models/layers.py:Dropout`, ``shard``);
* the metrics are summed over the ranks (`global_metrics`).

A mesh with an ``fsdp`` axis runs FSDP2 (HSDP when its ``data`` axis is
> 1 too), one without runs DDP.  FSDP2 shards each parameter as
`parallel.mesh.fsdp_sharding_for` says; one that it would replicate (no
dim divisible by the ``fsdp`` size, as ResNet-34's 189-long conf biases)
is sharded unevenly on dim 0 instead, which FSDP2 pads: the same
arithmetic as JAX's replicated leaf, and every parameter, gradient and
optimizer slot is then a shard of one kind.  Rank ``r`` holds rows
``[r * b, (r + 1) * b)`` of each global batch: every mesh axis carries
batch rows and the mesh lays the ranks out in order.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from objectdetection_ssd_torch.models.layers import (BatchNorm, Dropout,
                                                     set_partition)
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.parallel.spatial import SpatialParallel
from objectdetection_ssd_torch.parallel.tensor_parallel import (
    TensorParallel, shard_model)


class DataParallel:
    """``model`` (on this rank's device, weights equal on every rank)
    wrapped for ``mesh``.  ``module`` is what the step calls: the DDP
    wrapper, or ``model`` itself once FSDP2 has sharded it in place."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh):
        if not dist.is_initialized():
            raise RuntimeError("data parallelism needs an initialized "
                               "process group (parallel.distributed."
                               "initialize)")
        self.group = dist.group.WORLD
        self.count = dist.get_world_size()
        self.fsdp = "fsdp" in (mesh.mesh_dim_names or ())
        # A checkpoint gathers the parameters (a collective) under FSDP2.
        self.sharded = self.fsdp
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = self.group
            elif isinstance(m, Dropout):
                m.shard = (dist.get_rank(), self.count)
        if self.fsdp:
            from torch.distributed.fsdp import fully_shard
            # FSDP2 shards contiguous parameters only; the model's 4-D
            # weights are channels_last.  A conv with a channels_last input
            # still runs channels_last.
            for p in model.parameters():
                p.data = p.data.contiguous()

            def placement(p: nn.Parameter) -> Shard:
                pl = mesh_lib.fsdp_sharding_for(p, mesh)
                return pl if isinstance(pl, Shard) else Shard(0)

            # HSDP on a 2-D mesh (replicate over data, shard over fsdp).
            fsdp_mesh = (mesh if mesh_lib.axis_size(mesh, "data") > 1
                         else mesh["fsdp"])
            fully_shard(model, mesh=fsdp_mesh, shard_placement_fn=placement)
            self.module = model
        else:
            from torch.nn.parallel import DistributedDataParallel
            device = next(model.parameters()).device
            self.module = DistributedDataParallel(
                model,
                device_ids=[device] if device.type == "cuda" else None,
                broadcast_buffers=False)

    def backward(self, loss: torch.Tensor) -> None:
        """Backpropagate this rank's share of the global-batch loss: DDP
        and FSDP2 average the gradients over the ``count`` ranks, so each
        backpropagates ``count`` times its share."""
        (loss * self.count).backward()

    def global_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The step's metrics of the global batch: the loss terms (each
        rank's share) summed over the ranks; ``num_pos`` is already
        global."""
        return _sum_metrics(metrics, self.group)


def _sum_metrics(metrics: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    names = [k for k in metrics if k != "num_pos"]
    vals = torch.stack([metrics[k] for k in names])
    dist.all_reduce(vals, group=group)
    return {**dict(zip(names, vals.unbind())), "num_pos": metrics["num_pos"]}


class MeshParallel:
    """``model`` (on this rank's device, weights equal on every rank)
    partitioned in place for a ``data x model`` (tensor parallel,
    `parallel/tensor_parallel.py`) or ``data x spatial`` mesh
    (`parallel/spatial.py`).  JAX partitions the same step with GSPMD;
    here the collectives are written by hand and the gradients reduced by
    hand:

    * every rank of a ``model`` or ``spatial`` group computes the whole
      loss of its data shard (the heads are gathered before the loss) and
      backpropagates ``1 / ways`` of its share of the global-batch loss,
      so that the gradients of the tensors the group replicates are
      partial on each rank and sum to the true ones: the gathers' and
      halo exchanges' backwards sum them over the group;
    * a parameter's gradient is then summed over the ranks that hold
      partial gradients of it: the ``data`` group for a tensor-parallel
      channel shard (each ``model`` rank holds the whole gradient of its
      own channels), every rank for a tensor-parallel replicated
      parameter and for every parameter under spatial partitioning (each
      rank backpropagates its own rows);
    * train-mode BatchNorm takes its statistics over the ``data`` group
      under tensor parallelism (its channels are local) and over every
      rank under spatial partitioning; dropout draws its masks at the
      global shape and keeps this rank's batch rows (`data_shard`) and
      channels or map rows;
    * the metrics are summed over the ``data`` group.

    ``module`` is ``model`` itself.  The loss's positives are counted over
    ``group``, the ``data`` group."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh):
        if not dist.is_initialized():
            raise RuntimeError("tensor and spatial parallelism need an "
                               "initialized process group (parallel."
                               "distributed.initialize)")
        part = partition_model(model, mesh)
        if part is None:
            raise ValueError("MeshParallel needs a model or spatial axis > 1")
        self.group = mesh.get_group("data")
        self.ways = part.ways
        self.sharded = part.kind == "model"
        bn_group = self.group if self.sharded else dist.group.WORLD
        shard = mesh_lib.data_shard(mesh)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = bn_group
            elif isinstance(m, Dropout):
                m.shard = shard
        self.module = model

    def backward(self, loss: torch.Tensor) -> None:
        """Backpropagate ``1 / ways`` of this rank's share of the loss, then
        sum each gradient over the ranks that hold parts of it."""
        (loss / self.ways).backward()
        self.reduce_gradients()

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Sum every trained parameter's gradient (zeros where this rank's
        graph did not reach it) over the ranks that hold parts of it, one
        flat all-reduce per group, in the model's order."""
        by_group: Dict[str, list] = {"data": [], "world": []}
        for p in self.module.parameters():
            if not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            local = p.grad.to_local() if isinstance(p.grad, DTensor) \
                else p.grad
            shard = isinstance(p, DTensor) and any(
                isinstance(pl, Shard) for pl in p.placements)
            by_group["data" if shard else "world"].append(local)
        for key, grads in by_group.items():
            group = self.group if key == "data" else dist.group.WORLD
            if not grads or dist.get_world_size(group) == 1:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def global_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The loss terms (each data shard's share, the same on every rank
        of its ``model`` or ``spatial`` group) summed over the ``data``
        group; ``num_pos`` is already global."""
        if dist.get_world_size(self.group) == 1:
            return metrics
        return _sum_metrics(metrics, self.group)


def partition_model(model: nn.Module, mesh: DeviceMesh):
    """Partition ``model`` (whole, weights equal on every rank) in place
    over the mesh's ``model`` axis (its weights sharded,
    `parallel/tensor_parallel.py`) or ``spatial`` axis
    (`parallel/spatial.py`), and return the partition its layers now
    consult; None, and ``model`` untouched, without such an axis."""
    axis = mesh_lib.secondary_axis(mesh)
    if axis is None:
        return None
    if axis == "model":
        part = TensorParallel(mesh)
        shard_model(model, part)
    else:
        part = SpatialParallel(mesh)
    set_partition(model, part)
    return part


def wrap(model: nn.Module, mesh: DeviceMesh):
    """The train step's wrapper of ``model`` for ``mesh``: `MeshParallel`
    on a mesh with a ``model`` or ``spatial`` axis, else `DataParallel`."""
    if mesh_lib.secondary_axis(mesh) is not None:
        return MeshParallel(model, mesh)
    return DataParallel(model, mesh)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP2 shard (collective), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def full_state_dict(tensors: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A state dict (or any name -> tensor map) with every shard gathered:
    the single-device format.  Collective under FSDP2: every rank calls
    it."""
    return {k: full_tensor(v) for k, v in tensors.items()}


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``like``: this rank's shard of it when
    ``like`` is an FSDP2 shard (collective), else ``full`` on ``like``'s
    device."""
    if isinstance(like, DTensor):
        return distribute_tensor(full.to(like.device, like.dtype),
                                 like.device_mesh, like.placements)
    return full.to(like.device)

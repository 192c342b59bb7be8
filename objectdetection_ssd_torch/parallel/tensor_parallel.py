"""Tensor parallelism over the ``model`` axis of a mesh: what GSPMD does
for the JAX package's ``model`` axis (`objectdetection_ssd_tpu/parallel/
mesh.py:tp_sharding_for`), written by hand.

Each rank of a ``model`` group of ``ways`` ranks computes output channels
``[i * C / ways, (i + 1) * C / ways)`` of every conv whose width ``C`` the
group divides (Megatron's column-parallel arrangement), for the whole
batch of its data shard:

* `shard_model` keeps only that slice of each such weight, bias,
  BatchNorm scale and statistic and L2Norm scale, as a `DTensor`
  (``Shard(0)`` on ``model``); a tensor whose width the group does not
  divide is kept whole on every rank (``Replicate``) and computed whole.
  Every parameter is a DTensor, so the optimizer's state, the EMA and the
  accumulation window are too, and `parallel/data_parallel.py:
  full_state_dict` gathers them into single-device checkpoints;
* activations stay channel-sharded through the per-channel work (bias,
  ReLU, max pool, BatchNorm, dropout, the residual add); a consumer that
  needs every channel gathers them (`TensorParallel.gather_channels`):
  the next conv (`models/layers.py:TorchConv`, when its input is narrower
  than its ``in_channels``) and the heads before `flatten_head`.  A tap
  read by several convs is gathered once (`models/ssd.py`);
* `L2Norm` sums its squares over the local channels and all-reduces the
  sums (`models/layers.py:L2Norm`), so its output and scale stay sharded.

The gather is `parallel/collectives.py:all_gather_stack` over the group;
its backward sums the ranks' partial input gradients (each rank's convs
see only their own output channels) and keeps this rank's channels.
Activations cross ranks in their compute dtype, or as int8 between
requant-chained int8 convs.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from objectdetection_ssd_torch.models.layers import (BatchNorm, L2Norm,
                                                     TorchConv)
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.parallel.collectives import all_gather_stack

# The modules whose every parameter and buffer is indexed by output
# channel on dim 0.
_CHANNEL_MODULES = (TorchConv, BatchNorm, L2Norm)


class TensorParallel:
    """A rank's place on the ``model`` axis of ``mesh``: the partition
    that the layers of a sharded model consult (``part``)."""

    kind = "model"

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.group = mesh.get_group("model")
        self.ways = mesh_lib.axis_size(mesh, "model")
        self.index = mesh.get_local_rank("model")

    def channels(self, width: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's output channels of a ``width``-wide
        tensor that the axis divides."""
        per = width // self.ways
        return self.index * per, (self.index + 1) * per

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The model's input as this rank computes on it: all of it."""
        return x

    def gather_channels(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C / ways, H, W) channel shards -> (B, C, H, W), every rank's
        channels in rank order, ``channels_last`` (differentiable)."""
        b, c, h, w = x.shape
        parts = all_gather_stack(x.permute(0, 2, 3, 1), self.group)
        return parts.permute(1, 2, 3, 0, 4).reshape(
            b, h, w, self.ways * c).permute(0, 3, 1, 2)

    def full_channels(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """``x`` with all ``channels`` of its layer: gathered when it holds
        this rank's shard of them, else ``x``."""
        return self.gather_channels(x) if x.shape[1] != channels else x

    # A head is whole once its channels are.
    whole = full_channels


def _shard(t: torch.Tensor, part: TensorParallel) -> DTensor:
    placement = mesh_lib.tp_sharding_for(t, part.mesh)
    local = t.detach()
    if placement != Replicate():
        lo, hi = part.channels(t.shape[0])
        local = local[lo:hi]
    placements = [Replicate()] * part.mesh.ndim
    placements[list(part.mesh.mesh_dim_names).index("model")] = placement
    return DTensor.from_local(local.clone(), part.mesh, placements,
                              run_check=False)


def shard_model(model: nn.Module, part: TensorParallel) -> nn.Module:
    """Shard ``model`` (whole, weights equal on every rank) in place: each
    parameter and buffer of its convs, BatchNorms and L2Norms becomes a
    DTensor holding this rank's slice (`tp_sharding_for`).  Parameters of
    any other module refuse: their layout has no rule here."""
    for module in model.modules():
        own = list(module.named_parameters(recurse=False))
        if not own:
            continue
        if not isinstance(module, _CHANNEL_MODULES):
            raise ValueError(f"tensor parallelism: no sharding rule for the "
                             f"parameters of {type(module).__name__}")
        for name, p in own:
            setattr(module, name, nn.Parameter(_shard(p, part),
                                               requires_grad=p.requires_grad))
        for name, buf in list(module.named_buffers(recurse=False)):
            module.register_buffer(name, _shard(buf, part))
    return model

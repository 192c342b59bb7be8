"""The two collectives that tensor and spatial parallelism are built
from, written by hand as autograd Functions: JAX has none to port, because
GSPMD inserts its channel gathers and halo exchanges itself, and
PyTorch's DTensor shards a convolution over its batch only.

`all_reduce_sum(x, group)` is the differentiable sum over the group (its
backward sums the gradients too): BatchNorm's statistics and L2Norm's
squares under a mesh.

`all_gather_stack(x, group)` stacks every rank's ``x`` (same shape on
every rank) along a new leading dim, in group-rank order.  Its backward
is the matching reduce-scatter: the gradient of the stack is summed over
the group and each rank keeps its own entry.  That is the right backward
wherever the ranks hold *partial* gradients of a tensor they all hold —
the convention of `parallel/data_parallel.py:MeshParallel`, where every
rank of a ``model`` or ``spatial`` group backpropagates its share of the
loss and the gradient of a tensor that the group replicates is the sum
of the ranks' gradients.

The reduce-scatter is an all-reduce of the whole stack followed by the
rank's slice: gloo has no ``reduce_scatter``, and ``all_gather`` and
``all_reduce`` take CPU and CUDA tensors on gloo and NCCL alike, so one
code path runs on both backends and never copies to the host itself.
It moves ``ways`` times the bytes of a reduce-scatter in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _AllGatherStack(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Optional[dist.ProcessGroup]
                ) -> torch.Tensor:
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
        dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # A fresh buffer: the incoming gradient may be shared.
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank], None


def all_gather_stack(x: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> torch.Tensor:
    """``(ways, *x.shape)``: every rank's ``x`` in group-rank order
    (differentiable: the backward sums the stack's gradient over the group
    and returns this rank's entry).  ``x`` should be contiguous (an NHWC
    view of a ``channels_last`` activation is) or it is copied."""
    return _AllGatherStack.apply(x, group)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Optional[dist.ProcessGroup]
                ) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """``x`` summed over the group, on every rank (differentiable: the
    backward sums the gradients over the group)."""
    return _AllReduceSum.apply(x, group)

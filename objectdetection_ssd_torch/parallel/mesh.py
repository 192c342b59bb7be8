"""Device mesh and its rules — the port of
`objectdetection_ssd_tpu/parallel/mesh.py`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over every process
of the job (one process per card), with JAX's axis names and layout (rank
``d * n + s`` at coordinate ``(d, s)``):

* ``data`` and ``fsdp`` carry batch rows: on a ``data x fsdp`` mesh every
  rank computes distinct examples and the parameters are sharded over
  ``fsdp`` (FSDP2's HSDP when both axes are > 1);
* ``model`` (tensor parallelism) and ``spatial`` (spatial partitioning)
  carry no batch rows: every rank of a ``model`` group computes its slice
  of the output channels of every conv (`tp_sharding_for`,
  `parallel/tensor_parallel.py`), every rank of a ``spatial`` group its
  rows of every feature map (`row_bounds`, `parallel/spatial.py`), for
  the whole batch of its ``data`` shard (`data_shard`).

One axis beside ``data`` at a time.  The pipeline axis is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from objectdetection_ssd_torch.parallel import distributed

# The axes of a mesh that carry batch rows, in mesh order.
BATCH_AXES = ("data", "fsdp")
# The axes that partition each example's work instead (tensor and spatial
# parallelism).
SECONDARY_AXES = ("model", "spatial")


def mesh_layout(mesh_shape: Optional[Tuple[int, ...]],
                axis_names: Sequence[str], n: int
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of a mesh over ``n`` processes, checked;
    the default shape puts them all on the first axis."""
    axis_names = tuple(axis_names)
    for name in axis_names:
        if name not in BATCH_AXES + SECONDARY_AXES:
            raise ValueError(f"mesh axis {name!r} is not ported (only "
                             f"{', '.join(BATCH_AXES + SECONDARY_AXES)})")
    if len([a for a in axis_names if a != "data"]) > 1:
        raise ValueError(f"mesh axes {axis_names}: one axis beside 'data' "
                         "at a time")
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh shape {mesh_shape} does not match the axes "
                         f"{axis_names}")
    size = 1
    for s in mesh_shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh shape {mesh_shape} holds {size} devices; "
                         f"the job has {n} processes")
    return mesh_shape, axis_names


def create_mesh(mesh_shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",),
                device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every process of the initialized process group; the
    default puts them all on the first axis (``data``)."""
    mesh_shape, axis_names = mesh_layout(mesh_shape, axis_names,
                                         distributed.process_count())
    override = None
    if device_type == "cuda" and dist.get_backend() == "gloo":
        # DeviceMesh gives the groups of a gloo job NCCL for CUDA tensors;
        # keep them on gloo, whose ranks may share a card.
        override = {name: "gloo" for name in axis_names}
    return init_device_mesh(device_type, mesh_shape,
                            mesh_dim_names=axis_names,
                            backend_override=override)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The non-trivial mesh axes that the batch's leading dim shards over
    (``data`` and ``fsdp``)."""
    return tuple(a for a in BATCH_AXES if axis_size(mesh, a) > 1)


def secondary_axis(mesh: DeviceMesh) -> Optional[str]:
    """``model`` or ``spatial`` when the mesh partitions each example over
    that axis (size > 1), else None."""
    for a in SECONDARY_AXES:
        if axis_size(mesh, a) > 1:
            return a
    return None


def data_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(index, count)``: this rank's coordinate on the batch axes and
    their size — the ``shard`` of its Loader and the ``shard`` of its
    dropout masks.  Every rank of one ``model`` or ``spatial`` group has
    the same index: it reads the same rows."""
    names = mesh.mesh_dim_names or ()
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for i, name in enumerate(names):
        if name in BATCH_AXES:
            index = index * mesh.size(i) + coord[i]
            count *= mesh.size(i)
    return index, count


def spatial_ways(mesh: DeviceMesh) -> int:
    """Size of the ``spatial`` axis (1 when absent): the number of row
    slices each feature map is cut into."""
    return axis_size(mesh, "spatial")


def row_bounds(height: int, ways: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of a map of ``height`` rows that rank
    ``index`` of a ``spatial`` axis of ``ways`` owns — the port's
    `image_sharding`.  ``floor(index * height / ways)`` to
    ``floor((index + 1) * height / ways)``: the even split of JAX's
    image sharding where ``ways`` divides ``height`` (the input image), and
    for every other map a split whose slices differ by at most one row
    (a rank may own none of a map with fewer rows than ranks)."""
    return index * height // ways, (index + 1) * height // ways


def local_batch_size(global_batch_size: int, mesh: DeviceMesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= axis_size(mesh, a)
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"batch mesh axes {batch_axes(mesh)} (total {n} ways)")
    return global_batch_size // n


def fsdp_sharding_for(x: torch.Tensor, mesh: DeviceMesh,
                      axis: str = "fsdp"):
    """The FSDP placement of one parameter: `Shard` of its largest dim
    that the ``axis`` size divides (the first such dim on a tie), or
    `Replicate` when none does or the axis is trivial (JAX
    `fsdp_sharding_for`).  FSDP2's ``fully_shard`` takes the `Shard`s as
    its ``shard_placement_fn``, and shards a `Replicate` one unevenly on
    dim 0 (`parallel/data_parallel.py`)."""
    n = axis_size(mesh, axis)
    dims = list(x.shape)
    if n == 1 or not dims:
        return Replicate()
    order = sorted(range(len(dims)), key=lambda i: dims[i], reverse=True)
    for i in order:
        if dims[i] % n == 0 and dims[i] >= n:
            return Shard(i)
    return Replicate()


def tp_sharding_for(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "model"):
    """The tensor-parallel placement of one parameter or per-channel
    buffer: `Shard` of its output-channel dim — dim 0 of an OIHW conv
    weight and of a per-channel vector (bias, BatchNorm scale and
    statistics, L2Norm scale) — when the ``axis`` size divides it, else
    `Replicate` (scalars; widths such as SSD300's 126-wide conf heads at
    ``model`` = 4 or ResNet-34's 189-wide ones at any even size).  JAX
    `tp_sharding_for` shards the same dim, the last of its HWIO kernels."""
    n = axis_size(mesh, axis)
    if n == 1 or x.dim() == 0 or x.shape[0] % n or x.shape[0] < n:
        return Replicate()
    return Shard(0)


def state_tp_shardings(tensors, mesh: DeviceMesh,
                       axis: str = "model") -> dict:
    """`tp_sharding_for` of every entry of a name -> tensor map (a state
    dict, an EMA)."""
    return {k: tp_sharding_for(v, mesh, axis) for k, v in tensors.items()}

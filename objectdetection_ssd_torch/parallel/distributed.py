"""Multi-process entry point — the port of
`objectdetection_ssd_tpu/parallel/distributed.py`.

One process runs per card.  `initialize()` reads the environment that
``torchrun`` (or any launcher) sets and joins the process group: NCCL for
``cuda``, gloo for ``cpu``; each rank binds to ``cuda:LOCAL_RANK``.  With
no such environment it does nothing, so the same ``cli train`` runs
unchanged on one card or on many:

    torchrun --nproc-per-node 4 -m objectdetection_ssd_torch.cli train ...

`process_index`, `process_count`, `is_primary`, `local_shard_bounds` and
`create_global_mesh` answer for a single process (0, 1, True, the whole
batch, a one-rank mesh) when no process group is up.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from objectdetection_ssd_torch.device import DeviceLike, resolve_device

# torchrun's variables; a launch sets all of them.
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize(device: DeviceLike = None) -> torch.device:
    """Join the process group that the environment describes and return
    this rank's device (``cuda:LOCAL_RANK`` for a ``cuda`` device).

    No variable of `ENV_VARS` set: a single process, nothing to join; the
    device is ``device`` resolved.  Some set but not all: ValueError — a
    half-configured rank must not train on the whole dataset next to the
    real job while the others wait in rendezvous (JAX
    `distributed.py:55-64`).  Calling it again in a joined process returns
    the device and joins nothing."""
    dev = resolve_device(device)
    env = os.environ
    present = [k for k in ENV_VARS if env.get(k)]
    if not present:
        return dev
    if len(present) != len(ENV_VARS):
        missing = [k for k in ENV_VARS if k not in present]
        raise ValueError(
            f"{', '.join(present)} set but {', '.join(missing)} not: set "
            "all of RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
            "MASTER_PORT (as torchrun does), or none for one process")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", rank=int(env["RANK"]),
            world_size=int(env["WORLD_SIZE"]),
            device_id=dev if dev.type == "cuda" else None)
    return dev


def create_global_mesh(axis_names: Tuple[str, ...] = ("data",),
                       mesh_shape: Optional[Tuple[int, ...]] = None,
                       device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every process of the job (JAX: every process's chips):
    `parallel.mesh.create_mesh` over the ranks of the process group.  With
    no group up, the one process alone: a one-rank mesh of the same axes,
    with no process groups behind it, since there is no other rank to talk
    to."""
    from objectdetection_ssd_torch.parallel import mesh as mesh_lib

    if dist.is_initialized():
        return mesh_lib.create_mesh(mesh_shape, axis_names, device_type)
    shape, names = mesh_lib.mesh_layout(mesh_shape, axis_names, 1)
    return DeviceMesh(device_type, torch.zeros(shape, dtype=torch.int),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and reports."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (a no-op on one)."""
    if dist.is_initialized():
        dist.barrier()


def local_shard_bounds(global_batch: int) -> Tuple[int, int]:
    """``[start, end)`` rows of the global batch this process owns."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    i = process_index()
    return i * per, (i + 1) * per

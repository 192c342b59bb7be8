"""Per-epoch checkpoints with resume and retention — the port of
`objectdetection_ssd_tpu/train/checkpoint.py` (orbax there, `torch.save`
here).

One directory per epoch under the checkpoint root, ``<root>/<epoch>/``,
holding ``state.pt`` (the step, the model's state_dict, the optimizer's
(momentum), the scheduler's, the accumulation window and the EMA weights
when EMA is on) and ``metadata.json`` (``history``, ``emergency``).  A save
writes a temporary directory and renames it into place, so a crash never
leaves a half-written epoch behind; the oldest epochs past
``max_to_keep`` are then removed.  Saves are synchronous: ``wait`` exists
for the JAX package's interface and returns at once.

A restore takes the schedule's position from the checkpoint (the update
count, the momentum buffers) and its hyperparameters from the live state,
as the JAX package's does: there optax's count is state and the learning
rate, warm-up, decay, momentum and weight decay come from the config the
run was started with, so a resume with another ``--lr`` (a QAT fine-tune)
trains at that rate.

Under a mesh every rank calls `save` and `restore`.  A save gathers FSDP2
and tensor-parallel shards into whole tensors (the single-device format, so
`Detector.from_checkpoint` and a resume at any world size read it), the
primary writes, and the ranks meet at a barrier; a restore lays each
tensor out as the state holds it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from objectdetection_ssd_torch.parallel import distributed
from objectdetection_ssd_torch.parallel.data_parallel import (
    full_state_dict, full_tensor, shard_like)
from objectdetection_ssd_torch.train.state import TrainState

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def epochs(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit()
                      and os.path.exists(os.path.join(self._dir, n,
                                                      STATE_FILE)))

    def close(self) -> None:
        """Nothing to release: every save and load opens and closes its
        own files.  JAX's manager holds an async writer here; safe to call
        any number of times."""

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState,
             metadata: Optional[Dict[str, Any]] = None,
             barrier: bool = True) -> None:
        """Save ``state`` as ``epoch`` (the reference saves every epoch,
        `train_function.py:114-120`).  Under a mesh: collective, the
        primary writes; ``barrier=False`` skips the closing barrier (the
        emergency save of a failed run, whose other ranks may never
        come)."""
        optimizer = state.optimizer.state_dict()
        optimizer["state"] = {i: full_state_dict(v)
                              for i, v in optimizer["state"].items()}
        payload = {
            "step": state.step,
            "model": full_state_dict(state.model.state_dict()),
            "optimizer": optimizer,
            "scheduler": state.scheduler.state_dict(),
            "mini_step": state.mini_step,
            "acc_grads": (None if state.acc_grads is None
                          else [full_tensor(t) for t in state.acc_grads]),
            "ema": (None if state.ema is None
                    else full_state_dict(state.ema)),
        }
        if distributed.is_primary():
            self._write(epoch, payload, metadata)
        if barrier:
            distributed.barrier()

    def _write(self, epoch: int, payload: Dict[str, Any],
               metadata: Optional[Dict[str, Any]]) -> None:
        final = os.path.join(self._dir, str(epoch))
        tmp = os.path.join(self._dir, f".tmp-{epoch}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                json.dump(metadata or {}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if self.max_to_keep > 0:
            for old in self.epochs()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def load(self, epoch: Optional[int] = None
             ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        """(payload on the CPU, metadata, epoch) of ``epoch`` (default the
        latest); FileNotFoundError if there is none."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        path = os.path.join(self._dir, str(epoch))
        payload = torch.load(os.path.join(path, STATE_FILE),
                             map_location="cpu", weights_only=True)
        meta_path = os.path.join(path, METADATA_FILE)
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return payload, meta, epoch

    def restore(self, state: TrainState, epoch: Optional[int] = None
                ) -> Tuple[TrainState, Dict[str, Any], int]:
        """Load ``epoch`` (default the latest) into ``state`` in place, on
        its device; returns (state, metadata, epoch)."""
        payload, meta, epoch = self.load(epoch)
        live = state.model.state_dict()
        state.model.load_state_dict(
            {k: shard_like(v, live[k]) if k in live else v
             for k, v in payload["model"].items()}, strict=True)
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        optimizer = payload["optimizer"]
        optimizer["state"] = {
            i: {k: shard_like(v, params[int(i)])
                if isinstance(v, torch.Tensor) and v.dim() else v
                for k, v in entry.items()}
            for i, entry in optimizer["state"].items()}
        # The hyperparameters are the live config's (JAX builds its optax
        # chain from the config, and restores only the count and traces).
        live = [{k: v for k, v in g.items() if k != "params"}
                for g in state.optimizer.param_groups]
        base_lrs = list(state.scheduler.base_lrs)
        state.optimizer.load_state_dict(optimizer)
        state.scheduler.load_state_dict(payload["scheduler"])
        state.scheduler.base_lrs = base_lrs
        sched = state.scheduler
        for group, hyper, base, factor in zip(
                state.optimizer.param_groups, live, base_lrs,
                sched.lr_lambdas):
            group.update(hyper, lr=base * factor(sched.last_epoch))
        sched._last_lr = [g["lr"] for g in state.optimizer.param_groups]
        state.step = int(payload["step"])
        state.mini_step = int(payload["mini_step"])
        acc = payload["acc_grads"]
        state.acc_grads = (None if acc is None else
                           [shard_like(t, p) for t, p in zip(acc, params)])
        ema = payload["ema"]
        if (ema is None) != (state.ema is None):
            raise ValueError(
                "checkpoint and state disagree on EMA: pass the "
                "--ema-decay the checkpoint was trained with")
        if ema is not None:
            state.ema = {n: shard_like(t, state.ema[n])
                         for n, t in ema.items()}
        return state, meta, epoch

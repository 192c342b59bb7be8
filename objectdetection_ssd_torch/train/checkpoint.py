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

A restore does not reset the learning rate (the reference overrides it on
resume, `train_function.py:29-30`): the schedule is part of the state.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

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

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState,
             metadata: Optional[Dict[str, Any]] = None) -> None:
        """Save ``state`` as ``epoch`` (the reference saves every epoch,
        `train_function.py:114-120`)."""
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "mini_step": state.mini_step,
            "acc_grads": state.acc_grads,
            "ema": state.ema,
        }
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
        device = next(state.model.parameters()).device
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = int(payload["step"])
        state.mini_step = int(payload["mini_step"])
        acc = payload["acc_grads"]
        state.acc_grads = (None if acc is None
                           else [t.to(device) for t in acc])
        ema = payload["ema"]
        if (ema is None) != (state.ema is None):
            raise ValueError(
                "checkpoint and state disagree on EMA: pass the "
                "--ema-decay the checkpoint was trained with")
        if ema is not None:
            state.ema = {n: t.to(device) for n, t in ema.items()}
        return state, meta, epoch

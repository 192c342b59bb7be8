"""High-level Trainer: epochs, train/eval phases, checkpointing, resume —
the port of `objectdetection_ssd_tpu/train/trainer.py:Trainer` for one
device (the mesh, pipeline-parallel and TensorBoard branches are not
ported).  `enable_qat` turns on quantization-aware training.

Per epoch: a train phase, then a loss-only eval ('test') phase over the
held-out split, each phase's loss averaged over its images; a checkpoint
every ``checkpoint_every_epochs``; an optional ``epoch_callback`` (the
CLI's periodic mAP).  An exception writes an emergency checkpoint and is
re-raised, so `maybe_resume` continues the run.

The input stream of a phase: the Loader's host batches on a prefetch
thread, each padded to the batch size (the eval tail; padded images carry
an all-false mask, so the loss is the loss over the real images) and
copied to the card from pinned memory.  With
`TrainConfig.device_prefetch` the copy runs on a second thread, on its own
CUDA stream; the step waits for the copy's event and marks the tensors as
used on its stream (``record_stream``).  The numbers are the same either
way.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from objectdetection_ssd_torch.config import Config
from objectdetection_ssd_torch.data.pipeline import Loader, prefetch
from objectdetection_ssd_torch.device import DeviceLike, resolve_device
from objectdetection_ssd_torch.models.convert import merge_state_dict
from objectdetection_ssd_torch.ops import priors as priors_lib
from objectdetection_ssd_torch.train import loop as loop_lib
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
from objectdetection_ssd_torch.train.state import (TrainState,
                                                   create_train_state)
from objectdetection_ssd_torch.utils.metrics import (MetricsLogger, logger,
                                                     setup_logging)


class Trainer:
    def __init__(self, config: Config, train_loader: Loader,
                 eval_loader: Optional[Loader] = None,
                 epoch_callback: Optional[Callable[[int, "Trainer"], None]]
                 = None,
                 model: Optional[nn.Module] = None, priors=None,
                 device: DeviceLike = None,
                 init_state_dict: Optional[Mapping[str, torch.Tensor]]
                 = None):
        """``model`` / ``priors``: override the registry model and its
        prior set (tests, custom architectures).  ``device`` defaults to
        ``cuda``; the weights are drawn from ``config.train.seed``.

        ``init_state_dict``: converted weights and BN statistics (the
        ``--init-*`` loaders, `models/convert.py`) laid over the random
        init by `merge_state_dict`; the EMA, when on, then starts from the
        merged weights, not the random ones."""
        setup_logging()
        self.config = config
        self.device = resolve_device(device)
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.epoch_callback = epoch_callback
        # The schedule's epoch clock counts real optimizer updates.
        accum = max(config.optim.grad_accum_steps, 1)
        steps_per_epoch = max(-(-len(train_loader) // accum), 1)
        self.state: TrainState = create_train_state(
            config.model, config.optim, device=self.device,
            generator=torch.Generator().manual_seed(config.train.seed),
            steps_per_epoch=steps_per_epoch,
            model=model.to(self.device) if model is not None else None,
            ema=config.train.ema_decay > 0)
        if init_state_dict is not None:
            net = self.state.model
            net.load_state_dict(merge_state_dict(net.state_dict(),
                                                 init_state_dict))
            if self.state.ema is not None:
                self.state.ema = {n: p.detach().clone()
                                  for n, p in net.named_parameters()}
        if priors is None:
            priors = priors_lib.priors_for_model(config.model, config.priors)
        self.priors = torch.tensor(np.asarray(priors), dtype=torch.float32,
                                   device=self.device)
        self.ckpt = CheckpointManager(
            config.train.checkpoint_dir,
            max_to_keep=config.train.max_checkpoints_to_keep)
        self.start_epoch = 0
        self.history: Dict[str, List[float]] = {"train": [], "test": []}
        # Per phase, the last run's images, steps, wall seconds and the
        # seconds the loop waited on its input stream.
        self.phase_stats: Dict[str, Dict[str, float]] = {}
        # QAT's scale tree on the device (`enable_qat`), or None.
        self.quant_ste: Optional[Dict] = None

    def enable_qat(self, qtree: Mapping) -> None:
        """Train and evaluate from now on through the straight-through
        fake-quant convs of ``qtree`` (`infer.quant.act_scales`), so that
        the fine-tuned weights serve int8 with the same scales.  Calibrate
        after any init or resume: the scales must describe the weights
        being fine-tuned (`cli train --qat` keeps that order)."""
        from objectdetection_ssd_torch.infer.quant import scales_to
        self.quant_ste = scales_to(qtree, self.device)

    def maybe_resume(self) -> bool:
        """Resume from the latest checkpoint if one exists (reference
        ``loadModel=True``, `train_function.py:25-34`)."""
        if self.ckpt.latest_epoch() is None:
            return False
        self.state, meta, epoch = self.ckpt.restore(self.state)
        self.start_epoch = epoch + 1
        self.history = meta.get("history", self.history)
        logger.info("resumed from epoch %d", epoch)
        return True

    def _to_device(self, host_iter: Iterator, batch_size: int,
                   side: Optional["torch.cuda.Stream"]) -> Iterator:
        """(real rows, batch on the card, copy event or None) per host
        batch, padded to ``batch_size``."""
        for batch in host_iter:
            n = int(batch["images"].shape[0])
            arrays = {k: v for k, v in batch.items() if k != "image_ids"}
            if n < batch_size:
                arrays = {k: np.concatenate(
                    [v, np.zeros((batch_size - n,) + v.shape[1:], v.dtype)])
                    for k, v in arrays.items()}
            tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
            if self.device.type != "cuda":
                yield n, tensors, None
                continue
            if side is None:
                yield n, {k: t.pin_memory().to(self.device, non_blocking=True)
                          for k, t in tensors.items()}, None
                continue
            with torch.cuda.stream(side):
                out = {k: t.pin_memory().to(self.device, non_blocking=True)
                       for k, t in tensors.items()}
                ready = torch.cuda.Event()
                ready.record(side)
            yield n, out, ready

    def _run_phase(self, epoch: int, train: bool) -> float:
        loader = self.train_loader if train else self.eval_loader
        phase = "train" if train else "test"
        cfg = self.config
        mlog = MetricsLogger(cfg.train.log_every_steps, prefix=phase)
        two_stage = cfg.train.device_prefetch
        side = (torch.cuda.Stream(self.device)
                if two_stage and self.device.type == "cuda" else None)
        stream = self._to_device(prefetch(loader.epoch(epoch)),
                                 loader.config.batch_size, side)
        if two_stage:
            stream = prefetch(stream)
        n_images = steps = 0
        waited = 0.0
        t0 = time.perf_counter()
        while True:
            t_wait = time.perf_counter()
            item = next(stream, None)
            waited += time.perf_counter() - t_wait
            if item is None:
                break
            n, batch, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(ready)
                for t in batch.values():
                    t.record_stream(current)
            if train:
                self.state, metrics = loop_lib.train_step(
                    self.state, batch, self.priors, cfg.loss,
                    ema_decay=cfg.train.ema_decay, seed=cfg.train.seed,
                    remat=cfg.train.remat, quant_ste=self.quant_ste)
            else:
                metrics = loop_lib.eval_step(self.state, batch, self.priors,
                                             cfg.loss,
                                             quant_ste=self.quant_ste)
            # Metrics stay on the device; MetricsLogger reads them on its
            # log cadence and at the end of the phase.
            mlog.update(metrics, n)
            n_images += n
            steps += 1
        if n_images == 0:
            logger.warning("epoch %d [%s] had no full batches "
                           "(%d records < batch size?)", epoch, phase,
                           len(loader.records))
            return float("nan")
        avg = mlog.summary()["loss"]
        self.phase_stats[phase] = {
            "images": n_images, "steps": steps,
            "seconds": time.perf_counter() - t0, "input_wait_s": waited}
        logger.info("epoch %d [%s] loss=%.4f", epoch, phase, avg)
        return avg

    def fit(self, num_epochs: Optional[int] = None) -> TrainState:
        """Run the epoch loop from ``start_epoch`` to ``num_epochs``.

        Any exception writes a best-effort emergency checkpoint under the
        failed epoch's index (unless that epoch was saved) before it is
        re-raised, so a crashed run resumes with `maybe_resume()`.
        """
        num_epochs = num_epochs or self.config.train.num_epochs
        every = self.config.train.checkpoint_every_epochs
        epoch = self.start_epoch
        try:
            for epoch in range(self.start_epoch, num_epochs):
                t0 = time.perf_counter()
                self.history["train"].append(
                    self._run_phase(epoch, train=True))
                if self.eval_loader is not None:
                    self.history["test"].append(
                        self._run_phase(epoch, train=False))
                if every and (epoch + 1) % every == 0:
                    self.ckpt.save(epoch, self.state,
                                   metadata={"history": self.history})
                if self.epoch_callback is not None:
                    self.epoch_callback(epoch, self)
                logger.info("epoch %d done in %.1fs", epoch,
                            time.perf_counter() - t0)
        except Exception:
            logger.exception(
                "training failed at epoch %d; writing emergency checkpoint",
                epoch)
            try:
                if self.ckpt.latest_epoch() != epoch:
                    self.ckpt.save(epoch, self.state,
                                   metadata={"history": self.history,
                                             "emergency": True})
            except Exception:
                logger.exception("emergency checkpoint failed")
            raise
        return self.state

"""High-level Trainer: epochs, train/eval phases, checkpointing, resume —
the port of `objectdetection_ssd_tpu/train/trainer.py:Trainer`.
`enable_qat` turns on quantization-aware training.

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

Under a process group (`parallel.distributed.initialize`, one process per
card) the Trainer builds a mesh from `TrainConfig.mesh_shape` /
``mesh_axis_names`` and trains the global batch on it
(`parallel/data_parallel.py`: DDP, FSDP2 with an ``fsdp`` axis, tensor
parallelism with a ``model`` axis, spatial partitioning with a
``spatial`` one, JAX `trainer.py:96-99`, `:147-168`); each Loader must
then be built with ``shard=parallel.mesh.data_shard(mesh)``: every rank of
one ``model`` or ``spatial`` group reads the same rows.  Checkpoints,
TensorBoard and the log lines come from the primary only.

With ``TrainConfig.pp_stages`` = N > 1 (``train --pp N``, JAX
`trainer.py:59-90`) one process drives N pipeline stages on N devices
(times ``pp_dp``; `parallel/pipeline.py`) through `train/loop.py:
make_pp_steps`; the stages are the monolith's modules, so checkpoints stay
monolithic and resume with or without ``--pp``.  It refuses a mesh, a
process group, too few devices, a batch that the microbatches do not
divide, microbatch rows that ``pp_dp`` does not divide, and QAT.
"""

from __future__ import annotations

import logging
import time
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from objectdetection_ssd_torch.config import Config
from objectdetection_ssd_torch.data.pipeline import Loader, prefetch
from objectdetection_ssd_torch.device import DeviceLike, resolve_device
from objectdetection_ssd_torch.models.convert import merge_state_dict
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops import priors as priors_lib
from objectdetection_ssd_torch.parallel import distributed
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.train import loop as loop_lib
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
from objectdetection_ssd_torch.train.state import (TrainState,
                                                   create_train_state)
from objectdetection_ssd_torch.utils.metrics import (MetricsLogger,
                                                     TensorBoardWriter,
                                                     logger, profiler_trace,
                                                     setup_logging)


class Trainer:
    def __init__(self, config: Config, train_loader: Loader,
                 eval_loader: Optional[Loader] = None,
                 epoch_callback: Optional[Callable[[int, "Trainer"], None]]
                 = None,
                 model: Optional[nn.Module] = None, priors=None,
                 init_state_dict: Optional[Mapping[str, torch.Tensor]]
                 = None,
                 pp_build: Optional[Callable] = None,
                 device: DeviceLike = None,
                 pp_devices: Optional[Sequence[DeviceLike]] = None):
        """``model`` / ``priors``: override the registry model and its
        prior set (tests, custom architectures).  ``device`` defaults to
        ``cuda`` (``cuda:LOCAL_RANK`` under a process group); the weights
        are drawn from ``config.train.seed``, alike on every rank.

        ``init_state_dict``: converted weights and BN statistics (the
        ``--init-*`` loaders, `models/convert.py`) laid over the random
        init by `merge_state_dict`; the EMA, when on, then starts from the
        merged weights, not the random ones.

        Under a process group the mesh is built from the config
        (``mesh_shape``, ``mesh_axis_names``); without one there is no
        mesh and no wrapper.

        Pipeline parallelism (``config.train.pp_stages`` > 1):
        ``pp_devices`` are the stages' devices, ``pp_stages * pp_dp`` of
        them (`parallel/pipeline.py:PipelineRunner`), by default the first
        CUDA cards, or the CPU for every stage with ``device="cpu"``; too
        few cards raise.  ``pp_build``: the stage builder, ``(model,
        num_stages, devices, microbatches, dp) -> PipelineRunner``
        (default `parallel.pipeline.build_pipeline_for`, SSD300), whose
        stages must be ``model``'s own modules."""
        self.n_proc = distributed.process_count()
        setup_logging(logging.INFO if distributed.is_primary()
                      else logging.WARNING)
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dist.is_initialized():
            self.device = torch.device("cuda", torch.cuda.current_device())
        pp = config.train.pp_stages
        if pp > 1:
            pp_devices = self._pp_devices(config, pp_devices, self.device)
            self.device = pp_devices[0]
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.epoch_callback = epoch_callback
        mesh = None
        if dist.is_initialized():
            mesh = mesh_lib.create_mesh(config.train.mesh_shape,
                                        config.train.mesh_axis_names,
                                        device_type=self.device.type)
        self.mesh = mesh
        # Fail fast on a batch the mesh cannot split, an image the spatial
        # axis cannot, and on a Loader that would feed rows this process
        # does not own (JAX `trainer.py:96-106`).
        self.data_shard = (0, 1)
        if mesh is not None:
            mesh_lib.local_batch_size(config.data.batch_size, mesh)
            sp = mesh_lib.spatial_ways(mesh)
            if config.model.image_size % sp:
                raise ValueError(
                    f"image_size {config.model.image_size} not divisible by "
                    f"the spatial mesh axis ({sp} ways)")
            self.data_shard = mesh_lib.data_shard(mesh)
        if self.n_proc > 1:
            want = self.data_shard
            for name, ld in (("train", train_loader), ("eval", eval_loader)):
                if ld is not None and getattr(ld, "shard", None) != want:
                    raise ValueError(
                        f"{name}_loader must be built with shard={want} "
                        f"when running {self.n_proc} processes on the mesh "
                        "(see data/pipeline.py:Loader)")
        # The schedule's epoch clock counts real optimizer updates.
        accum = max(config.optim.grad_accum_steps, 1)
        steps_per_epoch = max(-(-len(train_loader) // accum), 1)
        if model is None:
            model = build_model(
                config.model, device=self.device, train=True,
                generator=torch.Generator().manual_seed(config.train.seed))
        model = model.to(self.device)
        if init_state_dict is not None:
            model.load_state_dict(merge_state_dict(model.state_dict(),
                                                   init_state_dict))
        self.state: TrainState = create_train_state(
            config.model, config.optim, device=self.device, model=model,
            steps_per_epoch=steps_per_epoch,
            ema=config.train.ema_decay > 0, mesh=mesh)
        if priors is None:
            priors = priors_lib.priors_for_model(config.model, config.priors)
        self.priors = torch.tensor(np.asarray(priors), dtype=torch.float32,
                                   device=self.device)
        self.pp_runner = None
        self._steps = None
        if pp > 1:
            from objectdetection_ssd_torch.parallel import pipeline
            build = pp_build or pipeline.build_pipeline_for
            self.pp_runner = build(model, pp, pp_devices,
                                   max(config.train.pp_microbatches, 1),
                                   max(config.train.pp_dp, 1))
            # The stages moved the parameters to their devices; the EMA
            # follows them.
            if self.state.ema is not None:
                params = dict(model.named_parameters())
                self.state.ema = {n: e.to(params[n].device)
                                  for n, e in self.state.ema.items()}
            self._steps = loop_lib.make_pp_steps(
                self.pp_runner, self.priors, config.loss,
                ema_decay=config.train.ema_decay)
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
        self.tb = None
        if config.train.tensorboard_dir and distributed.is_primary():
            self.tb = TensorBoardWriter(config.train.tensorboard_dir)

    @staticmethod
    def _pp_devices(config: Config, devices: Optional[Sequence[DeviceLike]],
                    device: torch.device) -> List[torch.device]:
        """The pipeline's ``pp_stages * pp_dp`` devices (default: the first
        CUDA cards, or the CPU for every stage when ``device`` is the CPU),
        after JAX's refusals (`trainer.py:59-90`)."""
        from objectdetection_ssd_torch.parallel.pipeline import (
            SINGLE_CONTROLLER)
        if config.train.mesh_shape is not None:
            raise ValueError(
                "--pp provides its own device placement; do not pass a "
                "mesh (fsdp/tp/sp and pp are mutually exclusive)")
        if dist.is_initialized():
            raise ValueError(SINGLE_CONTROLLER)
        pp = config.train.pp_stages
        dp = max(config.train.pp_dp, 1)
        if devices is None:
            devices = ([device] * (pp * dp) if device.type == "cpu" else
                       [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())])
        devs = [torch.device(d) for d in devices]
        if len(devs) < pp * dp:
            raise ValueError(f"--pp {pp} x --pp-dp {dp} needs {pp * dp} "
                             f"devices; {len(devs)} available")
        mb = max(config.train.pp_microbatches, 1)
        if config.data.batch_size % mb:
            raise ValueError(
                f"batch size {config.data.batch_size} not divisible by "
                f"--pp-microbatches {mb}")
        if (config.data.batch_size // mb) % dp:
            raise ValueError(
                f"microbatch rows {config.data.batch_size // mb} not "
                f"divisible by --pp-dp {dp}")
        return devs[:pp * dp]

    def enable_qat(self, quant_ste: Mapping) -> None:
        """Train and evaluate from now on through the straight-through
        fake-quant convs of the scale tree ``quant_ste``
        (`infer.quant.act_scales`), so that the fine-tuned weights serve
        int8 with the same scales.  Calibrate
        after any init or resume: the scales must describe the weights
        being fine-tuned (`cli train --qat` keeps that order).  Refused
        under ``--pp``: the stages have no fake-quant path."""
        from objectdetection_ssd_torch.infer.quant import scales_to
        if self.pp_runner is not None:
            raise ValueError(
                "--qat does not compose with --pp (the staged programs "
                "have no fake-quant path); QAT-train on the data, FSDP, "
                "tensor or spatial strategies, then serve the checkpoint "
                "however you like")
        self.quant_ste = scales_to(quant_ste, self.device)

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
        """(real rows of the global batch, this process's rows on the
        card, copy event or None) per host batch, padded to
        ``batch_size``."""
        for batch in host_iter:
            n = int(batch["images"].shape[0])
            n_global = int(batch.get("global_size", n))
            arrays = {k: v for k, v in batch.items()
                      if k not in ("image_ids", "global_size")}
            if n < batch_size:
                arrays = {k: np.concatenate(
                    [v, np.zeros((batch_size - n,) + v.shape[1:], v.dtype)])
                    for k, v in arrays.items()}
            tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
            if self.device.type != "cuda":
                yield n_global, tensors, None
                continue
            if side is None:
                yield n_global, {
                    k: t.pin_memory().to(self.device, non_blocking=True)
                    for k, t in tensors.items()}, None
                continue
            with torch.cuda.stream(side):
                out = {k: t.pin_memory().to(self.device, non_blocking=True)
                       for k, t in tensors.items()}
                ready = torch.cuda.Event()
                ready.record(side)
            yield n_global, out, ready

    def _run_phase(self, epoch: int, train: bool) -> float:
        loader = self.train_loader if train else self.eval_loader
        phase = "train" if train else "test"
        cfg = self.config
        on_log = None
        if self.tb is not None:
            base = epoch * max(len(loader), 1)
            on_log = lambda step, scalars: self.tb.scalars(  # noqa: E731
                phase, base + step, scalars)
        mlog = MetricsLogger(cfg.train.log_every_steps, prefix=phase,
                             on_log=on_log)
        two_stage = cfg.train.device_prefetch
        side = (torch.cuda.Stream(self.device)
                if two_stage and self.device.type == "cuda" else None)
        stream = self._to_device(prefetch(loader.epoch(epoch)),
                                 loader.config.batch_size
                                 // self.data_shard[1], side)
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
            if self._steps is not None:
                if train:
                    self.state, metrics = self._steps[0](self.state, batch)
                else:
                    metrics = self._steps[1](self.state, batch)
            elif train:
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
        if self.tb is not None:
            self.tb.scalars(f"epoch_{phase}", epoch, mlog.summary())
        return avg

    def fit(self, num_epochs: Optional[int] = None,
            profile_dir: Optional[str] = None) -> TrainState:
        """Run the epoch loop from ``start_epoch`` to ``num_epochs``.

        Any exception writes a best-effort emergency checkpoint under the
        failed epoch's index (unless that epoch was saved) before it is
        re-raised, so a crashed run resumes with `maybe_resume()`.  Under
        FSDP2 or tensor parallelism there is none: gathering the shards
        needs every rank.

        ``profile_dir``: a `torch.profiler` trace of the first epoch's
        train phase (`utils.metrics.profiler_trace`), one file per rank.
        """
        num_epochs = num_epochs or self.config.train.num_epochs
        every = self.config.train.checkpoint_every_epochs
        epoch = self.start_epoch
        try:
            for epoch in range(self.start_epoch, num_epochs):
                t0 = time.perf_counter()
                with profiler_trace(profile_dir if epoch == self.start_epoch
                                    else None):
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
            parallel = self.state.parallel
            try:
                if (self.ckpt.latest_epoch() != epoch
                        and (parallel is None or not parallel.sharded)):
                    self.ckpt.save(epoch, self.state,
                                   metadata={"history": self.history,
                                             "emergency": True},
                                   barrier=False)
            except Exception:
                logger.exception("emergency checkpoint failed")
            raise
        finally:
            if self.tb is not None:
                self.tb.close()
        return self.state

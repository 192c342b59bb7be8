"""`train --pp` — the port's pipeline parallelism as a training surface
(`train/trainer.py`, `train/loop.py:make_pp_steps`, `cli.py`), on the CPU.

* The Trainer under PP (2 stages, M=1) on a small detector of the port's
  layers, through ``pp_build``, equals the monolithic Trainer epoch for
  epoch: losses and parameters to 1e-6 of the largest (the same ops in
  the same order, stage by stage).  Its checkpoints interchange both
  ways: a monolithic Trainer resumes the PP run's and a PP Trainer the
  monolithic run's, each then training on to the monolithic run's
  numbers.
* The Trainer's refusals carry JAX's messages (`tests/test_pp_trainer.py:
  226`, JAX `trainer.py:59-90`, `:198-203`): a batch the microbatches do
  not divide, microbatch rows ``pp_dp`` does not divide, too few devices,
  a mesh, a process group, QAT, too few cards (never a fallback).
* `cli train --pp 2 --pp-microbatches 2 --epochs 1 --device cpu` on a
  few-image synthetic VOC (8 images, written beforehand: ``--synthetic``
  writes 48, too many for full-width SSD300 on the CPU) writes a
  checkpoint that `cli eval --device cpu` reads.
* `--pp` beside `--fsdp`, `--tp`, `--sp` or `--qat`, and `--pp-dp` /
  `--pp-microbatches` without `--pp`, exit.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.train.trainer import Trainer as JTrainer
from objectdetection_ssd_torch import cli
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.data import synthetic, voc
from objectdetection_ssd_torch.data.pipeline import Loader
from objectdetection_ssd_torch.models.layers import TorchConv, flatten_head
from objectdetection_ssd_torch.models.ssd import normalize_uint8
from objectdetection_ssd_torch.parallel.pipeline import (SINGLE_CONTROLLER,
                                                         PipelineRunner)
from objectdetection_ssd_torch.train import trainer as trainer_lib
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
from objectdetection_ssd_torch.train.trainer import Trainer
from tests.tp_sp_ranks import tiny_priors

torch.set_num_threads(2)


class _Feat(nn.Module):
    """Stage 0: uint8 or normalized NHWC (B, 64, 64, 3) -> (B, 32, 4, 4)."""

    def __init__(self, gen):
        super().__init__()
        self.conv0 = TorchConv(3, 16, 5, stride=8, padding=2)     # 64 -> 8
        self.conv1 = TorchConv(16, 32, 3, stride=2, padding=1)    # 8 -> 4
        for m in (self.conv0, self.conv1):
            m.reset_parameters(gen)

    def forward(self, x):
        x = normalize_uint8(x).permute(0, 3, 1, 2)
        return torch.relu(self.conv1(torch.relu(self.conv0(x))))


class _Heads(nn.Module):
    """Stage 1: 16 priors (a 4 x 4 map, one anchor)."""

    def __init__(self, gen):
        super().__init__()
        self.loc = TorchConv(32, 4, 3, padding=1)
        self.conf = TorchConv(32, 21, 3, padding=1)
        for m in (self.loc, self.conf):
            m.reset_parameters(gen)

    def forward(self, h):
        return flatten_head(self.loc(h), 4), flatten_head(self.conf(h), 21)


class TinyPPDet(nn.Module):
    """The two stages as one model, the Trainer's model signature."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.feat, self.heads = _Feat(gen), _Heads(gen)

    def forward(self, x, generator=None, remat=False):
        return self.heads(self.feat(x))


def pp_build(model, num_stages, devices, microbatches, dp):
    assert num_stages == 2
    return PipelineRunner([model.feat, model.heads], devices, microbatches,
                          dp)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """16 records at 96 x 96: 12 train (3 batches of 4), 4 val."""
    root = tmp_path_factory.mktemp("voc")
    synthetic.generate_voc(str(root), num_2007=12, num_2012=4,
                           image_size=(96, 96), seed=7)
    return root


def _trainer(root, ckpt, pp=0, epochs=2, **kw):
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(image_size=64),
        data=tconfig.DataConfig(voc_root=str(root), batch_size=4,
                                num_workers=0, max_boxes=8),
        optim=tconfig.OptimConfig(lr=0.01, use_lr_schedule=False),
        train=tconfig.TrainConfig(num_epochs=epochs, seed=0,
                                  checkpoint_dir=str(ckpt),
                                  log_every_steps=0, pp_stages=pp,
                                  ema_decay=0.9))
    records = voc.load_records(str(root))
    train_ids, val_ids = voc.train_val_split(len(records), 1 / 4, seed=10)
    return Trainer(cfg, Loader([records[i] for i in train_ids], cfg.data, 64,
                               train=True, seed=0),
                   Loader([records[i] for i in val_ids], cfg.data, 64,
                          train=False, drop_last=False),
                   model=TinyPPDet(), priors=tiny_priors(), device="cpu",
                   pp_build=pp_build if pp else None, **kw)


def _params(trainer):
    return {n: p.detach().clone() for n, p in
            trainer.state.model.named_parameters()}


def _assert_params(got, want, tol=1e-6):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=tol * w.abs().max().item(),
                                   err_msg=name)


def test_pp_trainer_equals_monolith_and_checkpoints_interchange(voc_root,
                                                                tmp_path):
    mono = _trainer(voc_root, tmp_path / "mono")
    mono.fit()
    want, want_ema = _params(mono), dict(mono.state.ema)
    epoch0 = CheckpointManager(str(tmp_path / "mono")).load(0)[0]["model"]

    pp = _trainer(voc_root, tmp_path / "pp", pp=2, epochs=1)
    assert pp.pp_runner is not None and pp._steps is not None
    pp.fit()
    assert pp.state.step == 3
    for phase in ("train", "test"):
        np.testing.assert_allclose(pp.history[phase],
                                   mono.history[phase][:1], rtol=1e-6,
                                   err_msg=phase)
    _assert_params(_params(pp), epoch0)

    # The PP run's checkpoint resumes monolithically and trains on to the
    # monolithic run's numbers.
    resumed = _trainer(voc_root, tmp_path / "pp")
    assert resumed.maybe_resume() and resumed.start_epoch == 1
    resumed.fit()
    np.testing.assert_allclose(resumed.history["train"],
                               mono.history["train"], rtol=1e-6)
    _assert_params(_params(resumed), want)
    _assert_params(resumed.state.ema, want_ema)

    # The monolithic run's epoch-0 checkpoint resumes under PP likewise.
    shutil.copytree(tmp_path / "mono", tmp_path / "mono0")
    shutil.rmtree(tmp_path / "mono0" / "1")
    resumed = _trainer(voc_root, tmp_path / "mono0", pp=2)
    assert resumed.maybe_resume() and resumed.start_epoch == 1
    resumed.fit()
    assert resumed.state.step == mono.state.step == 6
    np.testing.assert_allclose(resumed.history["test"],
                               mono.history["test"], rtol=1e-6)
    _assert_params(_params(resumed), want)
    _assert_params(resumed.state.ema, want_ema)


def _jax_refusal(**train):
    """JAX's Trainer refusal for ``train`` (batch 3 unless given)."""
    batch = train.pop("batch_size", 3)
    mesh = train.pop("mesh", None)
    cfg = jconfig.Config(data=jconfig.DataConfig(batch_size=batch,
                                                 num_workers=0),
                         train=jconfig.TrainConfig(seed=0, **train))
    with pytest.raises(ValueError) as err:
        JTrainer(cfg, train_loader=None, mesh=mesh)
    return str(err.value)


def _port_refusal(**kw):
    batch = kw.pop("batch_size", 3)
    devices = kw.pop("pp_devices", None)
    device = kw.pop("device", "cpu")
    cfg = tconfig.Config(data=tconfig.DataConfig(batch_size=batch,
                                                 num_workers=0),
                         train=tconfig.TrainConfig(seed=0, **kw))
    with pytest.raises(ValueError) as err:
        Trainer(cfg, train_loader=None, device=device, pp_devices=devices)
    return str(err.value)


def test_trainer_refusals_match_jax(monkeypatch, voc_root, tmp_path):
    assert _port_refusal(pp_stages=2, pp_microbatches=2) == _jax_refusal(
        pp_stages=2, pp_microbatches=2)
    assert "not divisible by --pp-microbatches 2" in _jax_refusal(
        pp_stages=2, pp_microbatches=2)
    assert _port_refusal(pp_stages=2, pp_microbatches=2, pp_dp=4,
                         batch_size=4) == _jax_refusal(
        pp_stages=2, pp_microbatches=2, pp_dp=4, batch_size=4)
    assert _port_refusal(pp_stages=99, pp_devices=["cpu"] * 8) == \
        _jax_refusal(pp_stages=99) == ("--pp 99 x --pp-dp 1 needs 99 "
                                       "devices; 8 available")
    assert _port_refusal(pp_stages=2, mesh_shape=(1,)) == _jax_refusal(
        pp_stages=2, mesh=object())
    with monkeypatch.context() as m:
        # A joined group of two, as `parallel/distributed.py` sees it.
        m.setattr(trainer_lib.dist, "is_initialized", lambda: True)
        m.setattr(trainer_lib.distributed, "process_count", lambda: 2)
        m.setattr(trainer_lib.distributed, "is_primary", lambda: True)
        assert _port_refusal(pp_stages=2) == SINGLE_CONTROLLER
    # No fallback to fewer cards or to the CPU.
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        assert _port_refusal(pp_stages=2, batch_size=4, device=None) == (
            "--pp 2 x --pp-dp 1 needs 2 devices; 1 available")
    pp = _trainer(voc_root, tmp_path / "qat", pp=2, epochs=1)
    with pytest.raises(ValueError, match="--qat does not compose with --pp"):
        pp.enable_qat({"feat": {"conv0": {"act_scale": 0.1}}})


def test_cli_train_pp_then_eval_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(4)
    synthetic.generate_voc("VOCdevkit", num_2007=6, num_2012=2, seed=3)
    common = ["--voc-root", "VOCdevkit", "--checkpoint-dir", "ckpt",
              "--device", "cpu", "--num-workers", "0", "--batch-size", "2"]
    assert cli.main(["train", "--pp", "2", "--pp-microbatches", "2",
                     "--epochs", "1"] + common) == 0
    assert sorted(os.listdir("ckpt")) == ["0"]
    capsys.readouterr()
    assert cli.main(["eval"] + common) == 0
    out, err = capsys.readouterr()
    assert "restored checkpoint epoch 0" in err
    lines = out.strip().splitlines()
    assert lines[-1].strip().startswith("mAP = ")
    assert 0.0 <= float(lines[-1].split("=")[1]) <= 1.0


@pytest.mark.parametrize("argv,msg", [
    (["--pp", "2", "--fsdp", "2"], "--fsdp and --pp are mutually exclusive"),
    (["--pp", "2", "--tp", "2"], "--tp and --pp are mutually exclusive"),
    (["--pp", "2", "--sp", "2"], "--sp and --pp are mutually exclusive"),
    (["--pp", "2", "--qat"], "--qat does not compose with --pp"),
    (["--pp-dp", "2"], "--pp-dp/--pp-microbatches require --pp N"),
    (["--pp-microbatches", "2"], "--pp-dp/--pp-microbatches require --pp N"),
])
def test_cli_pp_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(["train", "--device", "cpu"] + argv)

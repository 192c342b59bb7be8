"""Data-parallel and FSDP training and evaluation of the port, on the CPU
over gloo process groups (one spawned process per rank, rendezvous through
a file under ``tmp_path``), against the JAX package's global-batch step on
a mesh of the same shape over its virtual CPU devices.

* `Loader(shard=)` rows bit-equal to JAX's `Loader(shard=)`.
* `parallel.distributed.initialize`: no-op, torchrun and half-configured
  environments; `local_shard_bounds`.
* Two epochs of the TinyDet Trainer (`tests/test_torch_trainer.py`), f32,
  global batch 8, an 11-image eval split whose tail leaves whole ranks
  with padding only: at world size 2 (DDP, ``data`` = 2) and 4 (FSDP2 as
  HSDP, ``data x fsdp`` = 2 x 2, with an EMA of the weights and gradient
  accumulation over 2 micro-batches) against JAX's Trainer on the (2,)
  and (2, 2) meshes — per-epoch losses to 1e-4 relative and the weights to
  1e-4, the single-device gates of `test_torch_trainer.py` — and against
  the port's own single-process Trainer, losses to 1e-5 relative and
  weights to 1e-5.  FSDP2's leaves are laid out as `fsdp_sharding_for`
  says, a leaf it replicates sharded unevenly on dim 0.  The world-2 and world-4 checkpoints resume at world size 1, the
  world-2 one at world size 2.

The rank functions live here and in the other `test_torch_parallel_*`
files: the spawned ranks import the module of the function they run.
"""

import dataclasses
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from objectdetection_ssd_tpu.data import synthetic as jsynthetic
from objectdetection_ssd_tpu.data import voc as jvoc
from objectdetection_ssd_tpu.data.pipeline import Loader as JLoader
from objectdetection_ssd_tpu.parallel import mesh as jmesh
from objectdetection_ssd_tpu.train.trainer import Trainer as JTrainer
from objectdetection_ssd_torch.data import voc
from objectdetection_ssd_torch.data.pipeline import Loader
from objectdetection_ssd_torch.parallel import distributed
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.train.trainer import Trainer
from tests.test_torch_trainer import (JTinyDet, TTinyDet, _assert_params_match,
                                      _configs, _tiny_priors, _twin)
# The launcher, which the other `test_torch_parallel_*` files import from
# here too.
from tests.tp_sp_ranks import run_ranks


# ------------------------------------------------------------- fixtures


def _records(root):
    records = voc.load_records(str(root))
    train_ids, val_ids = voc.train_val_split(len(records), 1 / 3, seed=10)
    return ([records[i] for i in train_ids], [records[i] for i in val_ids])


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """34 records: 23 train (2 batches of 8), 11 val (a tail of 3)."""
    root = tmp_path_factory.mktemp("voc")
    jsynthetic.generate_voc(str(root), num_2007=28, num_2012=6,
                            image_size=(96, 96), seed=7)
    return root


def _variant(cfg, world):
    """The world-4 run's config: an EMA and gradient accumulation too."""
    if world != 4:
        return cfg
    return cfg.replace(
        optim=dataclasses.replace(cfg.optim, grad_accum_steps=2),
        train=dataclasses.replace(cfg.train, ema_decay=0.9))


def _ema_twin(ema):
    model = TTinyDet()
    model.load_state_dict(ema)
    return model


def _rank_trainer(rank, world, root, ckpt, weights, mesh_shape, axes, out):
    _, cfg = _configs(root, ckpt, mesh_shape=mesh_shape,
                      mesh_axis_names=axes)
    cfg = _variant(cfg, world)
    tr, va = _records(root)
    shard = (rank, world)
    loaders = (Loader(tr, cfg.data, 64, train=True, seed=0, shard=shard),
               Loader(va, cfg.data, 64, train=False, drop_last=False,
                      shard=shard))
    model = TTinyDet()
    model.load_state_dict(torch.load(weights))
    trainer = Trainer(cfg, *loaders, model=model, priors=_tiny_priors(),
                      device="cpu")
    try:
        Trainer(cfg, Loader(tr, cfg.data, 64), model=TTinyDet(),
                priors=_tiny_priors(), device="cpu")
        unsharded = "accepted"
    except ValueError as e:
        unsharded = str(e)
    placements = {}
    for name, p in trainer.state.model.named_parameters():
        full = p.full_tensor() if hasattr(p, "full_tensor") else p
        placements[name] = (repr(getattr(p, "placements", None)),
                            repr(mesh_lib.fsdp_sharding_for(full,
                                                            trainer.mesh)))
    trainer.fit()
    result = {"history": trainer.history, "step": trainer.state.step,
              "stats": trainer.phase_stats, "placements": placements,
              "fsdp": trainer.state.parallel.fsdp, "unsharded": unsharded}
    if world == 2:
        # The checkpoint resumes at the same world size.
        fresh = Trainer(cfg, *loaders, model=TTinyDet(),
                        priors=_tiny_priors(), device="cpu")
        result["resumed"] = fresh.maybe_resume()
        result["resumed_equal"] = all(
            torch.equal(t, trainer.state.model.state_dict()[k])
            for k, t in fresh.state.model.state_dict().items())
        result["resumed_history"] = fresh.history
    if rank == 0:
        torch.save(result, out)


@pytest.fixture(scope="module")
def fitted(voc_root, tmp_path_factory):
    """JAX's Trainer on the (2,) and (2, 2) meshes, the port's at world
    size 1, 2 and 4, from the same TinyDet weights."""
    tmp = tmp_path_factory.mktemp("par")
    jcfg, tcfg = _configs(voc_root, tmp / "single")
    jrecs = jvoc.load_records(str(voc_root))
    jtr_ids, jva_ids = jvoc.train_val_split(len(jrecs), 1 / 3, seed=10)
    jtr = [jrecs[i] for i in jtr_ids]
    jva = [jrecs[i] for i in jva_ids]

    def jax_run(world, shape, axes):
        mesh = jmesh.create_mesh(shape, axes,
                                 devices=jax.devices()[:int(np.prod(shape))])
        cfg = _variant(jcfg, world)
        trainer = JTrainer(
            cfg, JLoader(jtr, cfg.data, 64, train=True, seed=0),
            JLoader(jva, cfg.data, 64, train=False, drop_last=False),
            mesh=mesh, model=JTinyDet(), priors=_tiny_priors())
        return trainer

    jax_runs = {2: jax_run(2, (2,), ("data",)),
                4: jax_run(4, (2, 2), ("data", "fsdp"))}
    params0 = jax.device_get(jax_runs[2].state.params)
    weights = str(tmp / "w.pt")
    torch.save(_twin(params0).state_dict(), weights)
    tr, va = _records(voc_root)
    singles = {}
    for world, trainer in jax_runs.items():
        trainer.fit()
        cfg = _variant(tcfg.replace(train=dataclasses.replace(
            tcfg.train, checkpoint_dir=str(tmp / f"single{world}"))), world)
        singles[world] = Trainer(
            cfg, Loader(tr, cfg.data, 64, train=True, seed=0),
            Loader(va, cfg.data, 64, train=False, drop_last=False),
            model=_twin(params0), priors=_tiny_priors(), device="cpu")
        singles[world].fit()

    runs = {}
    for world, shape, axes in ((2, None, ("data",)),
                               (4, (2, 2), ("data", "fsdp"))):
        out = str(tmp / f"w{world}.pt")
        ckpt = tmp / f"ck{world}"
        run_ranks(_rank_trainer, world, tmp, voc_root, ckpt, weights, shape,
                  axes, out, threads=2 if world == 2 else 1)
        runs[world] = dict(torch.load(out, weights_only=False), ckpt=ckpt)
    return dict(jax=jax_runs, singles=singles, runs=runs, cfg=tcfg,
                root=voc_root)


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_loader_rows_bit_equal_to_jax(voc_root, world):
    """Every rank's rows of every batch (augmented train epoch, padded-free
    eval tail) equal JAX's `Loader(shard=)`, and together the
    single-process batch."""
    jcfg, tcfg = _configs(voc_root, "unused")
    tr, va = _records(voc_root)
    jrecs = jvoc.load_records(str(voc_root))
    jtr_ids, _ = jvoc.train_val_split(len(jrecs), 1 / 3, seed=10)
    jtr = [jrecs[i] for i in jtr_ids]
    whole = list(Loader(tr, tcfg.data, 64, train=True, seed=3).epoch(1))
    for r in range(world):
        got = list(Loader(tr, tcfg.data, 64, train=True, seed=3,
                          shard=(r, world)).epoch(1))
        want = list(JLoader(jtr, jcfg.data, 64, train=True, seed=3,
                            shard=(r, world)).epoch(1))
        assert len(got) == len(want) == len(whole) == 2
        per = 8 // world
        for g, w, full in zip(got, want, whole):
            assert g.keys() == w.keys()
            assert int(g["global_size"]) == 8
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                if k != "global_size":
                    np.testing.assert_array_equal(
                        g[k], full[k][r * per:(r + 1) * per], err_msg=k)
    tail = list(Loader(va, tcfg.data, 64, train=False, drop_last=False,
                       shard=(world - 1, world)).epoch(0))
    assert int(tail[-1]["global_size"]) == 3
    assert tail[-1]["images"].shape[0] == 0   # the last rank's rows: none
    with pytest.raises(ValueError, match="not divisible"):
        Loader(tr, tcfg.data, 64, shard=(0, 3))
    with pytest.raises(ValueError, match="bad shard"):
        Loader(tr, tcfg.data, 64, shard=(2, 2))


def test_initialize_noop_half_configured_and_torchrun(monkeypatch):
    for k in distributed.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.local_shard_bounds(8) == (0, 8)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK, MASTER_ADDR"):
        distributed.initialize("cpu")
    assert not dist.is_initialized()
    # torchrun's environment, one rank: joins a gloo group on the CPU.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    try:
        assert distributed.initialize("cpu") == torch.device("cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert distributed.process_count() == 1
        assert distributed.process_index() == 0 and distributed.is_primary()
        assert distributed.local_shard_bounds(6) == (0, 6)
        # Once joined, a second call joins nothing.
        assert distributed.initialize("cpu") == torch.device("cpu")
        mesh = mesh_lib.create_mesh(None, ("data", "fsdp"), "cpu")
        assert mesh_lib.batch_axes(mesh) == ()
        assert mesh_lib.local_batch_size(6, mesh) == 6
        with pytest.raises(ValueError, match="not ported"):
            mesh_lib.create_mesh(None, ("data", "pipeline"), "cpu")
        with pytest.raises(ValueError, match="holds 2 devices"):
            mesh_lib.create_mesh((2,), ("data",), "cpu")
    finally:
        dist.destroy_process_group()


def test_cli_checks_the_world_size(monkeypatch):
    """`train --fsdp` must divide the processes and `eval --data-parallel`
    must equal the world size, each exiting before it reads a dataset;
    `train --qat` trains under a mesh, so it passes the guards and reads
    the (here missing) dataset."""
    from objectdetection_ssd_torch import cli
    monkeypatch.setattr(distributed, "initialize",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="--fsdp 4 does not divide the 2"):
        cli.main(["train", "--fsdp", "4", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="VOC list file"):
        cli.main(["train", "--qat", "--device", "cpu", "--voc-root",
                  "no-such-VOCdevkit"])
    with pytest.raises(FileNotFoundError, match="VOC list file"):
        cli.main(["train", "--qat", "--fsdp", "2", "--device", "cpu",
                  "--voc-root", "no-such-VOCdevkit"])
    with pytest.raises(SystemExit,
                       match="--data-parallel 4 does not match the world "
                             "size 2"):
        cli.main(["eval", "--data-parallel", "4", "--device", "cpu"])


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_matches_jax_global_batch_step(fitted, world):
    run, jtrainer = fitted["runs"][world], fitted["jax"][world]
    for phase in ("train", "test"):
        assert len(run["history"][phase]) == 2
        np.testing.assert_allclose(run["history"][phase],
                                   jtrainer.history[phase], rtol=1e-4,
                                   err_msg=phase)
    assert run["step"] == int(jtrainer.state.step) == 4
    assert run["fsdp"] == (world == 4)
    assert run["unsharded"].startswith(
        f"train_loader must be built with shard=(0, {world})")
    # Metrics are weighted by the real rows of the global batch.
    assert run["stats"]["train"]["images"] == 16
    assert run["stats"]["test"]["images"] == 11
    assert run["stats"]["test"]["steps"] == 2
    # A checkpoint of the run, gathered, resumes at world size 1.
    resumed = _resumed(fitted, world)
    assert resumed.start_epoch == 2
    assert resumed.history == run["history"]
    assert resumed.state.step == 4
    _assert_params_match(resumed.state.model, jtrainer.state.params,
                         atol=1e-4)
    assert set(resumed.state.optimizer.state_dict()["state"]) == set(
        fitted["singles"][world].state.optimizer.state_dict()["state"])
    if world == 4:
        assert resumed.state.mini_step == 0
        _assert_params_match(_ema_twin(resumed.state.ema),
                             jtrainer.state.ema_params, atol=1e-4)


def _resumed(fitted, world):
    """A world-size-1 Trainer resumed from the run's checkpoint."""
    _, cfg = _configs(fitted["root"], fitted["runs"][world]["ckpt"])
    cfg = _variant(cfg, world)
    tr, _ = _records(fitted["root"])
    resumed = Trainer(cfg, Loader(tr, cfg.data, 64, seed=0), None,
                      model=TTinyDet(), priors=_tiny_priors(), device="cpu")
    assert resumed.maybe_resume()
    return resumed


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_matches_single_process_port(fitted, world):
    run, single = fitted["runs"][world], fitted["singles"][world]
    for phase in ("train", "test"):
        np.testing.assert_allclose(run["history"][phase],
                                   single.history[phase], rtol=1e-5,
                                   err_msg=phase)
    resumed = _resumed(fitted, world)
    want = single.state.model.state_dict()
    for name, t in resumed.state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    if world == 4:
        for name, t in resumed.state.ema.items():
            np.testing.assert_allclose(t.numpy(),
                                       single.state.ema[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    momentum = resumed.state.optimizer.state_dict()["state"]
    for i, entry in single.state.optimizer.state_dict()["state"].items():
        np.testing.assert_allclose(momentum[i]["momentum_buffer"].numpy(),
                                   entry["momentum_buffer"].numpy(),
                                   rtol=0, atol=1e-5)


def test_fsdp_leaves_follow_fsdp_sharding_for(fitted):
    placements = fitted["runs"][4]["placements"]
    # Conv_0.weight (16, 3, 5, 5): dim 0; Conv_3.weight (21, 32, 3, 3):
    # dim 1 (21 is odd); Conv_3.bias (21,): replicated by the rule, which
    # FSDP2 shards unevenly on dim 0 instead.
    assert placements["Conv_0.weight"] == (
        "(Replicate(), Shard(dim=0))", "Shard(dim=0)")
    assert placements["Conv_3.weight"] == (
        "(Replicate(), Shard(dim=1))", "Shard(dim=1)")
    assert placements["Conv_3.bias"] == (
        "(Replicate(), Shard(dim=0))", "Replicate()")
    for name, (actual, planned) in placements.items():
        if planned == "Replicate()":
            planned = "Shard(dim=0)"
        assert actual == f"(Replicate(), {planned})", name
    # World size 2 runs DDP: plain tensors everywhere.
    assert all(a == "None" for a, _ in
               fitted["runs"][2]["placements"].values())


def test_world2_checkpoint_resumes_at_world2(fitted):
    run = fitted["runs"][2]
    assert run["resumed"] and run["resumed_equal"]
    assert run["resumed_history"] == run["history"]

"""Quantization-aware training of the port under a mesh, on the CPU over
one spawned two-rank gloo world (the ranks run `tests/tp_sp_ranks.py:
rank_qat`, which imports no JAX), against the port's single-process QAT
step (`test_torch_quant_train.py` holds that one against JAX) and against
JAX's QAT step.

* The small QAT model of `test_torch_quant_train.py` (global batch 8, lr
  0.05) under ``data`` = 2 (DDP) and ``data x fsdp`` = 1 x 2 (FSDP2),
  each rank on its 4 rows: against the single-process step on the 8 rows,
  and the DDP step against JAX's on a 2-device ``data`` mesh (run eagerly,
  as `test_torch_quant_train.py` runs JAX's step: under `jit` XLA divides
  by 127 as a multiply by its reciprocal, which moves a channel's largest
  weight off the clip's edge).
* SSD300 at batch 2 (f32, calibrated on the batch) under ``data x model``
  = 1 x 2 (``--tp 2``) and ``data x spatial`` = 1 x 2 (``--sp 2``):
  against the single-process step, and against JAX's jitted step on a
  (1, 2) ``data x model`` mesh for TP and JAX's jitted single-device step
  for SP (JAX's own SP step is wrong, R1 in ROADMAP.md).  JAX's eager
  step at full width is too slow for the suite, so the ranks run these
  steps a second time with the weight scales as `jit` computes them
  (`tests/tp_sp_ranks.py:xla_weight_scale`; without it the losses miss
  the 1e-4 gate).
* Gates (`test_torch_quant_train.py:196-201`): the loss to 1e-4
  relative, the parameters after the step to 1e-4 of each tensor's
  largest.  Against JAX at full width the parameters are held to the
  larger of 1e-4 and 4 x the floor of phase "qat" of `chip_smoke.py`: the
  single-process step against itself with every conv output moved by an
  ulp (`refs["floor"]`, checked to lie below 1e-3).  A fake quantizer
  rounds such noise to the other step.  The fake quant
  ran: each loss differs from the float one.
* ``cli train --qat --tp 2`` (ResNet-34, 8 images) writes one
  quant_scales.json, bound to the checkpoint's weights, whose scales are
  a single-process calibration on the same weights (to 1e-6 relative: the
  ranks' convs run on other thread counts); both ranks train with the
  same scales, bit for bit.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.parallel import mesh as jmesh
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_torch import cli
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.data import synthetic
from objectdetection_ssd_torch.infer import quant as tquant
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops.priors import ssd300_priors
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
from tests.test_torch_cli import _parse
from tests.test_torch_pp import _batch, _seeded_variables
from tests.test_torch_tp_sp_cli import _free_port
from tests.test_torch_quant_train import (_QAT_TREE, _tiny_batch, _tiny_pair,
                                          _tiny_priors)
from tests.tp_sp_ranks import PortTinyQ, qat_step, rank_qat, start_ranks

torch.set_num_threads(2)

TINY_OPTIM = dict(lr=0.05, use_lr_schedule=False)
SSD_OPTIM = dict(use_lr_schedule=False)


def _cli_argv(root):
    return ["train", "--qat", "--tp", "2", "--voc-root",
            str(root / "VOCdevkit"), "--device", "cpu", "--num-workers", "0",
            "--backbone", "resnet34", "--batch-size", "4", "--epochs", "1",
            "--checkpoint-dir", str(root / "qat")]


def _jax_ssd_step(params, batch, qtree, axis=None):
    """JAX's SSD300 QAT step (jitted), on one device or a (1, 2) ``data x
    model`` mesh: (metrics, parameters after it by the port's names)."""
    jmodel = JSSD300()
    tx = jstate.make_optimizer(jconfig.OptimConfig(**SSD_OPTIM))
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=tx.init(params), tx=tx,
                            apply_fn=jmodel.apply)
    q = jax.tree_util.tree_map(jnp.asarray, qtree)
    priors = jnp.asarray(ssd300_priors())
    if axis is None:
        step, _ = jloop.make_jitted_steps(priors, jconfig.LossConfig(),
                                          mesh=None, donate=False,
                                          quant_ste=q)
        new, metrics = step(jst, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    else:
        mesh = jmesh.create_mesh((1, 2), ("data", axis),
                                 devices=jax.devices()[:2])
        sharding = jmesh.state_tp_shardings(jst, mesh)
        jst = jax.device_put(jst, sharding)
        step, _ = jloop.make_jitted_steps(priors, jconfig.LossConfig(),
                                          mesh=mesh, donate=False,
                                          state_sharding=sharding,
                                          quant_ste=q)
        new, metrics = step(jst, jmesh.shard_batch(batch, mesh))
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            from_flax_params(jax.device_get(new.params)))


def _jax_tiny_data_step(batch):
    """JAX's small-model QAT step, eagerly, on a 2-device ``data`` mesh."""
    jst, _ = _tiny_pair(TINY_OPTIM)
    mesh = jmesh.create_mesh((2,), ("data",), devices=jax.devices()[:2])
    jst = jmesh.replicate(jst, mesh)
    jst, metrics = jloop.train_step(
        jst, jmesh.shard_batch(batch, mesh), jnp.asarray(_tiny_priors()),
        jconfig.LossConfig(),
        quant_ste=jax.tree_util.tree_map(jnp.asarray, _QAT_TREE))
    params = {}
    for m, leaves in jax.device_get(jst.params).items():
        for k, v in leaves["Conv_0"].items():
            params[f"{m}.{'weight' if k == 'kernel' else k}"] = \
                torch.from_numpy(np.array(
                    v.transpose(3, 2, 0, 1) if k == "kernel" else v))
    return {k: float(v) for k, v in jax.device_get(metrics).items()}, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qat_mesh")
    _, tiny_model = _tiny_pair(TINY_OPTIM)
    tiny = {"state_dict": tiny_model.state_dict(), "batch": _tiny_batch(),
            "priors": _tiny_priors(), "qtree": _QAT_TREE,
            "optim": tconfig.OptimConfig(**TINY_OPTIM)}
    variables = _seeded_variables()
    sd = from_flax_params(variables)
    weights = str(tmp / "ssd.pt")
    torch.save(sd, weights)
    batch = _batch()
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True)
    model.load_state_dict(sd)
    qtree = tquant.act_scales(tquant.calibrate(model, [batch["images"]]))
    ssd = {"weights": weights, "batch": batch, "qtree": qtree,
           "optim": tconfig.OptimConfig(**SSD_OPTIM)}
    synthetic.generate_voc(str(tmp / "VOCdevkit"), num_2007=6, num_2012=2,
                           image_size=(96, 96), seed=11)
    inputs = str(tmp / "inputs.pt")
    torch.save({"tiny": tiny, "ssd": ssd, "cli_argv": _cli_argv(tmp)},
               inputs)
    out = str(tmp / "out")
    join = start_ranks(rank_qat, 2, tmp, inputs, tmp, _free_port(), out,
                       threads=2)
    # JAX's steps and the single-process references while the ranks run.
    # The two JAX compiles on threads beside the port's references (XLA's
    # compiler and torch's kernels leave the GIL).
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_steps = {key: pool.submit(_jax_ssd_step, variables["params"],
                                      batch, qtree, axis)
                     for key, axis in (("jax_model", "model"),
                                       ("jax_single", None))}
        refs = _port_refs(tiny, ssd, sd, batch, qtree)
        refs.update({k: f.result() for k, f in jax_steps.items()})
    refs["jax_data"] = _jax_tiny_data_step(tiny["batch"])
    join()
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, refs=refs, tmp=tmp)


def _port_refs(tiny, ssd, sd, batch, qtree):
    """The port's single-process QAT steps, the floor and the float
    losses."""
    refs = {}
    tiny_model = PortTinyQ()
    tiny_model.load_state_dict(tiny["state_dict"])
    refs["tiny"] = qat_step(tconfig.ModelConfig(), tiny["optim"], None,
                            tiny["batch"], tiny["priors"], _QAT_TREE,
                            model=tiny_model)
    refs["ssd"] = qat_step(tconfig.ModelConfig(), ssd["optim"], sd, batch,
                           ssd300_priors(), qtree)
    _, noisy = qat_step(tconfig.ModelConfig(), ssd["optim"], sd, batch,
                        ssd300_priors(), qtree,
                        conv_noise=torch.Generator().manual_seed(1))
    refs["floor"] = max(_rel(noisy[n], w) for n, w in refs["ssd"][1].items())
    state = tstate.create_train_state(tconfig.ModelConfig(),
                                      ssd["optim"], device="cpu",
                                      state_dict=sd)
    refs["ssd_float_loss"] = float(tloop.eval_step(
        state, batch, torch.tensor(ssd300_priors()))["loss"])
    tiny_model.load_state_dict(tiny["state_dict"])
    state = tstate.TrainState(tiny_model, *tstate.make_optimizer(
        tiny_model.named_parameters(), tiny["optim"]))
    refs["tiny_float_loss"] = float(tloop.eval_step(
        state, tiny["batch"], torch.tensor(tiny["priors"]))["loss"])
    return refs


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _assert_step(got, want, what, tol=1e-4):
    """Loss to 1e-4 relative, each parameter after the step to ``tol`` of
    its largest."""
    metrics, params = got
    wmetrics, wparams = want
    np.testing.assert_allclose(metrics["loss"], wmetrics["loss"], rtol=1e-4,
                               err_msg=what)
    assert metrics["num_pos"] == wmetrics["num_pos"] > 0, what
    assert set(params) == set(wparams), what
    for name, w in wparams.items():
        assert _rel(params[name], w) <= tol, (what, name, _rel(params[name],
                                                               w))


@pytest.mark.parametrize("mesh", ["data", "fsdp"])
def test_qat_step_small_model_matches_single_process(world, mesh):
    refs = world["refs"]
    for rank in world["ranks"]:
        _assert_step(rank[mesh], refs["tiny"], mesh)
        assert rank[mesh][0]["loss"] != refs["tiny_float_loss"]


def test_qat_ddp_step_matches_jax_data_mesh(world):
    for rank in world["ranks"]:
        _assert_step(rank["data"], world["refs"]["jax_data"], "data")


@pytest.mark.parametrize("mesh", ["model", "spatial"])
def test_qat_ssd300_step_matches_single_process(world, mesh):
    refs = world["refs"]
    for rank in world["ranks"]:
        _assert_step(rank[mesh], refs["ssd"], mesh)
        assert rank[mesh][0]["loss"] != refs["ssd_float_loss"]


@pytest.mark.parametrize("mesh,ref", [("model", "jax_model"),
                                      ("spatial", "jax_single")])
def test_qat_ssd300_step_matches_jax(world, mesh, ref):
    refs = world["refs"]
    assert 0 < refs["floor"] < 1e-3
    for rank in world["ranks"]:
        _assert_step(rank[mesh + "_xla"], refs[ref], mesh,
                     max(1e-4, 4 * refs["floor"]))


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), float(np.asarray(tree[key]))


def test_cli_train_qat_tp_writes_single_process_scales(world):
    tmp = world["tmp"]
    path = os.path.join(tmp, "qat", tquant.SCALES_FILENAME)
    saved = dict(_flat(tquant.load_scales(path)))
    # Both ranks trained with one tree: the file's.
    seen = [[dict(_flat(q)) for q in r["cli_scales"]]
            for r in world["ranks"]]
    assert len(seen[0]) == len(seen[1]) == 1
    assert seen[0][0] == seen[1][0] == saved
    # A single-process calibration on the same weights and images.
    args = _parse(cli, _cli_argv(tmp))
    cfg = cli.build_config(args)
    train_recs, _ = cli._load_split(cfg, args)
    weights = build_model(
        cfg.model, device="cpu", train=True,
        generator=torch.Generator().manual_seed(cfg.train.seed)).state_dict()
    # The run's file is there now: calibrate afresh beside it.
    qcfg = cfg.replace(quant=dataclasses.replace(cfg.quant, int8=True,
                                                 recalibrate=True))
    want = dict(_flat(cli._build_quant(qcfg, weights, torch.device("cpu"),
                                       records=train_recs)))
    assert set(saved) == set(want) and len(want) > 0
    for key, value in want.items():
        np.testing.assert_allclose(saved[key], value, rtol=1e-6,
                                   err_msg=str(key))
    # Bound to the checkpoint's weights.
    payload, _, epoch = CheckpointManager(os.path.join(tmp, "qat")).load()
    meta = tquant.load_scales_meta(path)
    assert meta["epoch"] == epoch == 0
    assert tquant.param_fingerprint(payload["model"]) == meta[
        "param_fingerprint"]

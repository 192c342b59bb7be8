"""Pipeline parallelism of the PyTorch port (`parallel/pipeline.py`,
`train/loop.py:make_pp_steps`) against the JAX package's
(`objectdetection_ssd_tpu/parallel/pipeline.py`), on the CPU.

* The runner against JAX's `PipelineRunner` on the two-stage models of
  `tests/test_pp.py` (a Dense that widens and a row stride, then a Dense
  over the flattened carry) and their torch counterparts, the weights
  carried across by numpy: the forward, M=1 gradients equal to the
  monolith's, M=2 gradients equal to the grad-accum mean, aux rows split
  with the batch, dp=2 x M=2 against dp=1, the validations, and the loss
  a detached tensor on the last device.  1e-6 of the largest.
* The SSD300 partition: split and merge are a lossless partition of the
  state_dict for 2, 3 and 4 stages, each stage's names are its module's,
  and they map one to one onto JAX's `split_ssd300_params_n` trees
  through `models/convert.py`'s naming.
* Full width, against the port: the 3- and 4-stage chains equal the
  monolithic forward (1e-5 of the largest output).
* Full width, against JAX: one SSD300 `make_pp_steps` train step, 2
  stages, batch 2, M=2, against JAX's on the conftest's CPU devices: loss
  to 1e-4 relative, gradients to 5e-3 of their largest (the gate of
  `test_torch_train.py::test_full_width_train_step_matches_jax`, whose
  docstring gives its reason).
* K2 under PP: the stages are the monolith's convs, so a routed conv keeps
  its route, and the routed PP step (K2's plain version on the CPU)
  matches the unrouted PP step to 1e-4 of each gradient's largest (the
  routed-vs-unrouted gate of `test_torch_train.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.parallel import pipeline as jpipeline
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.ssd import (SSD300, SSDResNet34,
                                                  build_model)
from objectdetection_ssd_torch.ops.priors import ssd300_priors
from objectdetection_ssd_torch.parallel import pipeline as tpipeline
from objectdetection_ssd_torch.parallel.pipeline import PipelineRunner
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate
from tests.test_pp import _tiny
from tests.test_torch_train import ROUTED, _grad_capture, _gt_batch

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------- small models


class TStage0(nn.Module):
    """`tests/test_pp.py:_Stage0`: (B, 8, 4) -> (B, 4, 6)."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 6)

    def forward(self, x):
        return torch.relu(self.dense(x))[:, ::2, :]


class TStage1(nn.Module):
    """`tests/test_pp.py:_Stage1`: (B, 4, 6) -> (B, 3)."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(24, 3)

    def forward(self, h):
        return self.dense(h.reshape(h.shape[0], -1))


class TMono(nn.Module):
    def __init__(self):
        super().__init__()
        self.s0, self.s1 = TStage0(), TStage1()

    def forward(self, x):
        return self.s1(self.s0(x))


def _pair():
    """JAX's tiny pipeline (`tests/test_pp.py:_tiny`) and the torch
    monolith holding the same weights; the input as both."""
    mono, variables, fns, stage_params, x = _tiny()
    tm = TMono()
    p = jax.device_get(variables["params"])
    with torch.no_grad():
        for s in ("s0", "s1"):
            dense = getattr(tm, s).dense
            dense.weight.copy_(torch.from_numpy(
                np.asarray(p[s]["Dense_0"]["kernel"]).T.copy()))
            dense.bias.copy_(torch.from_numpy(
                np.array(p[s]["Dense_0"]["bias"])))
    return (mono, variables, fns, stage_params, x), tm, \
        torch.from_numpy(np.array(x))


def _runner(tm, m=1, dp=1):
    return PipelineRunner([tm.s0, tm.s1], [CPU] * (2 * dp), microbatches=m,
                          dp=dp)


def _jgrads(g):
    """Per-stage JAX gradients by the torch stage's names."""
    return [{"dense.weight": np.asarray(s["params"]["Dense_0"]["kernel"]).T,
             "dense.bias": np.asarray(s["params"]["Dense_0"]["bias"])}
            for s in g]


def _assert_grads(got, want, tol=1e-6):
    assert [set(s) for s in got] == [set(s) for s in want]
    for gs, ws in zip(got, want):
        for name in ws:
            _close(gs[name].numpy(), ws[name], tol)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_runner_forward_matches_jax(m):
    (_, variables, fns, stage_params, x), tm, tx = _pair()
    want = jpipeline.PipelineRunner(fns, stage_params,
                                    microbatches=m).forward(x)
    got = _runner(tm, m).forward(tx)
    _close(got.numpy(), np.asarray(want))
    with torch.no_grad():
        _close(tm(tx).numpy(), np.asarray(want))


def test_single_microbatch_grads_match_monolith_and_jax():
    (_, _, fns, stage_params, x), tm, tx = _pair()
    tgt = jnp.ones((8, 3), jnp.float32)
    jloss, jg = jpipeline.PipelineRunner(fns, stage_params).loss_and_grads(
        x, lambda out: jnp.mean((out - tgt) ** 2))
    loss, grads = _runner(tm).loss_and_grads(
        tx, lambda out: torch.mean((out - 1.0) ** 2))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _assert_grads(grads, _jgrads(jg))
    mono = torch.mean((tm(tx) - 1.0) ** 2)
    mono.backward()
    assert float(loss) == float(mono.detach())
    for stage, gs in zip((tm.s0, tm.s1), grads):
        for name, p in stage.named_parameters():
            assert torch.equal(gs[name], p.grad), name


def test_microbatched_grads_are_grad_accum_mean():
    (_, _, fns, stage_params, x), tm, tx = _pair()
    tgt = np.random.RandomState(2).randn(8, 3).astype(np.float32)
    jloss, jg = jpipeline.PipelineRunner(
        fns, stage_params, microbatches=2).loss_and_grads(
        x, lambda out, t: jnp.mean((out - t) ** 2), aux=jnp.asarray(tgt))
    ttgt = torch.from_numpy(tgt)
    loss, grads = _runner(tm, 2).loss_and_grads(
        tx, lambda out, t: torch.mean((out - t) ** 2), aux=ttgt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _assert_grads(grads, _jgrads(jg))
    # The grad-accum mean of the monolith over the two halves.
    losses = []
    for half in (slice(0, 4), slice(4, 8)):
        lm = torch.mean((tm(tx[half]) - ttgt[half]) ** 2) / 2
        lm.backward()
        losses.append(float(lm.detach()))
    np.testing.assert_allclose(float(loss), sum(losses), rtol=1e-6)
    _assert_grads(grads, [{n: p.grad.numpy() for n, p in
                           s.named_parameters()} for s in (tm.s0, tm.s1)])


def test_aux_targets_split_with_the_batch():
    (_, _, fns, stage_params, x), tm, tx = _pair()
    tgt = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    seen = []

    def loss_fn(out, t):
        seen.append(t.clone())
        return torch.mean((out - t) ** 2), t.shape[0]

    loss, _, extras = _runner(tm, 4).loss_and_grads(
        tx, loss_fn, aux=torch.from_numpy(tgt), has_aux=True)
    # Newest microbatch first, each its own rows.
    for i, t in enumerate(seen):
        np.testing.assert_array_equal(t.numpy(),
                                      tgt[(3 - i) * 2:(4 - i) * 2])
    assert extras == [2, 2, 2, 2]
    jloss, _ = jpipeline.PipelineRunner(
        fns, stage_params, microbatches=4).loss_and_grads(
        x, lambda out, t: jnp.mean((out - t) ** 2), aux=jnp.asarray(tgt))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_dp_composes_with_microbatches_like_dp1_and_jax():
    (_, _, fns, stage_params, x), tm, tx = _pair()
    tgt = np.random.RandomState(3).randn(8, 3).astype(np.float32)
    jcomp = jpipeline.PipelineRunner(fns, stage_params,
                                     devices=jax.devices()[:4],
                                     microbatches=2, dp=2)
    jloss, jg = jcomp.loss_and_grads(
        x, lambda out, aux: jnp.mean((out - aux) ** 2), aux=jnp.asarray(tgt))

    def loss_fn(out, aux):
        return torch.mean((out - aux) ** 2)

    plain_loss, plain = _runner(tm, 2).loss_and_grads(
        tx, loss_fn, aux=torch.from_numpy(tgt))
    runner = _runner(tm, 2, dp=2)
    assert len(runner.replicas[0]) == 2
    assert runner.replicas[0][0] is tm.s0
    loss, grads = runner.loss_and_grads(tx, loss_fn,
                                        aux=torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), float(plain_loss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _assert_grads(grads, [{n: g.numpy() for n, g in s.items()}
                          for s in plain])
    _assert_grads(grads, _jgrads(jg))
    _close(runner.forward(tx).numpy(),
           np.asarray(jcomp.forward(x)))
    # The replicas follow the lead's weights at each call.
    with torch.no_grad():
        tm.s1.dense.bias.add_(1.0)
    runner.forward(tx)
    assert torch.equal(runner.replicas[1][1].dense.bias, tm.s1.dense.bias)


def test_runner_validations_match_jax():
    (_, _, fns, stage_params, x), tm, tx = _pair()
    cases = (
        (dict(microbatches=0), "microbatches must be >= 1"),
        (dict(dp=0), "dp must be >= 1"),
    )
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jpipeline.PipelineRunner(fns, stage_params, **kw)
        with pytest.raises(ValueError, match=msg):
            PipelineRunner([tm.s0, tm.s1], [CPU] * 2, **kw)
    for dp, n in ((1, 1), (2, 3)):
        with pytest.raises(ValueError) as jerr:
            jpipeline.PipelineRunner(fns, stage_params,
                                     devices=jax.devices()[:n], dp=dp)
        with pytest.raises(ValueError) as terr:
            PipelineRunner([tm.s0, tm.s1], [CPU] * n, dp=dp)
        assert str(terr.value) == str(jerr.value)
    for m, dp, rows in ((3, 1, 8), (2, 2, 6)):
        with pytest.raises(ValueError) as jerr:
            jpipeline.PipelineRunner(fns, stage_params,
                                     devices=jax.devices()[:2 * dp],
                                     microbatches=m, dp=dp).forward(x[:rows])
        with pytest.raises(ValueError) as terr:
            _runner(tm, m, dp).forward(tx[:rows])
        assert str(terr.value) == str(jerr.value)
    with torch.device("meta"):
        resnet, ssd = SSDResNet34(), SSD300()
    with pytest.raises(ValueError, match="supports the SSD300 family; got "
                       "SSDResNet34"):
        tpipeline.build_pipeline_for(resnet, 2, [CPU] * 2)
    with pytest.raises(ValueError, match="unsupported for SSD300"):
        tpipeline.ssd300_stages(ssd, 5)


def test_loss_stays_a_device_tensor():
    _, tm, tx = _pair()
    loss, _ = _runner(tm, 2).loss_and_grads(
        tx, lambda out: torch.mean(out ** 2))
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert loss.device == CPU and not loss.requires_grad


# ----------------------------------------------------- SSD300 partition


@functools.lru_cache(maxsize=None)
def _jax_shapes():
    return jax.eval_shape(JSSD300().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 300, 300, 3)))


def _seeded_variables():
    """SSD300 variables drawn with numpy at JAX's shapes (no compile of
    its init): kernels N(0, 1 / fan_in), biases N(0, 0.01), the L2Norm
    scale 20."""
    rng = np.random.default_rng(4)

    def draw(path, x):
        name = path[-1].key
        if name == "kernel":
            std = np.prod(x.shape[:-1]) ** -0.5
            return rng.normal(0, std, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.01, x.shape).astype(np.float32)
        return np.full(x.shape, 20.0, np.float32)

    return {"params": jax.tree_util.tree_map_with_path(
        draw, dict(_jax_shapes()["params"]))}


@pytest.mark.parametrize("n", sorted(tpipeline.SSD300_STAGE_CUTS))
def test_ssd300_split_is_lossless_and_maps_onto_jax(n):
    assert tpipeline.SSD300_STAGE_CUTS == jpipeline.SSD300_STAGE_CUTS
    with torch.device("meta"):
        model = SSD300()
    sd = model.state_dict(keep_vars=True)
    stages = tpipeline.split_ssd300_params_n(sd, n)
    assert len(stages) == n
    names = [set(s) for s in stages]
    assert sum(len(s) for s in names) == len(sd)
    assert set().union(*names) == set(sd)
    merged = tpipeline.merge_ssd300_stage_trees(stages)
    assert set(merged) == set(sd)
    assert all(merged[k] is sd[k] for k in sd)
    # Each stage module holds exactly its partition, the monolith's own
    # tensors under the monolith's names.
    for stage, part in zip(tpipeline.ssd300_stages(model, n), stages):
        ssd = stage.state_dict(keep_vars=True)
        assert set(ssd) == set(part)
        assert all(ssd[k] is part[k] for k in part)
    # One to one onto JAX's stage trees through the converter's naming.
    flags = jax.tree_util.tree_map(
        lambda x: np.zeros((1,) * len(x.shape), np.float32),
        dict(_jax_shapes()))
    jstages = jpipeline.split_ssd300_params_n(flags["params"], n)
    assert [set(from_flax_params(t)) for t in jstages] == names


def test_pp_rejects_unknown_stage_count():
    with pytest.raises(ValueError, match="unsupported SSD300 stage count"):
        tpipeline.split_ssd300_params_n({}, 5)


# ------------------------------------------------------------ full width


def _images(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, 300, 300, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def monolith():
    """A seeded SSD300, a batch of 2 images and its monolithic forward."""
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True,
                        generator=torch.Generator().manual_seed(0))
    x = _images(2)
    with torch.no_grad():
        return model, x, model(x)


@pytest.mark.parametrize("n", [3, 4])
def test_ssd300_nstage_chain_matches_monolith(monolith, n):
    model, x, want = monolith
    runner = tpipeline.build_pipeline_for(model, n, [CPU] * n,
                                          microbatches=2)
    got = runner.forward(x)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), 1e-5)


def _batch():
    rng = np.random.default_rng(8)
    boxes, classes, mask = _gt_batch(rng, (3, 2), max_boxes=4)
    return {"images": rng.integers(0, 256, (2, 300, 300, 3),
                                   dtype=np.uint8),
            "boxes": boxes, "classes": classes, "mask": mask}


def _port_pp_step(state_dict, batch, model_config=tconfig.ModelConfig()):
    state = tstate.create_train_state(
        model_config, tconfig.OptimConfig(use_lr_schedule=False),
        device="cpu", state_dict=state_dict)
    runner = tpipeline.build_pipeline_for(state.model, 2, [CPU] * 2,
                                          microbatches=2)
    step, _ = tloop.make_pp_steps(runner, ssd300_priors())
    state, metrics = step(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def full_width():
    """JAX's `make_pp_steps` step on SSD300 (2 stages, M=2, batch 2, f32,
    on two of the conftest's CPU devices), its gradients captured as the
    optimizer state, and the port's from the same bridged weights."""
    batch = _batch()
    jmodel = JSSD300()
    variables = _seeded_variables()
    tx = _grad_capture()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"],
                            opt_state=tx.init(variables["params"]), tx=tx,
                            apply_fn=jmodel.apply)
    runner, split_fn, merge_fn = jpipeline.build_pipeline_for(
        jmodel, variables["params"], 2, devices=jax.devices()[:2],
        microbatches=2)
    jstep, _ = jloop.make_pp_steps(runner, split_fn, merge_fn,
                                   jnp.asarray(ssd300_priors()),
                                   jconfig.LossConfig(), donate=False)
    new, jmetrics = jstep(jst, {k: jnp.asarray(v) for k, v in
                                batch.items()})
    sd = from_flax_params(variables)
    state, metrics = _port_pp_step(sd, batch)
    return dict(batch=batch, sd=sd, state=state, metrics=metrics,
                jmetrics={k: float(v) for k, v in
                          jax.device_get(jmetrics).items()},
                jgrads=from_flax_params(jax.device_get(new.opt_state)))


def test_full_width_pp_step_matches_jax(full_width):
    metrics, jmetrics = full_width["metrics"], full_width["jmetrics"]
    assert metrics["num_pos"] == jmetrics["num_pos"] > 0
    for k in ("loss", "cls_loss", "loc_loss"):
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-4,
                                   err_msg=k)
    grads = {n: p.grad for n, p in
             full_width["state"].model.named_parameters()}
    assert set(grads) == set(full_width["jgrads"])
    for name, want in full_width["jgrads"].items():
        want = want.numpy()
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=0,
                                   atol=5e-3 * np.abs(want).max(),
                                   err_msg=name)


def test_k2_route_survives_pp_and_matches_unrouted_step(full_width):
    cfg = tconfig.ModelConfig(dw_pallas_convs=ROUTED)
    state, metrics = _port_pp_step(full_width["sd"], full_width["batch"],
                                   cfg)
    for name in ROUTED:
        assert getattr(state.model.trunk, name).dw_route
    stages = tpipeline.ssd300_stages(state.model, 2)
    assert stages[0].trunk.conv1_1 is state.model.trunk.conv1_1
    np.testing.assert_allclose(metrics["loss"],
                               full_width["metrics"]["loss"], rtol=1e-6)
    want = dict(full_width["state"].model.named_parameters())
    for name, p in state.model.named_parameters():
        w = want[name].grad.numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)

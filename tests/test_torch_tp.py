"""Tensor parallelism of the port (``model`` axis, `parallel/
tensor_parallel.py`) on the CPU over two gloo ranks, against JAX's GSPMD
on a mesh of the same shape over its virtual CPU devices, and against the
port's own single-process runs.

* `tp_sharding_for` against JAX's spec for every SSD300 and ResNet-34
  parameter and statistic at ``model`` = 2 and 4; `batch_axes`,
  `local_batch_size` and `secondary_axis` on ``data x model`` and ``data
  x spatial`` meshes (spawn-free).
* The channel gather, forward and backward: every conv geometry of both
  families, channel-sharded (input shard in, whole output gathered), to
  1e-5 of the unsplit conv's largest output and gradient.
* One full-width SSD300 step (300 px, f32, batch 1, conv1/conv2 routed
  through K2's plain version) at ``data x model`` = 1 x 2: against JAX's
  step on the (1, 2) mesh with the gates of `test_torch_train.py::
  test_full_width_train_step_matches_jax` (losses to 1e-4 relative,
  gradients to 5e-3 of their largest), and against the port's
  single-process step (1e-5); each rank holds 1/2 of every sharded
  parameter and momentum buffer (every SSD300 width is even).
* `Detector(mesh=)` on the wide-bias SSD300 (batch 1, f32): detections
  against JAX's Detector on the (1, 2) mesh (JAX `tests/test_tp.py`:
  rtol 1e-5, atol 1e-6); int8 (chained, calibrated on the batch): every
  K3 call's output bit-equal to this rank's channels of the
  single-process call, detections equal to the single-process port's.
  (The ranks run `tests/tp_sp_ranks.py`, which imports no JAX.)
* The Trainer on the (1, 2) mesh: two epochs of a small detector built of
  the port's layers (its 21-wide conf head replicated), losses and
  weights to 1e-5 of the single-process Trainer's, the replicated leaves
  equal on both ranks, a gathered checkpoint that resumes at world size 1
  to equal parameters.

Tolerances: the sharded convs sum the same products as the whole ones;
what differs is the order of the input gradient's sum (each rank's
partial sum, then the all-reduce) and L2Norm's squares (summed per shard,
then all-reduced), a few f32 ulps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.config import Config as JConfig
from objectdetection_ssd_tpu.data import synthetic as jsynthetic
from objectdetection_ssd_tpu.infer.detector import Detector as JDetector
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.models.ssd import SSDResNet34 as JSSDResNet34
from objectdetection_ssd_tpu.parallel import mesh as jmesh
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.ssd import SSD300, SSDResNet34
from objectdetection_ssd_torch.ops.priors import ssd300_priors
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from tests.test_torch_train import _grad_capture
from tests.tp_sp_ranks import (GEOMETRIES, images, int8_reference, port_step,
                               rank_tp, run_ranks, ssd_batch, trainer_run)

torch.set_num_threads(2)

MESH = (1, 2)


class StubMesh:
    """The names and sizes of a mesh, for the rules that read only them."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    def size(self, i):
        return self.shape[i]


# -------------------------------------------------------------- spawn-free


@functools.lru_cache(maxsize=None)
def _jax_shapes(backbone):
    size = 300 if backbone == "vgg16" else 224
    jmodel = JSSD300() if backbone == "vgg16" else JSSDResNet34()
    return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backbone", ["vgg16", "resnet34"])
def test_tp_sharding_for_matches_jax(backbone, tp):
    shapes = _jax_shapes(backbone)
    jm = jmesh.create_mesh((8 // tp, tp), ("data", "model"))

    def flag(x):
        # One element of the leaf's rank: whether JAX shards it.
        spec = jmesh.tp_sharding_for(x, jm).spec
        assert spec in (P(), P("model"), P(None, None, None, "model"))
        return np.full((1,) * len(x.shape), float(spec != P()), np.float32)

    want = from_flax_params(jax.tree_util.tree_map(flag, dict(shapes)))
    with torch.device("meta"):          # shapes only
        model = SSD300() if backbone == "vgg16" else SSDResNet34()
    state = model.state_dict()
    assert set(state) == set(want)
    mesh = StubMesh(("data", "model"), (8 // tp, tp))
    sharded = set()
    for name, t in state.items():
        got = mesh_lib.tp_sharding_for(t, mesh)
        assert got in (Shard(0), Replicate()), name
        if got == Shard(0):
            sharded.add(name)
        assert (got == Shard(0)) == bool(want[name].item()), name
    assert mesh_lib.state_tp_shardings(state, mesh) == {
        n: Shard(0) if n in sharded else Replicate() for n in state}
    # Widths the axis does not divide stay whole.
    if backbone == "vgg16":
        assert ("conf_head_1.weight" in sharded) == (tp == 2)
    else:
        assert "conf_t4.weight" not in sharded
        assert "loc_t4.conv.weight" in sharded


@pytest.mark.parametrize("axis", ["model", "spatial"])
def test_batch_axes_exclude_model_and_spatial(axis):
    jm = jmesh.create_mesh((4, 2), ("data", axis))
    mesh = StubMesh(("data", axis), (4, 2))
    assert mesh_lib.batch_axes(mesh) == jmesh.batch_axes(jm) == ("data",)
    assert mesh_lib.local_batch_size(8, mesh) == jmesh.local_batch_size(
        8, jm) == 2
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.local_batch_size(7, mesh)
    assert mesh_lib.secondary_axis(mesh) == axis
    assert mesh_lib.spatial_ways(mesh) == jmesh.spatial_ways(jm)
    assert mesh_lib.secondary_axis(StubMesh(("data", axis), (8, 1))) is None


# ------------------------------------------------------------- JAX's side


@functools.lru_cache(maxsize=None)
def jax_variables():
    """JAX SSD300's variables from PRNGKey(0), as numpy (one compile of
    its init per process)."""
    return jax.device_get(jax.jit(JSSD300().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3))))


def wide_bias(variables):
    """`tests/test_torch_detector.py:wide_bias_params` of these variables:
    a copy of the params with the conf-head biases drawn from N(0, 3)."""
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rng = np.random.default_rng(0)
    for i in range(6):
        bias = params[f"conf_head_{i}"]["Conv_0"]["bias"]
        bias[...] = rng.normal(0.0, 3.0, bias.shape)
    return params


def jax_step(variables, batch, axis=None):
    """JAX's step on a (1, 2) ``data x axis`` mesh, or on one device
    without ``axis``: (metrics, gradients by the port's names)."""
    jmodel = JSSD300()
    tx = _grad_capture()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"],
                            opt_state=tx.init(variables["params"]), tx=tx,
                            apply_fn=jmodel.apply)
    priors = jnp.asarray(ssd300_priors())
    if axis is None:
        step, _ = jloop.make_jitted_steps(priors, jconfig.LossConfig(),
                                          mesh=None, donate=False)
        new, metrics = step(jst, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    else:
        mesh = jmesh.create_mesh(MESH, ("data", axis),
                                 devices=jax.devices()[:2])
        if axis == "model":
            sharding = jmesh.state_tp_shardings(jst, mesh)
            jst = jax.device_put(jst, sharding)
            step, _ = jloop.make_jitted_steps(priors, jconfig.LossConfig(),
                                              mesh=mesh, donate=False,
                                              state_sharding=sharding)
        else:
            jst = jmesh.replicate(jst, mesh)
            step, _ = jloop.make_jitted_steps(priors, jconfig.LossConfig(),
                                              mesh=mesh, donate=False)
        new, metrics = step(jst, jmesh.shard_batch(batch, mesh))
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            from_flax_params(jax.device_get(new.opt_state)))


def jax_mesh_detections(params, axis):
    mesh = jmesh.create_mesh(MESH, ("data", axis), devices=jax.devices()[:2])
    return jax.device_get(JDetector(JConfig(), params, mesh=mesh)
                          .detect_batch(jnp.asarray(images())))


def assert_detections(got, want, rtol, atol):
    """Valid masks and classes equal; boxes and scores of the valid rows
    within the tolerance (the rows past them hold no detection)."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=rtol,
                               atol=atol)


def assert_step(ranks, want, loss_rtol, grad_rtol):
    """Every rank's SSD300 step against ``want`` (metrics, gradients):
    the positive count equal, the losses to ``loss_rtol`` relative, each
    gradient to ``grad_rtol`` of its largest element."""
    wmetrics, wgrads = want
    for rank in ranks:
        metrics, grads = rank["step"]
        assert metrics["num_pos"] == wmetrics["num_pos"] > 0
        for k in ("loss", "cls_loss", "loc_loss"):
            np.testing.assert_allclose(metrics[k], wmetrics[k],
                                       rtol=loss_rtol, err_msg=k)
        assert set(grads) == set(wgrads)
        for name, w in wgrads.items():
            w = w.numpy()
            np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                       atol=grad_rtol * np.abs(w).max(),
                                       err_msg=name)


def assert_int8_calls(ranks, single_path):
    single, _ = torch.load(single_path, weights_only=False)
    assert single.valid.sum() > 0
    for rank in ranks:
        det = rank["detector"]
        count_ok, same = det["int8_calls"]
        assert count_ok and len(same) == 23 and all(same), same
        assert_detections(det["int8"], single, 0, 0)


# ------------------------------------------------------- the spawned world


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """24 records: 16 train (2 batches of 8), 8 val."""
    root = tmp_path_factory.mktemp("voc")
    jsynthetic.generate_voc(str(root), num_2007=20, num_2012=4,
                            image_size=(96, 96), seed=7)
    return root


@pytest.fixture(scope="module")
def world(tmp_path_factory, voc_root):
    tmp = tmp_path_factory.mktemp("tp")
    variables = jax_variables()
    weights = str(tmp / "w.pt")
    torch.save(from_flax_params(variables), weights)
    det_params = wide_bias(variables)
    det_weights = str(tmp / "det.pt")
    det_sd = from_flax_params(det_params)
    torch.save(det_sd, det_weights)
    qtree_path, single = int8_reference(det_sd, tmp)
    out = str(tmp / "out")
    run_ranks(rank_tp, 2, tmp, tmp, weights, det_weights, qtree_path,
              single, voc_root, out, threads=2)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, variables=variables, weights=weights,
                det_params=det_params, single=single, tmp=tmp)


@pytest.mark.parametrize("geometry", [g[0] for g in GEOMETRIES
                                      if g[1] == "conv"])
def test_channel_gather_forward_and_backward(world, geometry):
    for rank in world["ranks"]:
        errors = rank["layers"][geometry]
        assert set(errors) == {"forward", "grad_x", "weight", "bias"}
        for what, err in errors.items():
            assert err <= 1e-5, (what, err)


def test_ssd300_tp_step_matches_jax_mesh(world):
    assert_step(world["ranks"], jax_step(world["variables"], ssd_batch(),
                                         "model"), 1e-4, 5e-3)


def test_ssd300_tp_step_matches_single_process_port(world):
    assert_step(world["ranks"],
                port_step(torch.load(world["weights"]), ssd_batch())[:2],
                1e-5, 1e-5)


def test_tp_state_is_sharded_and_replicated_leaves_agree(world):
    for rank in world["ranks"]:
        local, total = rank["memory"]
        assert total > 0 and local * 2 == total
        # At model = 2 every SSD300 width is even: nothing replicated.
        assert rank["replicated"] == {}
        trainer = rank["trainer"]
        assert trainer["sharded"]
        assert trainer["replicated"] == {"conf.weight": True,
                                         "conf.bias": True}


def test_tp_detect_batch_matches_jax_mesh(world):
    want = jax_mesh_detections(world["det_params"], "model")
    assert int(np.asarray(want.valid).sum()) > 0
    for rank in world["ranks"]:
        assert_detections(rank["detector"]["f32"], want, 1e-5, 1e-6)


def test_tp_int8_calls_bit_equal_to_single_process(world):
    assert_int8_calls(world["ranks"], world["single"])


def test_tp_trainer_matches_single_process_and_resumes(world, voc_root):
    tmp = world["tmp"]
    single = trainer_run(voc_root, tmp / "single_ckpt")
    single.fit()
    want = {n: p.detach() for n, p in single.state.model.named_parameters()}
    for rank in world["ranks"]:
        run = rank["trainer"]
        assert run["step"] == single.state.step == 4
        for phase in ("train", "test"):
            np.testing.assert_allclose(run["history"][phase],
                                       single.history[phase], rtol=1e-5,
                                       err_msg=phase)
        for name, p in want.items():
            np.testing.assert_allclose(run["params"][name].numpy(),
                                       p.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    # The gathered checkpoint resumes at world size 1.
    resumed = trainer_run(voc_root, tmp / "tp_ckpt")
    assert resumed.maybe_resume() and resumed.start_epoch == 2
    assert resumed.state.step == 4
    for name, p in resumed.state.model.named_parameters():
        assert torch.equal(p.detach(),
                           world["ranks"][0]["trainer"]["params"][name]), name
    assert set(resumed.state.optimizer.state_dict()["state"]) == set(
        single.state.optimizer.state_dict()["state"])

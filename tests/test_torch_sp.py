"""Spatial partitioning of the port (``spatial`` axis, `parallel/
spatial.py`) on the CPU over gloo ranks, against JAX's GSPMD on a mesh of
the same shape over its virtual CPU devices, and against the port's own
single-process runs.

* `row_bounds` cuts the input image as JAX's `image_sharding` does;
  `out_size` is torch's, and `halo_plan` gives every output row to one
  rank, for every conv and pool geometry of both families at 2, 3 and 4
  ranks (spawn-free).
* The halo exchange and the row gather, forward and backward: every conv
  and pool geometry of both families (kernel, stride, padding, dilation,
  ceil mode, ``-inf`` pool padding) at ``spatial`` = 2: to 1e-5 of the
  unsplit layer's largest output and gradient.  ``spatial`` = 4, where
  maps of 5, 3, 2 and 1 rows leave ranks without rows and halos reach past
  the neighbour, is `tests/test_torch_sp_uneven.py`.
* One full-width SSD300 step (300 px, f32, batch 1, conv1/conv2 routed
  through K2's plain version, its rows plus one halo row each side) at
  ``data x spatial`` = 1 x 2: the loss against JAX's step on the (1, 2)
  mesh, the gradients against JAX's single-device step (`ROADMAP.md` §3,
  R1) with the gates of `test_torch_train.py::test_full_width_train_
  step_matches_jax` (losses to 1e-4 relative, gradients to 5e-3 of their
  largest), and against the port's single-process step (1e-5).
* The ResNet-34 family with its trunk trained, in train mode (36
  BatchNorms on batch statistics over every rank), in f64 under a fixed
  linear loss, at ``spatial`` = 2: gradients to 1e-8 of the single-process
  step's, which shows the partition exact.  In f32 they differ by
  percents, because the 36 train-mode BatchNorms amplify the rounding of
  the other summation order; the default frozen-trunk step meets 5e-4 in
  f32 (`tests/test_torch_sp_uneven.py`, at ``spatial`` = 4).
* `Detector(mesh=)` on the wide-bias SSD300: f32 detections against
  JAX's Detector on the (1, 2) mesh (JAX `tests/test_sp.py`: rtol 1e-5,
  atol 1e-6); int8 (chained): every K3 call's output bit-equal to the
  rows of the single-process call that the rank computed (K3 at padding 0
  on the int8 halo rows padded with zero columns), detections equal.
  (The ranks run `tests/tp_sp_ranks.py`, which imports no JAX.)
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu.parallel import mesh as jmesh
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.parallel.spatial import halo_plan, out_size
from tests.test_torch_tp import (assert_detections, assert_int8_calls,
                                 assert_step, jax_mesh_detections, jax_step,
                                 jax_variables, wide_bias)
from tests.tp_sp_ranks import (GEOMETRIES, int8_reference, port_step,
                               rank_sp, resnet_f64_grads, resnet_weights,
                               run_ranks, ssd_batch)

torch.set_num_threads(2)


# -------------------------------------------------------------- spawn-free


@pytest.mark.parametrize("size,ways", [(300, 2), (300, 3), (300, 4),
                                       (224, 2), (224, 4)])
def test_row_bounds_cut_the_image_as_jax(size, ways):
    jm = jmesh.create_mesh((1, ways), ("data", "spatial"),
                           devices=jax.devices()[:ways])
    images = jmesh.shard_batch(
        {"images": np.zeros((1, size, size, 3), np.uint8)}, jm)["images"]
    position = {d: i for i, d in enumerate(jm.devices[0])}
    want = {}
    for shard in images.addressable_shards:
        rows = shard.index[1]
        want[position[shard.device]] = (rows.start or 0, rows.stop or size)
    assert [mesh_lib.row_bounds(size, ways, i) for i in range(ways)] == [
        want[i] for i in range(ways)]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in
                                                       GEOMETRIES])
def test_halo_plan_covers_every_output_row(geometry):
    _, kind, size, k, s, p, d, ceil = geometry
    x = torch.zeros(1, 1, size, size)
    if kind == "conv":
        h = F.conv2d(x, torch.zeros(1, 1, k, k), None, s, p, d).shape[2]
    else:
        h = F.max_pool2d(x, k, s, p, ceil_mode=ceil).shape[2]
    assert out_size(size, k, s, p, d, ceil) == h
    for ways in (2, 3, 4):
        plan = halo_plan(size, ways, k, s, p, d, ceil)
        assert plan.rows == [b - a for a, b in (
            mesh_lib.row_bounds(h, ways, i) for i in range(ways))]
        for i, (lo, hi) in enumerate(plan.need):
            computed = max(plan.rows[i], 1)
            assert hi - lo == (computed - 1) * s + d * (k - 1) + 1
            # Every row a rank reads from another lies in a band of it.
            for j, own in enumerate(plan.own):
                got = (max(lo, own[0]), min(hi, own[1]))
                if j == i or got[1] <= got[0]:
                    continue
                band = plan.top[j] if j > i else plan.bottom[j]
                assert band[0] <= got[0] and got[1] <= band[1]


# ------------------------------------------------------- the spawned world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    variables = jax_variables()
    weights = str(tmp / "w.pt")
    torch.save(from_flax_params(variables), weights)
    resnet_sd, resnet_path = resnet_weights(tmp)
    det_params = wide_bias(variables)
    det_sd = from_flax_params(det_params)
    det_weights = str(tmp / "det.pt")
    torch.save(det_sd, det_weights)
    qtree_path, single = int8_reference(det_sd, tmp)
    out = str(tmp / "out")
    run_ranks(rank_sp, 2, tmp, resnet_path, det_weights, qtree_path, single,
              out, weights, threads=2)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, variables=variables, weights=weights,
                resnet_sd=resnet_sd, det_params=det_params, single=single)


def assert_layers(ranks, geometry):
    for rank in ranks:
        errors = rank["layers"][geometry]
        for what, err in errors.items():
            assert err <= 1e-5, (what, err)


@pytest.mark.parametrize("geometry", [g[0] for g in GEOMETRIES])
def test_halo_exchange_forward_and_backward(world, geometry):
    assert_layers(world["ranks"], geometry)


def test_ssd300_sp_step_matches_jax(world):
    """The loss against JAX's step on the (1, 2) ``data x spatial`` mesh;
    the gradients against JAX's single-device step, which its mesh step
    should equal (JAX `tests/test_sp.py`) and does not (`ROADMAP.md` §3,
    R1): there the gradients of conv5_1 to conv5_3, the convs before the
    3x3/s1/p1 pool5 over 19 rows cut 10 + 9, differ from the
    single-device step's by a large share of their largest."""
    mesh_metrics, mesh_grads = jax_step(world["variables"], ssd_batch(),
                                        "spatial")
    jmetrics, jgrads = jax_step(world["variables"], ssd_batch())
    for k in ("loss", "cls_loss", "loc_loss"):
        np.testing.assert_allclose(mesh_metrics[k], jmetrics[k], rtol=1e-6,
                                   err_msg=k)
    for rank in world["ranks"]:
        np.testing.assert_allclose(rank["step"][0]["loss"],
                                   mesh_metrics["loss"], rtol=1e-4)
    assert_step(world["ranks"], (jmetrics, jgrads), 1e-4, 5e-3)
    # R1, as this run sees it: the largest difference between JAX's mesh
    # and single-device gradients, relative to each tensor's largest.
    r1 = max(float((mesh_grads[n] - g).abs().max() / g.abs().max())
             for n, g in jgrads.items() if g.abs().max() > 0)
    print(f"JAX SP mesh vs single-device gradients: {r1:.3e}")


def test_ssd300_sp_step_matches_single_process_port(world):
    assert_step(world["ranks"],
                port_step(torch.load(world["weights"]), ssd_batch())[:2],
                1e-5, 1e-5)


def test_resnet34_trained_trunk_sp_step_is_exact_in_f64(world):
    loss, grads = resnet_f64_grads(world["resnet_sd"])
    for rank in world["ranks"]:
        got_loss, got = rank["f64"]
        assert abs(got_loss - loss) <= 1e-10 * abs(loss)
        for name, g in grads.items():
            if name.startswith("loc_") and name.endswith("conv.bias"):
                continue            # zero in exact arithmetic
            np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0,
                                       atol=1e-8 * g.abs().max().item(),
                                       err_msg=name)


def test_sp_detect_batch_matches_jax_mesh(world):
    want = jax_mesh_detections(world["det_params"], "spatial")
    assert int(np.asarray(want.valid).sum()) > 0
    for rank in world["ranks"]:
        assert_detections(rank["detector"]["f32"], want, 1e-5, 1e-6)


def test_sp_int8_calls_bit_equal_to_single_process(world):
    assert_int8_calls(world["ranks"], world["single"])

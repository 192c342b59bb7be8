"""The two-stage SSD300 pipeline API of the port (`parallel/pipeline.py`:
`SSD300TrunkStage`, `split_ssd300_params`, `build_ssd300_pipeline`) and
`parallel/distributed.py:create_global_mesh`, against the JAX package's
(`objectdetection_ssd_tpu/parallel/pipeline.py:123-222`,
`parallel/distributed.py:72-76`), on the CPU.

* `split_ssd300_params` maps one to one, name and value, onto JAX's
  `split_ssd300_params` trees through `models/convert.py:from_flax_params`
  (JAX's weights drawn with numpy at its shapes, so its init is not
  compiled); it equals the 2-stage `split_ssd300_params_n`, and
  `merge_ssd300_stage_trees` inverts it losslessly.
* `build_ssd300_pipeline(model, ["cpu", "cpu"], microbatches=2).forward`
  equals the monolith's forward to 1e-5 of the largest output at batch 2.
* ``devices=None`` with fewer than two CUDA cards raises.
* `create_global_mesh`: a one-rank ``data`` mesh with no process group, a
  mesh over the group's ranks under one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.parallel import pipeline as jpipeline
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.ssd import SSD300
from objectdetection_ssd_torch.parallel import distributed
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.parallel import pipeline as tpipeline

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _seeded_variables():
    """SSD300 variables drawn with numpy at JAX's shapes: kernels
    N(0, 1 / fan_in), biases N(0, 0.01), the L2Norm scale 20."""
    shapes = jax.eval_shape(JSSD300().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 300, 300, 3)))
    rng = np.random.default_rng(15)

    def draw(path, x):
        name = path[-1].key
        if name == "kernel":
            std = np.prod(x.shape[:-1]) ** -0.5
            return rng.normal(0, std, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.01, x.shape).astype(np.float32)
        return np.full(x.shape, 20.0, np.float32)

    return {"params": jax.tree_util.tree_map_with_path(
        draw, dict(shapes["params"]))}


def test_split_maps_onto_jax_and_merges_back():
    variables = _seeded_variables()
    sd = from_flax_params(variables)
    trunk, head = tpipeline.split_ssd300_params(sd)
    assert trunk and head and set(trunk).isdisjoint(head)
    assert all(k.startswith("trunk.") for k in trunk)
    assert not any(k.startswith("trunk.") for k in head)
    assert [trunk, head] == tpipeline.split_ssd300_params_n(sd, 2)
    merged = tpipeline.merge_ssd300_stage_trees([trunk, head])
    assert set(merged) == set(sd)
    assert all(merged[k] is sd[k] for k in sd)
    # One to one onto JAX's (trunk, head) trees, names and values.
    for port, jax_tree in zip((trunk, head),
                              jpipeline.split_ssd300_params(variables)):
        want = from_flax_params(jax_tree)
        assert set(port) == set(want)
        for k in want:
            assert torch.equal(port[k], want[k]), k


@pytest.fixture(scope="module")
def monolith():
    """The seeded SSD300 on the CPU, a batch of 2 images and its
    monolithic forward."""
    model = SSD300()
    model.load_state_dict(from_flax_params(_seeded_variables()))
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 300, 300, 3), dtype=np.uint8))
    with torch.no_grad():
        return model, x, model(x)


def test_two_stage_pipeline_matches_monolith(monolith):
    model, x, want = monolith
    runner = tpipeline.build_ssd300_pipeline(model, devices=["cpu", "cpu"],
                                             microbatches=2)
    trunk, head = runner.stages
    assert type(trunk) is tpipeline.SSD300TrunkStage
    assert type(head) is tpipeline.SSD300HeadStage
    # The stages are views over the monolith's own parameters, split as
    # `split_ssd300_params` splits its state_dict.
    parts = tpipeline.split_ssd300_params(model.state_dict(keep_vars=True))
    for stage, part in zip(runner.stages, parts):
        ssd = stage.state_dict(keep_vars=True)
        assert set(ssd) == set(part)
        assert all(ssd[k] is part[k] for k in part)
    got = runner.forward(x)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("cards", [0, 1])
def test_default_devices_need_two_cards(monkeypatch, cards):
    with torch.device("meta"):
        model = SSD300()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match=f"needs 2 CUDA devices; {cards}"):
        tpipeline.build_ssd300_pipeline(model)


def test_create_global_mesh_without_and_with_a_process_group(tmp_path):
    assert not dist.is_initialized()
    mesh = distributed.create_global_mesh()
    assert mesh.mesh_dim_names == ("data",)
    assert mesh.size() == 1 and list(mesh.get_coordinate()) == [0]
    assert mesh_lib.data_shard(mesh) == (0, 1)
    assert mesh_lib.local_batch_size(8, mesh) == 8
    pair = distributed.create_global_mesh(("data", "fsdp"),
                                          device_type="cpu")
    assert pair.mesh_dim_names == ("data", "fsdp")
    assert tuple(pair.shape) == (1, 1)
    with pytest.raises(ValueError, match="holds 2 devices"):
        distributed.create_global_mesh(("data",), (2,))
    with pytest.raises(ValueError, match="not ported"):
        distributed.create_global_mesh(("data", "pipeline"))

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = distributed.create_global_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        assert mesh.get_group("data") is not None
    finally:
        dist.destroy_process_group()

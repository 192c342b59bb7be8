"""The port's signatures against the JAX package's.

Both trees are read with `ast`, so nothing is imported for the comparison.
For every public top-level function, and every public method or
``__init__`` of a public top-level class, that the two packages share
(the same module path and qualified name), the JAX parameter names,
minus those `BY_DESIGN` or `STATE_DICT_IDIOM` leaves out, are in order a
prefix of the port's, minus the counterparts those tables name.  The port
may append its own keywords (``device``, ``mesh``, ``part``, ``group``,
``generator``).  ``*args`` and ``**kwargs`` are held apart: the port takes
one wherever JAX does.

A method of a shared class that JAX has and the port lacks fails, unless
`NO_METHOD` gives the reason.  A stale table entry fails too: one that
names a function the packages do not share, or a parameter that is not
there.  The last tests check the behaviour that the order pins.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "objectdetection_ssd_tpu"
PORT_PKG = REPO / "objectdetection_ssd_torch"

# A flax parameter tree (and its BatchNorm statistics) is a state_dict in
# the port, or the weights a module already holds; left out everywhere.
STATE_DICT_IDIOM = (("params", "variables", "batch_stats"), ("state_dict",))

_STAGES = ("the pipeline's parameter trees: its stage modules own their "
           "parameters (`parallel/pipeline.py`)")
# "module:qualname" -> (JAX names left out, the port's counterparts left
# out, reason).
BY_DESIGN = {
    "parallel.pipeline:split_ssd300_params": ((), (), _STAGES),
    "parallel.pipeline:split_ssd300_params_n": ((), (), _STAGES),
    "parallel.pipeline:merge_ssd300_stage_trees": (
        ("stage_trees",), ("stage_dicts",),
        _STAGES + "; a list of stage state_dicts"),
    "parallel.pipeline:build_pipeline_for": ((), (), _STAGES),
    "parallel.pipeline:build_ssd300_pipeline": ((), (), _STAGES),
    "parallel.pipeline:PipelineRunner.__init__": (
        ("stage_fns", "stage_params"), ("stages",),
        _STAGES + "; one module per stage in place of a function and its "
        "parameter tree"),
    "parallel.pipeline:PipelineRunner.forward": ((), (), _STAGES),
    "parallel.pipeline:PipelineRunner.loss_and_grads": ((), (), _STAGES),
    "train.loop:make_pp_steps": (
        ("split_fn", "merge_fn", "donate"), (),
        _STAGES + ", so no split or merge of a tree; `donate` is XLA's "
        "buffer donation under `jit`, and torch updates in place"),
    "parallel.distributed:initialize": (
        ("coordinator_address", "num_processes", "process_id"), (),
        "the group's address, size and rank come from torchrun's "
        "environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
        "MASTER_PORT)"),
    "train.state:TrainState.apply_gradients": (
        ("grads", "kw"), (),
        "the gradients live in each parameter's `.grad`, as backward "
        "leaves them"),
    "train.state:create_train_state": (
        ("model", "rng", "sample_input", "frozen_prefixes"),
        ("model_config", "device", "generator", "model"),
        "the port builds the registry model of a ModelConfig (or takes "
        "`model=`) on a device, its weights drawn from a torch.Generator or "
        "loaded from a state_dict, where flax initializes a module from an "
        "rng and a sample input; the frozen prefixes follow from the "
        "ModelConfig (`frozen_prefixes`)"),
    "train.state:make_optimizer": (
        (), ("named_params",),
        "a torch optimizer takes its parameters when it is built; an optax "
        "transformation takes them at each update"),
    "train.trainer:Trainer.__init__": (
        ("mesh", "init_params", "init_batch_stats"), ("init_state_dict",),
        "the mesh is built from the process group and the config; the "
        "initial weights and BatchNorm statistics are one state_dict"),
    "parallel.mesh:create_mesh": (
        ("devices",), ("device_type",),
        "a DeviceMesh spans the process group's ranks, one device each, of "
        "a device type; JAX lists the devices"),
    "parallel.mesh:state_tp_shardings": (
        ("state",), ("tensors",),
        "the placements of named tensors (a state_dict or the optimizer's "
        "state), where JAX maps a whole TrainState to shardings"),
    "train.state:is_bias_path": (
        ("path",), ("name",),
        "a dotted parameter name of `named_parameters`, where JAX takes a "
        "pytree key path"),
    "models.ssd:ssd300_post_trunk": (
        ("num_classes", "l2_norm_scale_init", "dtype"), ("model",),
        "the module argument: its heads, L2Norm and compute dtype hold "
        "what JAX passes to the function"),
    "infer.postprocess:soft_nms_scores": (
        ("unrolled",), (),
        "a trace-time switch of XLA's loop (unrolled or `fori_loop`); the "
        "port runs eagerly"),
    "infer.export:export_detector": (
        ("platforms",), (),
        "`jax.export`'s lowering platforms; the port exports for one "
        "device (`device=`)"),
    "utils.doctor:host_checks": (
        ("compilation_cache_dir",), (),
        "XLA's persistent compilation cache; the port compiles no graph"),
    "utils.doctor:probe_backend": (
        ("platform",), ("device",),
        "a torch device (cuda or cpu) in place of a JAX platform name"),
}

# "module:Class.method" of JAX's that the port's class lacks -> reason.
NO_METHOD = {
    "parallel.pipeline:PipelineRunner.aux_placement":
        "the last stage's device is `PipelineRunner.aux_device`; there is "
        "no sharding to place the loss targets with",
}


def _module_of(path: Path, root: Path) -> str:
    parts = path.relative_to(root).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "__init__"


def _is_static(node) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "staticmethod"
               for d in node.decorator_list)


def scan(root: Path) -> dict:
    """``{"module:qualname": parameters}`` of a package's public functions
    and its public classes' public methods and ``__init__``."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        if "_build" in path.parts:
            continue
        module = _module_of(path, root)
        for node in ast.parse(path.read_text()).body:
            if getattr(node, "name", "_").startswith("_"):
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[f"{module}:{node.name}"] = parameters(node, False)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if (isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                            and (not sub.name.startswith("_")
                                 or sub.name == "__init__")):
                        out[f"{module}:{node.name}.{sub.name}"] = \
                            parameters(sub, True)
    return out


def parameters(node, method: bool) -> tuple:
    """(ordered names, ``*args`` name or None, ``**kwargs`` name or None);
    a method's ``self`` / ``cls`` left out."""
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if method and not _is_static(node):
        names = names[1:]
    return (names, a.vararg.arg if a.vararg else None,
            a.kwarg.arg if a.kwarg else None)


JAX = scan(JAX_PKG)
PORT = scan(PORT_PKG)
SHARED = sorted(set(JAX) & set(PORT))
_PORT_CLASSES = {k.rpartition(".")[0] for k in PORT if "." in k.split(":")[1]}
# JAX methods of a class the port also has: each must have a counterpart.
JAX_METHODS_OF_SHARED_CLASSES = sorted(
    k for k in JAX if "." in k.split(":")[1]
    and k.rpartition(".")[0] in _PORT_CLASSES)
CASES = sorted(set(SHARED) | set(JAX_METHODS_OF_SHARED_CLASSES))


def compared(key: str) -> tuple:
    """(JAX names, the port's names) as the prefix rule compares them."""
    jax_out, port_out, _ = BY_DESIGN.get(key, ((), (), ""))
    j_names, j_var, j_kw = JAX[key]
    p_names, p_var, p_kw = PORT[key]
    jax_out = set(jax_out) | set(STATE_DICT_IDIOM[0])
    # Where JAX itself takes a state_dict (a torch checkpoint to convert),
    # the port's is the same parameter.
    port_out = set(port_out) | (set(STATE_DICT_IDIOM[1]) - set(j_names))
    j = [n for n in j_names + [j_var, j_kw] if n and n not in jax_out]
    p = [n for n in p_names if n not in port_out]
    return j, p, (j_var, j_kw), (p_var, p_kw), jax_out


def test_the_scan_finds_the_shared_surface():
    # About 170 shared functions and methods; a scan that finds far fewer
    # has stopped reading one of the trees.
    assert len(SHARED) >= 170, len(SHARED)
    assert "train.loop:train_step" in SHARED
    assert "infer.detector:Detector.__init__" in SHARED


@pytest.mark.parametrize("key", CASES)
def test_port_signature_extends_jax_signature(key):
    if key in NO_METHOD:
        assert key not in PORT, f"{key} is in the port: drop it from " \
                                "NO_METHOD"
        assert NO_METHOD[key].strip()
        return
    assert key in PORT, (f"JAX's {key} has no counterpart in the port; "
                         "port it, or give the reason in NO_METHOD")
    j, p, (j_var, j_kw), (p_var, p_kw), jax_out = compared(key)
    j_ordered = [n for n in j if n not in (j_var, j_kw)]
    assert p[:len(j_ordered)] == j_ordered, (
        f"{key}: JAX {j_ordered} is not a prefix of the port's {p}")
    if j_var and j_var not in jax_out:
        assert p_var, f"{key}: JAX takes *{j_var}, the port no *args"
    if j_kw and j_kw not in jax_out:
        assert p_kw, f"{key}: JAX takes **{j_kw}, the port no **kwargs"


@pytest.mark.parametrize("key", sorted(BY_DESIGN))
def test_by_design_entry_is_current(key):
    jax_out, port_out, reason = BY_DESIGN[key]
    assert reason.strip()
    assert key in SHARED, f"{key} is not a function both packages have"
    j_names, j_var, j_kw = JAX[key]
    p_names, _, _ = PORT[key]
    for name in jax_out:
        assert name in j_names + [j_var, j_kw], (key, name)
    for name in port_out:
        assert name in p_names, (key, name)


# ------------------------------------------------------------- behaviour


class _DropoutDet(torch.nn.Module):
    """One conv, dropout, one head: the dropout masks are the only
    randomness of a step."""

    def __init__(self):
        from objectdetection_ssd_torch.models.layers import Dropout
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=4, padding=1)
        self.drop = Dropout(0.5)
        self.head = torch.nn.Conv2d(8, 25, 1)
        for p in self.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)

    def forward(self, images, generator=None, remat=False):
        x = images.permute(0, 3, 1, 2)
        x = self.drop(torch.relu(self.conv(x)), generator)
        y = self.head(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1, 25)
        return y[..., :4], y[..., 4:]


def _dropout_state():
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.train.state import create_train_state
    return create_train_state(ModelConfig(), OptimConfig(lr=0.1),
                              device="cpu", model=_DropoutDet())


def test_train_step_fifth_positional_is_the_seed():
    from objectdetection_ssd_torch.config import LossConfig
    from objectdetection_ssd_torch.train.loop import train_step
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 255, (2, 16, 16, 3)).astype(np.uint8),
             "boxes": np.asarray([[[0.1, 0.1, 0.6, 0.6]]] * 2, np.float32),
             "classes": np.asarray([[3]] * 2, np.int32),
             "mask": np.ones((2, 1), bool)}
    centers = (np.arange(4) + 0.5) / 4
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    priors = torch.tensor(np.stack([cx.ravel(), cy.ravel(),
                                    np.full(16, 0.4), np.full(16, 0.4)], 1),
                          dtype=torch.float32)
    cfg = LossConfig(match_iou_threshold=0.3)
    after = {}
    for name, kw in (("positional", None), ("seed", {"seed": 3}),
                     ("default", {})):
        state = _dropout_state()
        if kw is None:
            state, m = train_step(state, batch, priors, cfg, 3)
        else:
            state, m = train_step(state, batch, priors, cfg, **kw)
        after[name] = (float(m["loss"]),
                       torch.cat([p.detach().flatten()
                                  for p in state.model.parameters()]))
    assert after["positional"][0] == after["seed"][0]
    assert torch.equal(after["positional"][1], after["seed"][1])
    # Seed 0 draws other masks: the seed reached the dropout.
    assert after["positional"][0] != after["default"][0]


class _StubMesh:
    """The names and sizes of a mesh, for the rules that read only them."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("axis", [None, "data", "fsdp"])
def test_local_batch_size_axis_matches_jax(axis):
    from objectdetection_ssd_tpu.parallel import mesh as jmesh

    from objectdetection_ssd_torch.parallel import mesh as mesh_lib
    jm = jmesh.create_mesh((4, 2), ("data", "fsdp"))
    mesh = _StubMesh(("data", "fsdp"), (4, 2))
    want = jmesh.local_batch_size(8, jm, axis=axis)
    assert mesh_lib.local_batch_size(8, mesh, axis=axis) == want
    assert mesh_lib.local_batch_size(8, mesh, axis) == want
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.local_batch_size(7, mesh, axis=axis)


def test_checkpoint_manager_close_is_safe_twice(tmp_path):
    from objectdetection_ssd_torch.config import ModelConfig, OptimConfig
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
    from objectdetection_ssd_torch.train.state import create_train_state
    fresh = CheckpointManager(str(tmp_path / "fresh"))
    fresh.close()
    fresh.close()
    used = CheckpointManager(str(tmp_path / "used"))
    state = create_train_state(ModelConfig(), OptimConfig(), device="cpu",
                               model=_DropoutDet())
    used.save(0, state)
    restored, _, epoch = used.restore(_dropout_state())
    assert epoch == 0
    used.close()
    used.close()
    # Closing loses nothing: the saved epoch still loads.
    assert CheckpointManager(str(tmp_path / "used")).latest_epoch() == 0

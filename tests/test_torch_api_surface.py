"""The port's public API against the JAX package's.

Every public top-level ``def`` / ``class`` of every module of
`objectdetection_ssd_tpu` (read with `ast`, so nothing of JAX is imported
for it), and every name the JAX package's ``__init__`` imports, has one of:

* a counterpart of the same name in the port's module at the same path;
* an entry in `RENAMED`, naming the port attribute that takes its place
  (``"module:attr"``, the module relative to the port's package,
  ``__init__`` for the package itself);
* an entry in `NO_COUNTERPART`, with the reason.

A stale entry fails too: a renamed target that does not exist, an entry
whose JAX name is gone, or a name in either table that the port has under
its own name at the same path.  The two CLIs' subcommands take the same
options, apart from `CLI_NO_COUNTERPART`, `CLI_RENAMED` and the port's own
`CLI_PORT_ONLY`.
"""

import argparse
import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "objectdetection_ssd_tpu"
PORT = "objectdetection_ssd_torch"
ROOT = "__init__"

RENAMED = {
    # One implementation of the VGG stages that the pipeline's trunk
    # slices share (`parallel/pipeline.py:_TrunkSlice`).
    "models.backbones:apply_vgg_stages": "models.backbones:VGG16Trunk._stage",
    # A state_dict in place of a flax parameter tree.
    "models.convert:merge_params": "models.convert:merge_state_dict",
    # One conv module with an int8 branch (kernel K3, `ops/int8_conv.py`).
    "models.layers:Int8Conv": "models.layers:TorchConv",
    # Kernel K2: the Pallas kernel's module is the CUDA kernel's wrapper.
    "ops.dw_pallas:dw_conv3x3p1": "ops.dw_cuda:dw_conv3x3p1",
    "ops.dw_pallas:conv3x3p1": "ops.dw_cuda:conv3x3p1",
    # FSDP2 shards the parameters as it wraps the model, each along
    # `fsdp_sharding_for`.
    "parallel.mesh:shard_params_fsdp": "parallel.data_parallel:DataParallel",
}

_GSPMD = ("a GSPMD `NamedSharding` for `jax.device_put` / `jit`; the port "
          "shards with DDP, FSDP2 and DTensor (`parallel/data_parallel.py`)")
NO_COUNTERPART = {
    "cli:apply_compilation_cache": "XLA's persistent compilation cache; the "
                                   "port compiles no graph, and builds each "
                                   "CUDA kernel once per checkout "
                                   "(`cuda_build.py`)",
    "xla_options:apply_compilation_cache": "XLA's persistent compilation "
                                           "cache",
    "xla_options:scoped_vmem_options": "an XLA compiler option (the TPU's "
                                       "scoped VMEM)",
    "train.loop:train_compiler_options": "XLA compiler options of the "
                                         "jitted train step",
    "train.loop:make_jitted_steps": "`jax.jit` of the steps with mesh "
                                    "shardings; the port's `train_step` "
                                    "runs eagerly, wrapped per mesh by "
                                    "`parallel/data_parallel.py:wrap`",
    "config:DoctorConfig": "the doctor's settings are `cli doctor`'s flags "
                           "(`config.py`'s docstring)",
    "parallel.mesh:batch_sharding": _GSPMD,
    "parallel.mesh:image_sharding": _GSPMD + "; SP's rows are "
                                    "`row_bounds`",
    "parallel.mesh:replicated": _GSPMD,
    "parallel.mesh:shard_batch": _GSPMD + "; each rank's Loader reads its "
                                 "rows (`data_shard`)",
    "parallel.mesh:replicate": _GSPMD,
    "parallel.mesh:state_fsdp_shardings": _GSPMD + " (a `jit` sharding "
                                          "tree of the whole state)",
}

CLI_NO_COUNTERPART = {
    "--compilation-cache": "XLA's persistent compilation cache",
    "--scoped-vmem-kib": "an XLA compiler option (the TPU's scoped VMEM)",
}
# (subcommand, JAX option) -> the port's option.
CLI_RENAMED = {
    ("doctor", "--platform"): "--device",
}
CLI_PORT_ONLY = {
    "--device": "the card, or the CPU when asked: the port's entry points "
                "never fall back to the CPU by themselves",
}


def _module_of(path: Path) -> str:
    parts = path.relative_to(JAX_PKG).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or ROOT


JAX_FILES = {_module_of(p): p for p in sorted(JAX_PKG.rglob("*.py"))}


def jax_public_names(module: str) -> list:
    """The public top-level defs and classes of a JAX module; for the
    package itself, also every name its ``__init__`` imports."""
    tree = ast.parse(JAX_FILES[module].read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and not n.name.startswith("_")]
    if module == ROOT:
        names += [a.asname or a.name for n in tree.body
                  if isinstance(n, ast.ImportFrom) for a in n.names]
    return names


def resolve(target: str):
    """The port's attribute ``"module:attr.sub"``, or None."""
    module, _, attr = target.partition(":")
    name = PORT if module == ROOT else f"{PORT}.{module}"
    try:
        obj = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is None or not name.startswith(e.name):
            raise
        return None
    for part in attr.split("."):
        if not hasattr(obj, part):
            return None
        obj = getattr(obj, part)
    return obj


def _jax_keys() -> set:
    return {f"{m}:{n}" for m in JAX_FILES for n in jax_public_names(m)}


@pytest.mark.parametrize("module", sorted(JAX_FILES))
def test_every_jax_public_name_has_a_counterpart(module):
    missing = []
    for name in jax_public_names(module):
        key = f"{module}:{name}"
        if key in NO_COUNTERPART:
            continue
        target = RENAMED.get(key, key)
        if resolve(target) is None:
            missing.append(f"{key} (port: {target})")
    assert not missing, (
        "JAX public names with no counterpart in the port, no RENAMED "
        f"entry and no NO_COUNTERPART reason: {missing}")


def test_table_entries_are_not_stale():
    keys = _jax_keys()
    stale = []
    for key, target in RENAMED.items():
        if key not in keys:
            stale.append(f"RENAMED {key}: no such JAX public name")
        if resolve(target) is None:
            stale.append(f"RENAMED {key}: the port has no {target}")
        if resolve(key) is not None:
            stale.append(f"RENAMED {key}: the port has it under its name")
    for key, reason in NO_COUNTERPART.items():
        if key not in keys:
            stale.append(f"NO_COUNTERPART {key}: no such JAX public name")
        if not reason.strip():
            stale.append(f"NO_COUNTERPART {key}: no reason")
        if resolve(key) is not None:
            stale.append(f"NO_COUNTERPART {key}: the port has it")
    assert not stale, stale
    assert not set(RENAMED) & set(NO_COUNTERPART)


def test_package_version_is_jax_version():
    tree = ast.parse(JAX_FILES[ROOT].read_text())
    version = next(n.value.value for n in tree.body
                   if isinstance(n, ast.Assign)
                   and [t.id for t in n.targets] == ["__version__"])
    port = importlib.import_module(PORT)
    assert port.__version__ == version
    assert set(jax_public_names(ROOT)) | {"__version__"} == set(port.__all__)


# ---------------------------------------------------------------- the CLI


class _Parsed(Exception):
    pass


def _subcommand_options(module: str, monkeypatch) -> dict:
    """{subcommand: its option strings}, from the parser that ``module``'s
    ``main`` builds (stopped at ``parse_args``)."""
    cli = importlib.import_module(module)

    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as caught:
            cli.main(["doctor"])
    parser = caught.value.args[0]
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o for a in p._actions for o in a.option_strings}
            for name, p in sub.choices.items()}


@pytest.fixture(scope="module")
def cli_options():
    with pytest.MonkeyPatch.context() as mp:
        return (_subcommand_options("objectdetection_ssd_tpu.cli", mp),
                _subcommand_options(f"{PORT}.cli", mp))


def test_cli_has_the_same_subcommands(cli_options):
    jax_cli, port_cli = cli_options
    assert sorted(port_cli) == sorted(jax_cli)


@pytest.mark.parametrize("command",
                         ["train", "eval", "detect", "export", "doctor"])
def test_cli_subcommand_takes_the_jax_options(cli_options, command):
    jax_cli, port_cli = cli_options
    want = {CLI_RENAMED.get((command, o), o) for o in jax_cli[command]
            if o not in CLI_NO_COUNTERPART}
    got = port_cli[command]
    assert want <= got, f"JAX options the port lacks: {want - got}"
    assert got - want <= set(CLI_PORT_ONLY), (
        f"port options JAX lacks: {got - want - set(CLI_PORT_ONLY)}")


def test_cli_tables_are_not_stale(cli_options):
    jax_cli, port_cli = cli_options
    jax_all = set().union(*jax_cli.values())
    port_all = set().union(*port_cli.values())
    for flag in CLI_NO_COUNTERPART:
        assert flag in jax_all and flag not in port_all, flag
    for flag in CLI_PORT_ONLY:
        assert flag in port_all and flag not in jax_all, flag
    for (command, flag), new in CLI_RENAMED.items():
        assert flag in jax_cli[command] and flag not in port_cli[command]
        assert new in port_cli[command]

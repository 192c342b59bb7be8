"""The PyTorch port imports no JAX, nothing of the JAX package and no PIL,
its data path imports no torch (the Loader's spawn workers import it), and
its entry points refuse to fall back to the CPU without a card."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "objectdetection_ssd_torch",
    "objectdetection_ssd_torch.config",
    "objectdetection_ssd_torch.device",
    "objectdetection_ssd_torch.cuda_build",
    "objectdetection_ssd_torch.ops.priors",
    "objectdetection_ssd_torch.ops.boxes",
    "objectdetection_ssd_torch.ops.matching",
    "objectdetection_ssd_torch.ops.dw_cuda",
    "objectdetection_ssd_torch.ops.int8_conv",
    "objectdetection_ssd_torch.losses.multibox",
    "objectdetection_ssd_torch.models.layers",
    "objectdetection_ssd_torch.models.backbones",
    "objectdetection_ssd_torch.models.ssd",
    "objectdetection_ssd_torch.models.convert",
    "objectdetection_ssd_torch.infer.nms_cuda",
    "objectdetection_ssd_torch.infer.postprocess",
    "objectdetection_ssd_torch.infer.detector",
    "objectdetection_ssd_torch.infer.quant",
    "objectdetection_ssd_torch.infer.export",
    "objectdetection_ssd_torch.serve_http",
    "objectdetection_ssd_torch.data.pipeline",
    "objectdetection_ssd_torch.data.voc",
    "objectdetection_ssd_torch.data.augment",
    "objectdetection_ssd_torch.data.cache",
    "objectdetection_ssd_torch.data.synthetic",
    "objectdetection_ssd_torch.native",
    "objectdetection_ssd_torch.eval.voc_map",
    "objectdetection_ssd_torch.eval.evaluate",
    "objectdetection_ssd_torch.train.state",
    "objectdetection_ssd_torch.train.loop",
    "objectdetection_ssd_torch.train.checkpoint",
    "objectdetection_ssd_torch.train.trainer",
    "objectdetection_ssd_torch.utils.metrics",
    "objectdetection_ssd_torch.cli",
)
# What a spawn worker of the Loader imports, and the CLI's module (the
# workers' ``__main__`` under ``python -m``): no torch.
TORCH_FREE = (
    "objectdetection_ssd_torch.data.pipeline",
    "objectdetection_ssd_torch.native",
    "objectdetection_ssd_torch.cli",
)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "objectdetection_ssd_tpu", "PIL")


def test_port_imports_no_jax_no_reference_package_no_pil():
    # A fresh interpreter: this process already imported jax (conftest).
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_path_and_cli_import_no_torch():
    code = (
        "import importlib, sys\n"
        f"for m in {TORCH_FREE!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'torch')\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_silent_cpu_fallback_without_cuda(monkeypatch):
    from objectdetection_ssd_torch.config import (Config, ModelConfig,
                                                  OptimConfig)
    from objectdetection_ssd_torch.device import resolve_device
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.models.ssd import build_model
    from objectdetection_ssd_torch.train.state import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Detector(Config(), {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(ModelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(ModelConfig(), train=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(ModelConfig(), OptimConfig())
    state = create_train_state(ModelConfig(), OptimConfig(), device="cpu")
    assert next(state.model.parameters()).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    from objectdetection_ssd_torch.eval.evaluate import evaluate_records
    from objectdetection_ssd_torch.train.trainer import Trainer

    class Loader:
        records = []

        def __len__(self):
            return 1

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config(), Loader())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_records(Config(), {}, [])


def test_unported_options_raise():
    """What is still unported is refused, not silently ignored: the mesh
    strategies and the doctor have no flag, no config and no module in the
    port."""
    import importlib
    import dataclasses
    from objectdetection_ssd_torch import cli, config

    for argv in (["doctor"], ["train", "--fsdp", "2"],
                 ["train", "--pp", "2"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
    assert "mesh_shape" not in {f.name for f in dataclasses.fields(
        config.TrainConfig)}
    for module in ("objectdetection_ssd_torch.utils.doctor",
                   "objectdetection_ssd_torch.parallel"):
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(module)

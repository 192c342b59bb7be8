"""`cli train --tp / --sp` and `cli eval --tp / --sp [--data-parallel]` of
the port: their guards against JAX's (`tests/test_tp.py`,
`tests/test_sp.py`: mutual exclusion, divisibility; the port's world is
its processes), the refusals that stay (``--qat`` under a mesh, the
pipeline flags), and both commands run by two spawned gloo ranks on the
CPU on a synthetic VOC at 224 px (ResNet-34, frozen trunk):

* ``train --tp 2`` and ``train --sp 2``, one epoch each: their gathered
  checkpoints agree with each other to 1e-5 of each tensor's largest
  value and load at world size 1;
* ``eval --tp 2`` and ``eval --sp 2 --data-parallel 1`` on the ``--tp``
  checkpoint print the mAP that one process prints for it (to 1e-6:
  the detections' boxes and scores differ by a few f32 ulps at most).
"""

import contextlib
import io
import socket

import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu import cli as jcli
from objectdetection_ssd_torch import cli
from objectdetection_ssd_torch.config import ModelConfig, TrainConfig
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.parallel import distributed
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
from tests.test_torch_cli import _parse
from tests.tp_sp_ranks import rank_cli, run_ranks

torch.set_num_threads(2)


@pytest.fixture
def processes(monkeypatch):
    """The port's CLI in a world of ``n`` processes (no group joined)."""
    def world(n):
        monkeypatch.setattr(distributed, "initialize",
                            lambda device=None: torch.device("cpu"))
        monkeypatch.setattr(distributed, "process_count", lambda: n)
    return world


@pytest.mark.parametrize("argv", [
    ["train", "--tp", "2", "--fsdp", "2"],
    ["train", "--sp", "2", "--tp", "2"],
    ["train", "--tp", "3"],
    ["train", "--sp", "3"],
    ["train", "--sp", "8"],
], ids=lambda a: " ".join(a))
def test_train_guards_match_jax(processes, argv):
    """The port's eight processes against JAX's eight devices: the same
    message up to the word for them."""
    with pytest.raises(SystemExit) as want:
        jcli.cmd_train(_parse(jcli, argv))
    processes(8)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    want, got = str(want.value), str(got.value)
    for cut in (" (one strategy", " available devices", " processes"):
        want, got = want.split(cut)[0], got.split(cut)[0]
    assert got == want
    assert ("mutually exclusive" in got or "does not divide" in got)


@pytest.mark.parametrize("argv,match", [
    (["train", "--tp", "4"], "--tp 4 does not divide the 2 processes"),
    # QAT trains under a mesh: past the guards, to the (missing) data.
    (["train", "--qat", "--tp", "2"], (FileNotFoundError, "VOC list file")),
    (["train", "--qat", "--sp", "2"], (FileNotFoundError, "VOC list file")),
    (["eval", "--tp", "2", "--sp", "2"],
     r"--tp and --sp are mutually exclusive \(one secondary eval-mesh "
     r"axis\)"),
    (["eval", "--tp", "2", "--data-parallel", "2"],
     "--data-parallel 2 x --tp 2 does not match the world size 2"),
    (["eval", "--sp", "4"], "--sp 4 does not match the world size 2"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else "")
def test_cli_guards_on_two_processes(processes, argv, match):
    processes(2)
    error, match = match if isinstance(match, tuple) else (SystemExit,
                                                           match)
    with pytest.raises(error, match=match):
        cli.main(argv + ["--device", "cpu"])


def test_pipeline_flags_stay_refused(processes):
    """The pipeline's flags are refused where JAX refuses them: without
    ``--pp``, and ``--pp`` itself under a process group (one process
    drives every stage)."""
    for argv in (["train", "--pp-dp", "2"],
                 ["train", "--pp-microbatches", "2"]):
        with pytest.raises(SystemExit, match="require --pp N"):
            cli.main(argv + ["--device", "cpu"])
    processes(2)
    with pytest.raises(SystemExit, match="--pp is single-controller"):
        cli.main(["train", "--pp", "2", "--device", "cpu"])


# ------------------------------------------------------ two spawned ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _map(text):
    line = [l for l in text.splitlines() if l.strip().startswith("mAP =")]
    return float(line[-1].split("=")[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = str(root / "out")
    run_ranks(rank_cli, 2, root, root, _free_port(), out, threads=2)
    printed = [torch.load(f"{out}.{r}") for r in range(2)]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert cli.main(["eval", "--voc-root", str(root / "VOCdevkit"),
                         "--device", "cpu", "--num-workers", "0",
                         "--backbone", "resnet34", "--batch-size", "8",
                         "--checkpoint-dir", str(root / "tp")]) == 0
    return dict(root=root, printed=printed, single=text.getvalue())


def test_cli_train_tp_and_sp_checkpoints_agree(runs):
    """The losses of the epoch to 1e-5; each tensor's change from the
    initial weights to 5e-3 of its largest change (measured: 9.8e-4).  The
    neck's and heads' train-mode BatchNorms over 4 values per channel
    amplify the other summation order's rounding (the 5e-4 gradient gate
    of `ROADMAP.md` §3), and 5 steps compound it.  The loc heads' conv
    biases, whose gradient is zero in exact arithmetic (a BN follows),
    barely move in either run."""
    tp, tp_meta, tp_epoch = CheckpointManager(str(runs["root"] / "tp")).load()
    sp, sp_meta, sp_epoch = CheckpointManager(str(runs["root"] / "sp")).load()
    assert tp_epoch == sp_epoch == 0 and tp["step"] == sp["step"] == 5
    for phase in ("train", "test"):
        np.testing.assert_allclose(tp_meta["history"][phase],
                                   sp_meta["history"][phase], rtol=1e-5)
    assert set(tp["model"]) == set(sp["model"])
    # The weights both runs started from (`TrainConfig.seed`).
    init = build_model(ModelConfig(backbone="resnet34", image_size=224),
                       device="cpu", train=True, generator=torch.Generator()
                       .manual_seed(TrainConfig().seed)).state_dict()
    for name, t in tp["model"].items():
        assert not hasattr(t, "placements"), name       # gathered
        moved = float((t - init[name]).abs().max())
        if name.startswith("loc_") and name.endswith("conv.bias"):
            assert moved < 1e-6, name
            continue
        assert float((t - sp["model"][name]).abs().max()) <= 5e-3 * moved, \
            name


def test_cli_eval_tp_and_sp_print_the_single_process_map(runs):
    want = _map(runs["single"])
    primary, other = runs["printed"]
    for name in ("eval_tp", "eval_sp"):
        assert abs(_map(primary[name]) - want) <= 1e-6, name
        assert other[name] == ""          # the primary reports
    assert 0.0 <= want <= 1.0

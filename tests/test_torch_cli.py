"""The port's CLI: `build_config` against the JAX package's for every
ported flag, the ``--init-*`` loaders' backbone checks, and train -> eval
-> detect end to end on the CPU against a synthetic fixture, for SSD300
and for the ResNet-34 family with a torchvision-shaped init, remat,
Soft-NMS and flip TTA."""

import dataclasses
import os
import subprocess
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu import cli as jcli
from objectdetection_ssd_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parse(module, argv):
    """``module.main`` with every command stubbed out: the parsed args."""
    captured = {}

    def fake(args):
        captured["args"] = args
        return 0

    names = [n for n in ("cmd_train", "cmd_eval", "cmd_detect", "cmd_export")
             if hasattr(module, n)]
    with mock.patch.multiple(module, **{n: fake for n in names}):
        assert module.main(argv) == 0
    return captured["args"]


# Field by field: what the port's config holds of each JAX config.
_SECTIONS = ("data", "train", "optim", "model", "loss", "postprocess",
             "priors")

CASES = [
    ["train"],
    ["train", "--bf16", "--batch-size", "16", "--num-workers", "3",
     "--checkpoint-dir", "/tmp/ck", "--parity-split", "--allow-partial-voc",
     "--transfer-dtype", "float32", "--synthetic", "--ema-decay", "0.999",
     "--epochs", "4", "--resume", "--image-cache", "/tmp/cache",
     "--eval-map-every", "2", "--device-prefetch", "--lr", "0.002",
     "--warmup-steps", "100", "--no-lr-decay", "--hnm-topk", "0",
     "--grad-accum", "4", "--freeze-trunk-stages", "2"],
    ["train", "--no-device-prefetch", "--backbone", "vgg16",
     "--voc-root", "/data/VOCdevkit"],
    ["train", "--backbone", "resnet34"],
    ["eval", "--split", "train", "--allow-random-init", "--image-cache",
     "/tmp/c", "--use-ema", "--ema-decay", "0.99", "--iou-sweep",
     "--pr-curves", "/tmp/pr.json", "--bf16"],
    ["detect", "a.jpg", "b.jpg", "--allow-random-init", "--use-ema",
     "--transfer-dtype", "float32", "--checkpoint-dir", "ck"],
    ["train", "--backbone", "resnet34", "--remat", "--init-torch-resnet34",
     "r34.pth", "--nms-method", "soft_linear"],
    ["train", "--remat", "--init-torch-vgg16", "vgg.pth", "--tta-flip"],
    ["train", "--init-reference-ckpt", "ref.pth", "--soft-nms-sigma", "0.3"],
    ["eval", "--backbone", "resnet34", "--nms-method", "soft_gaussian",
     "--soft-nms-sigma", "0.3", "--tta-flip"],
    ["detect", "a.jpg", "--backbone", "resnet34", "--tta-flip",
     "--nms-method", "soft_gaussian"],
]


@pytest.mark.parametrize("argv", CASES, ids=lambda a: " ".join(a)[:40])
def test_build_config_matches_jax(argv):
    got = cli.build_config(_parse(cli, argv))
    want = jcli.build_config(_parse(jcli, argv))
    for section in _SECTIONS:
        g, w = getattr(got, section), getattr(want, section)
        for field in dataclasses.fields(g):
            assert getattr(g, field.name) == getattr(w, field.name), (
                f"{section}.{field.name}")
    args, jargs = _parse(cli, argv), _parse(jcli, argv)
    for name, value in vars(args).items():
        if name not in ("fn", "device"):
            assert getattr(jargs, name) == value, name


def test_device_defaults_to_cuda_and_unported_flags_are_refused():
    assert _parse(cli, ["train"]).device == "cuda"
    assert _parse(cli, ["eval", "--device", "cpu"]).device == "cpu"
    for argv in (["train", "--fsdp", "2"], ["eval", "--int8"],
                 ["detect", "x.jpg", "--draw"],
                 ["export", "--out-dir", "x"]):
        with pytest.raises(SystemExit):
            _parse(cli, argv)


def test_train_eval_detect_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(4)
    common = ["--voc-root", "VOCdevkit", "--checkpoint-dir", "ckpt",
              "--device", "cpu", "--num-workers", "0"]
    # The frozen trunk (a ported flag too) skips most of the backward.
    assert cli.main(["train", "--synthetic", "--epochs", "1",
                     "--batch-size", "8", "--freeze-trunk-stages", "5"]
                    + common) == 0
    assert sorted(os.listdir("ckpt")) == ["0"]
    capsys.readouterr()

    assert cli.main(["eval", "--batch-size", "4"] + common) == 0
    out, err = capsys.readouterr()
    assert "restored checkpoint epoch 0" in err
    lines = out.strip().splitlines()
    assert len(lines) == 21 and lines[-1].strip().startswith("mAP = ")
    assert 0.0 <= float(lines[-1].split("=")[1]) <= 1.0

    image = os.path.join("VOCdevkit", "VOC2007", "JPEGImages", "000001.jpg")
    assert cli.main(["detect", image] + common) == 0
    out, _ = capsys.readouterr()
    lines = out.strip().splitlines()
    assert lines[0] == image and len(lines) > 1
    label, score = lines[1].split()[:2]
    assert 0.2 <= float(score) <= 1.0 and label.isalpha()


@pytest.mark.parametrize("argv", [
    ["train", "--init-torch-vgg16", "x.pth", "--backbone", "resnet34"],
    ["train", "--init-torch-resnet34", "x.pth"],
    ["train", "--init-reference-ckpt", "x.pth", "--backbone", "resnet34"],
], ids=["vgg16_on_resnet34", "resnet34_on_vgg16", "reference_on_resnet34"])
def test_init_flags_check_the_backbone_like_jax(argv):
    """The backbone checks come before the file is read, in both."""
    exits = []
    for module in (cli, jcli):
        args = _parse(module, argv)
        with pytest.raises(SystemExit) as e:
            module._load_init_weights(args, module.build_config(args))
        exits.append(str(e.value))
    assert exits[0] == exits[1] and "requires --backbone" in exits[0]
    assert cli._load_init_weights(_parse(cli, ["train"]),
                                  cli.build_config(_parse(cli, ["train"]))) \
        is None


def test_resnet34_train_eval_detect_end_to_end_on_cpu(tmp_path, monkeypatch,
                                                       capsys):
    """`train --backbone resnet34 --init-torch-resnet34 --remat`, then
    `eval` and `detect --tta-flip --nms-method soft_gaussian`, at 224 px.
    The frozen trunk keeps the torchvision weights and BN statistics."""
    from tests.test_torch_convert import torchvision_resnet34
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(4)
    sd = torchvision_resnet34(seed=3)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, "r34.pth")
    common = ["--voc-root", "VOCdevkit", "--checkpoint-dir", "ckpt",
              "--device", "cpu", "--num-workers", "0", "--backbone",
              "resnet34"]
    assert cli.main(["train", "--synthetic", "--epochs", "1",
                     "--batch-size", "8", "--remat", "--init-torch-resnet34",
                     "r34.pth"] + common) == 0
    payload, _, epoch = CheckpointManager("ckpt").load()
    assert epoch == 0
    model = payload["model"]
    for theirs, ours in (("conv1.weight", "trunk.stem_conv.weight"),
                         ("layer4.2.bn2.running_var",
                          "trunk.layer4_block3.bn2.running_var")):
        np.testing.assert_array_equal(model[ours].numpy(), sd[theirs])
    assert not torch.equal(model["neck0.bn.running_mean"],
                           torch.zeros(256))
    capsys.readouterr()

    assert cli.main(["eval", "--batch-size", "4"] + common) == 0
    out, err = capsys.readouterr()
    assert "restored checkpoint epoch 0" in err
    lines = out.strip().splitlines()
    assert len(lines) == 21 and lines[-1].strip().startswith("mAP = ")

    image = os.path.join("VOCdevkit", "VOC2007", "JPEGImages", "000001.jpg")
    assert cli.main(["detect", image, "--tta-flip", "--nms-method",
                     "soft_gaussian"] + common) == 0
    out, _ = capsys.readouterr()
    lines = out.strip().splitlines()
    assert lines[0] == image
    for line in lines[1:]:
        label, score = line.split()[:2]
        assert 0.2 <= float(score) <= 1.0 and label.isalpha()


def test_eval_without_checkpoint_exits_unless_random_init(tmp_path, capsys):
    from objectdetection_ssd_tpu.data import synthetic
    root = tmp_path / "voc"
    synthetic.generate_voc(str(root), num_2007=12, num_2012=0,
                           image_size=(64, 64), seed=1)
    argv = ["eval", "--voc-root", str(root), "--checkpoint-dir",
            str(tmp_path / "nope"), "--num-workers", "0", "--device", "cpu"]
    with pytest.raises(SystemExit) as port_exit:
        cli.main(argv)
    # The JAX CLI builds its SSD300 train state before it looks for the
    # checkpoint; a stand-in skips that compile.
    with mock.patch("objectdetection_ssd_tpu.models.ssd.build_model"), \
            mock.patch("objectdetection_ssd_tpu.train.state."
                       "create_train_state"), \
            pytest.raises(SystemExit) as jax_exit:
        jcli.main(argv[:-2])
    assert str(port_exit.value) == str(jax_exit.value)
    assert "no checkpoint" in str(port_exit.value)
    torch.set_num_threads(4)
    assert cli.main(argv + ["--allow-random-init", "--batch-size", "1"]) == 0
    _, err = capsys.readouterr()
    assert "using random init" in err


def test_cli_entry_point_runs_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "objectdetection_ssd_torch.cli", "eval",
         "--voc-root", str(tmp_path / "missing"), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "VOC list file(s) missing" in proc.stderr

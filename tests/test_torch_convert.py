"""The port's weight loaders (`models/convert.py`) against the JAX
package's, on state_dicts built here with torchvision's and the reference
checkpoint's key names and shapes (random values stand in for pretrained
ones): `from_flax_params` of JAX's converted tree must equal the port's
state_dict exactly, key for key and bit for bit.  Also `merge_state_dict`'s
checks and the Trainer's EMA seed after an init load.
"""

import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu.models import convert as jconvert
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.models import convert as tconvert
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.train.trainer import Trainer

torch.set_num_threads(2)


def _assert_same(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], w), name


def _conv_entries(rng, sd, prefix, out, inp, k, bias=True):
    sd[f"{prefix}.weight"] = rng.normal(0, 0.05, (out, inp, k, k)).astype(
        np.float32)
    if bias:
        sd[f"{prefix}.bias"] = rng.normal(0, 0.05, out).astype(np.float32)


def torchvision_vgg16(seed=0):
    """features.* convs at torchvision's indices and the classifier's two
    4096-wide Linear layers."""
    rng = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for block in ((64, 64), (128, 128), (256,) * 3, (512,) * 3, (512,) * 3):
        for cout in block:
            _conv_entries(rng, sd, f"features.{idx}", cout, cin, 3)
            idx, cin = idx + 2, cout
        idx += 1
    sd["classifier.0.weight"] = rng.standard_normal((4096, 25088),
                                                    dtype=np.float32)
    sd["classifier.0.bias"] = rng.standard_normal(4096, dtype=np.float32)
    sd["classifier.3.weight"] = rng.standard_normal((4096, 4096),
                                                    dtype=np.float32)
    sd["classifier.3.bias"] = rng.standard_normal(4096, dtype=np.float32)
    sd["classifier.6.weight"] = np.zeros((1000, 4096), np.float32)
    return sd


def _bn_entries(rng, sd, prefix, c):
    sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)


def torchvision_resnet34(seed=0):
    """conv1/bn1, layer{1..4}.{b}.{conv1,bn1,conv2,bn2,downsample.0/.1} and
    fc, with torchvision's names and shapes."""
    rng = np.random.default_rng(seed)
    sd = {}
    _conv_entries(rng, sd, "conv1", 64, 3, 7, bias=False)
    _bn_entries(rng, sd, "bn1", 64)
    cin = 64
    for s, (n, c) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            _conv_entries(rng, sd, f"{t}.conv1", c, cin, 3, bias=False)
            _bn_entries(rng, sd, f"{t}.bn1", c)
            _conv_entries(rng, sd, f"{t}.conv2", c, c, 3, bias=False)
            _bn_entries(rng, sd, f"{t}.bn2", c)
            if b == 0 and s > 0:
                _conv_entries(rng, sd, f"{t}.downsample.0", c, cin, 1,
                              bias=False)
                _bn_entries(rng, sd, f"{t}.downsample.1", c)
            cin = c
    sd["fc.weight"] = rng.normal(0, 0.01, (1000, 512)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def reference_ssd300(seed=1):
    """A reference SSD_300 ``cnn_state_dict`` (`Model.py:128-200`)."""
    rng = np.random.default_rng(seed)
    sd = {}
    vgg = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128),
           10: (256, 128), 12: (256, 256), 14: (256, 256), 17: (512, 256),
           19: (512, 512), 21: (512, 512)}
    for idx, (o, i) in vgg.items():
        _conv_entries(rng, sd, f"conv_4_3.{idx}", o, i, 3)
    for idx in (1, 3, 5):
        _conv_entries(rng, sd, f"seq5.{idx}", 512, 512, 3)
    _conv_entries(rng, sd, "conv_fc6", 1024, 512, 3)
    _conv_entries(rng, sd, "conv_fc7", 1024, 1024, 1)
    sd["rescaling_conv_4_3"] = rng.uniform(10, 30, (1, 512, 1, 1)).astype(
        np.float32)
    for name, ((o1, i1, k1), (o2, i2, k2)) in {
            "seq8": ((256, 1024, 1), (512, 256, 3)),
            "seq9": ((128, 512, 1), (256, 128, 3)),
            "seq10": ((128, 256, 1), (256, 128, 3)),
            "seq11": ((128, 256, 1), (256, 128, 3))}.items():
        _conv_entries(rng, sd, f"{name}.0", o1, i1, k1)
        _conv_entries(rng, sd, f"{name}.2", o2, i2, k2)
    for name, (o, i) in {"c_4_bb": (16, 512), "c_4_cl": (84, 512),
                         "c_7_bb": (24, 1024), "c_7_cl": (126, 1024),
                         "c_8_bb": (24, 512), "c_8_cl": (126, 512),
                         "c_9_bb": (24, 256), "c_9_cl": (126, 256),
                         "c_10_bb": (16, 256), "c_10_cl": (84, 256),
                         "c_11_bb": (16, 256), "c_11_cl": (84, 256)}.items():
        _conv_entries(rng, sd, name, o, i, 3)
    return sd


def test_subsample_matches_jax():
    x = np.arange(8 * 2 * 7 * 7, dtype=np.float32).reshape(8, 2, 7, 7)
    for steps in ([2, None, None, None], [None, None, 3, 3],
                  [4, None, 3, 3]):
        got = tconvert.subsample(x, steps)
        np.testing.assert_array_equal(got, jconvert.subsample(x, steps))
    assert tconvert.subsample(x, [4, None, 3, 3]).shape == (2, 2, 3, 3)


def test_vgg16_trunk_params_match_jax():
    sd = torchvision_vgg16()
    got = tconvert.vgg16_trunk_params(sd)
    _assert_same(got, tconvert.from_flax_params(
        {"trunk": jconvert.vgg16_trunk_params(sd)}))
    assert got["trunk.conv_fc6.weight"].shape == (1024, 512, 3, 3)
    assert got["trunk.conv_fc7.weight"].shape == (1024, 1024, 1, 1)
    # A torch tensor state_dict converts to the same numbers.
    tsd = {"classifier.0.weight": torch.from_numpy(sd["classifier.0.weight"])}
    got_t = tconvert.vgg16_trunk_params({**sd, **tsd})
    assert torch.equal(got_t["trunk.conv_fc6.weight"],
                       got["trunk.conv_fc6.weight"])
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True)
    merged = tconvert.merge_state_dict(model.state_dict(), got)
    model.load_state_dict(merged, strict=True)
    assert torch.equal(model.trunk.conv4_3.weight, got["trunk.conv4_3.weight"])


def test_ssd300_reference_params_match_jax(tmp_path):
    sd = reference_ssd300()
    got = tconvert.ssd300_reference_params(sd)
    _assert_same(got, tconvert.from_flax_params(
        jconvert.ssd300_reference_params(sd)))
    model = build_model(tconfig.ModelConfig(), device="cpu")
    assert set(got) == set(model.state_dict())
    model.load_state_dict(got, strict=True)
    # The checkpoint file as `train_function.py:114-120` writes it.
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "cnn_state_dict": {
        k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    _assert_same(tconvert.load_reference_checkpoint(str(path)), got)


def test_resnet34_trunk_params_match_jax():
    sd = torchvision_resnet34()
    got = tconvert.resnet34_trunk_params(sd)
    tree = jconvert.resnet34_trunk_params(sd)
    _assert_same(got, tconvert.from_flax_params(
        {"params": {"trunk": tree["params"]},
         "batch_stats": {"trunk": tree["batch_stats"]}}))
    model = build_model(tconfig.ModelConfig(backbone="resnet34"),
                        device="cpu", train=True)
    trunk = {k: v for k, v in model.state_dict().items()
             if k.startswith("trunk.")}
    assert set(got) == set(trunk)
    np.testing.assert_array_equal(
        got["trunk.layer3_block1.downsample_bn.running_var"].numpy(),
        sd["layer3.0.downsample.1.running_var"])


def test_merge_state_dict_checks_names_and_shapes():
    base = {"a.weight": torch.zeros(2, 3), "a.bias": torch.zeros(2),
            "bn.running_var": torch.ones(2)}
    merged = tconvert.merge_state_dict(
        base, {"a.bias": np.asarray([1.0, 2.0], np.float64)})
    assert merged["a.bias"].dtype == torch.float32
    assert merged["a.bias"].tolist() == [1.0, 2.0]
    assert merged["a.weight"] is base["a.weight"]
    assert base["a.bias"].tolist() == [0.0, 0.0]
    with pytest.raises(KeyError, match="b.weight"):
        tconvert.merge_state_dict(base, {"b.weight": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        tconvert.merge_state_dict(base, {"a.weight": torch.zeros(3, 2)})


class _Loader:
    """What `Trainer.__init__` reads of a Loader: its length."""

    def __len__(self):
        return 4


@pytest.mark.parametrize("ema_decay", [0.0, 0.99])
def test_trainer_merges_init_weights_and_reseeds_ema(ema_decay):
    sd = torchvision_resnet34()
    init = tconvert.resnet34_trunk_params(sd)
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(backbone="resnet34", image_size=224),
        train=tconfig.TrainConfig(ema_decay=ema_decay))
    random_init = Trainer(cfg, _Loader(), device="cpu").state
    trainer = Trainer(cfg, _Loader(), device="cpu", init_state_dict=init)
    weights = trainer.state.model.state_dict()
    for name, value in init.items():
        assert torch.equal(weights[name], value), name
    # The rest keeps the seed's random init.
    assert torch.equal(weights["neck0.conv.weight"],
                       random_init.model.state_dict()["neck0.conv.weight"])
    if ema_decay:
        params = dict(trainer.state.model.named_parameters())
        assert set(trainer.state.ema) == set(params)
        for name, p in params.items():
            assert torch.equal(trainer.state.ema[name], p), name
        assert not torch.equal(random_init.ema["trunk.stem_conv.weight"],
                               trainer.state.ema["trunk.stem_conv.weight"])
    else:
        assert trainer.state.ema is None
    with pytest.raises(KeyError, match="trunk.conv1_1.weight"):
        # A VGG trunk entry laid over the ResNet-34 model.
        Trainer(cfg, _Loader(), device="cpu", init_state_dict={
            "trunk.conv1_1.weight": torch.zeros(64, 3, 3, 3)})

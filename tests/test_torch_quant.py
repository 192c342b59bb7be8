"""int8 quantization of the PyTorch port against the JAX package: the int8
conv (the plain version of kernel K3 on the CPU), calibration, the scale
trees and their files, the quantized SSD300 and ResNet-34 forwards and
the Detector (QAT: `test_torch_quant_train.py`).  Inputs come from numpy
seeds and go through both packages; weights cross with
`from_flax_params`.

Tolerances, with their reasons:
  * the int8 conv, f32 / bf16 / int8 output: bit-equal (an exact integer
    sum, then the same IEEE f32 epilogue);
  * calibration: rtol 1e-5 (each conv's input comes from float convs that
    XLA and oneDNN sum in another order; measured 2.0e-6 on SSD300);
  * the scale trees: equal (the same numpy expressions on the same stats);
  * the int8 SSD300 forward on one JAX-calibrated tree: loc/conf to
    rtol 1e-4 / atol 5e-5, as the float forward (`test_torch_model.py`):
    the 23 quantized convs are exact in both, only the float heads and
    the L2Norm sum in another order (measured 1.0e-5 on conf of ~3.5);
    chained == unchained bit for bit;
  * the int8 ResNet-34 convs, each on JAX's own input from its jitted
    forward: 1e-6 (XLA's jit rounds the rescale an ulp apart); the forward
    end to end: within the quantization noise (the test's docstring says
    why it is not bit-equal);
  * detections: valid and classes equal, scores and boxes to 1e-4.
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.infer import detector as jdetector
from objectdetection_ssd_tpu.infer import postprocess as jpost
from objectdetection_ssd_tpu.infer import quant as jquant
from objectdetection_ssd_tpu.models import layers as jlayers
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.models.ssd import SSDResNet34 as JSSDResNet34
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.infer import detector as tdetector
from objectdetection_ssd_torch.infer import quant as tquant
from objectdetection_ssd_torch.models import layers as tlayers
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.layers import ConvQuant, TorchConv
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops import int8_conv as k3
from objectdetection_ssd_torch.ops import priors as tpriors
from objectdetection_ssd_torch.train import state as tstate
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return _t(x.transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _conv(cin, cout, k, s, p, d, use_bias, kernel, bias):
    conv = TorchConv(cin, cout, kernel=k, stride=s, padding=p, dilation=d,
                     use_bias=use_bias)
    with torch.no_grad():
        conv.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
        if use_bias:
            conv.bias.copy_(_t(bias))
    return conv


def _quant(s, dtype, out_scale=None, straight_through=False):
    scalar = lambda v: torch.clamp_min(torch.tensor(v, dtype=torch.float32),
                                       1e-12)                 # noqa: E731
    return ConvQuant(scalar(s), None if out_scale is None
                     else scalar(out_scale), dtype, straight_through)


# ------------------------------------------------------------ the int8 conv

# (kernel, stride, padding, dilation, Cin, Cout, H, W, bias): every value
# of the SSD300 / ResNet-34 geometry (kernels 1, 3, 7; strides 1, 2;
# padding 0, 1, 3, 4; dilation 1, 4), Cin 3, 8, 64 and Cout 8, 126, on odd
# maps.
GEOMETRY = [
    (1, 1, 0, 1, 64, 126, 7, 9, True),
    (3, 1, 1, 1, 3, 8, 11, 9, True),
    (3, 2, 1, 1, 8, 126, 9, 11, True),
    (3, 1, 4, 4, 64, 8, 11, 13, True),
    (7, 2, 3, 1, 3, 8, 15, 13, False),
    (3, 1, 0, 1, 64, 126, 5, 5, True),
    (1, 2, 0, 1, 8, 8, 9, 7, False),
    (3, 2, 0, 1, 64, 8, 9, 9, True),
    (7, 1, 3, 1, 8, 126, 9, 9, True),
    (3, 2, 4, 4, 3, 126, 13, 11, True),
]


@pytest.mark.parametrize("geo", GEOMETRY, ids=lambda g: "k{}s{}p{}d{}c{}o{}".format(*g))
def test_int8_conv_bit_equal_to_jax(geo):
    """JAX `Int8Conv` and the port's int8 branch (the plain version of K3)
    on the same float input, weights and scales: f32 and bf16 output, int8
    output with ``out_scale`` through either dtype, and an int8 (chained)
    input."""
    k, s, p, d, cin, cout, h, w, use_bias = geo
    rng = np.random.default_rng(sum(geo))
    x = rng.normal(0, 1, (2, h, w, cin)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    # 0.8 of the range, so that the largest inputs clip.
    s_a = np.float32(np.abs(x).max() * 0.8 / 127)
    s_o = np.float32(0.05)
    params = {"kernel": kernel}
    if use_bias:
        params["bias"] = bias
    conv = _conv(cin, cout, k, s, p, d, use_bias, kernel, bias)
    x_q = np.clip(np.round(x / s_a), -127, 127).astype(np.int8)
    for name, (jdt, tdt) in _DTYPES.items():
        jconv = jlayers.Int8Conv(features=cout, kernel=k, stride=s,
                                 padding=p, dilation=d, use_bias=use_bias,
                                 dtype=jdt)
        jx = jnp.asarray(x, jdt)
        tx = _nchw(x).to(tdt)
        for out_scale in (None, s_o):
            want = np.asarray(jconv.apply({"params": params}, jx,
                                          jnp.float32(s_a), out_scale))
            conv.quant = _quant(s_a, tdt, out_scale)
            with torch.no_grad():
                got = conv(tx)
            assert got.dtype == (torch.int8 if out_scale else tdt)
            np.testing.assert_array_equal(_nhwc(got), _f32(want),
                                          err_msg=f"{name} {out_scale}")
        want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x_q),
                                      jnp.float32(s_a)))
        conv.quant = _quant(s_a, tdt)
        with torch.no_grad():
            got = conv(_nchw(x_q))
        np.testing.assert_array_equal(_nhwc(got), _f32(want))


def test_int8_conv_exact_on_representable_inputs():
    """`tests/test_quant.py:41`: inputs and weights already on the int8
    grid round-trip losslessly, so the int8 conv equals the float conv."""
    rng = np.random.default_rng(0)
    s_a = 0.25
    x = (rng.integers(-127, 128, (2, 9, 9, 8)) * s_a).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 8, 16))
    s_w = np.abs(w).max(axis=(0, 1, 2)) / 127.0
    w = (np.round(w / s_w) * s_w).astype(np.float32)
    conv = _conv(8, 16, 3, 2, 1, 1, True, w, np.zeros(16, np.float32))
    conv.quant = _quant(s_a, torch.float32)
    with torch.no_grad():
        got = conv(_nchw(x))
        ref = F.conv2d(_nchw(x), conv.weight, conv.bias, 2, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_int8_conv_clips_to_calibrated_range():
    """`tests/test_quant.py:64`: an input beyond the calibrated absmax
    saturates at 127 steps."""
    conv = _conv(1, 1, 1, 1, 0, 1, False, np.ones((1, 1, 1, 1), np.float32),
                 None)
    conv.quant = _quant(np.float32(10.0 / 127.0), torch.float32)
    with torch.no_grad():
        got = conv(torch.full((1, 1, 1, 1), 100.0))
    np.testing.assert_allclose(float(got), 10.0, rtol=1e-6)


def test_int8_conv_wrapper_checks_and_counts_no_cpu_launch():
    """The wrapper runs the plain version on CPU tensors, without counting
    a kernel launch, and refuses what K3 does not take."""
    rng = np.random.default_rng(1)
    x_q = _t(rng.integers(-127, 128, (1, 16, 5, 5)).astype(np.int8))
    w_q = _t(rng.integers(-127, 128, (8, 3, 3, 16)).astype(np.int8))
    scale = torch.full((8,), 0.01)
    before = k3.launches
    y = k3.int8_conv(x_q, w_q, scale, None, 1, 1, 1, torch.float32)
    assert k3.launches == before and y.shape == (1, 8, 5, 5)
    with pytest.raises(TypeError):
        k3.int8_conv(x_q.float(), w_q, scale, None, 1, 1, 1, torch.float32)
    with pytest.raises(ValueError):
        k3.int8_conv(x_q, w_q, scale[:4], None, 1, 1, 1, torch.float32)
    with pytest.raises(ValueError):
        k3.int8_conv(x_q, w_q, scale, None, 1, 1, 1, torch.float16)
    with pytest.raises(ValueError):
        k3.int8_conv(x_q, w_q.permute(0, 3, 1, 2), scale, None, 1, 1, 1,
                     torch.float32)


def test_weight_cache_follows_the_weights():
    """The int8 weights are quantized once per weight version: an update
    in place or a load re-quantizes, so a quantized model never serves
    the int8 weights of older float weights."""
    conv = TorchConv(8, 4, kernel=3, padding=1)
    conv.quant = _quant(0.05, torch.float32)
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y0 = conv(x)
        w_q0 = conv.int8_weight()[0]
        assert conv.int8_weight()[0] is w_q0              # cached
        conv.weight.mul_(-1.0)
        y1 = conv(x)
    assert conv.int8_weight()[0] is not w_q0
    torch.testing.assert_close(conv.int8_weight()[0], -w_q0, rtol=0, atol=0)
    assert not torch.equal(y0, y1)
    conv.load_state_dict({k: v * 2 for k, v in conv.state_dict().items()})
    with torch.no_grad():
        conv(x)
    w_q2, s_w2 = conv.int8_weight()
    ref_q, ref_s = k3.quantize_weight(conv.weight)
    assert torch.equal(w_q2, ref_q) and torch.equal(s_w2, ref_s)


def test_int8_branch_wins_over_the_k2_route():
    """`layers.py:218-234`: with a scale the int8 branch runs; the K2
    filter-gradient route is ignored."""
    routed = TorchConv(8, 8, kernel=3, padding=1, dw_pallas=True)
    plain = TorchConv(8, 8, kernel=3, padding=1)
    plain.load_state_dict(routed.state_dict())
    x = torch.randn(1, 8, 5, 5, generator=torch.Generator().manual_seed(1))
    for conv in (routed, plain):
        conv.quant = _quant(0.02, torch.float32)
    with torch.no_grad():
        assert torch.equal(routed(x), plain(x))
        routed.quant = None
        assert not torch.equal(routed(x), plain(x))


def test_int8_max_pool_commutes_with_quantization():
    """`tests/test_quant.py:201`: max pooling the int8 tensor equals
    quantizing the pooled float tensor (plain, padded pool5-style and
    ceil-mode pools), in channels_last too."""
    rng = np.random.default_rng(0)
    x = _nchw(rng.normal(0, 1, (2, 7, 7, 4)).astype(np.float32))
    s = torch.tensor(float(x.abs().max()) / 127.0)
    q = k3.quantize_activation(x, s)
    for kw in (dict(window=2, stride=2),
               dict(window=3, stride=1, padding=1),
               dict(window=2, stride=2, ceil_mode=True)):
        pooled_q = tlayers.max_pool(q, **kw)
        assert pooled_q.dtype == torch.int8
        assert torch.equal(pooled_q,
                           k3.quantize_activation(tlayers.max_pool(x, **kw),
                                                  s))


# ----------------------------------------------------------- scale trees

def _stats():
    return {"trunk": {"conv1_1": {"absmax": np.float32(2.54)},
                      "conv1_2": {"absmax": np.float32(7.0)},
                      "conv2_2": {"absmax": np.float32(3.0)}},
            "seq8_1": {"absmax": np.float32(1.5)},
            "seq8_2": {"absmax": np.float32(4.0)},
            "loc_head_0": {"absmax": np.float32(1.0)},
            "conf_t4": {"absmax": np.float32(1.0)}}


def _equal_trees(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, dict):
            _equal_trees(got[key], w)
        else:
            assert np.float32(got[key]) == np.float32(w), key


def test_scale_trees_match_jax():
    stats = _stats()
    for heads in (False, True):
        want = jquant.act_scales(stats, quantize_heads=heads)
        got = tquant.act_scales(stats, quantize_heads=heads)
        _equal_trees(got, want)
        assert tquant.count_quantized(got) == jquant.count_quantized(want)
        for backbone in ("vgg16", "resnet34"):
            chained = tquant.chain_scales(got, backbone)
            _equal_trees(chained, jquant.chain_scales(want, backbone))
            _equal_trees(tquant.unchain_scales(chained),
                         jquant.unchain_scales(jquant.chain_scales(
                             want, backbone)))
            assert (tquant.count_quantized(chained)
                    == tquant.count_quantized(got))
    assert tquant.count_quantized(tquant.act_scales(stats)) == 5
    assert tquant.VGG16_CHAIN_EDGES == jquant.VGG16_CHAIN_EDGES
    assert tquant.CHAIN_EDGES == jquant.CHAIN_EDGES
    assert tquant.DEFAULT_EXCLUDE_PREFIXES == jquant.DEFAULT_EXCLUDE_PREFIXES
    assert tquant.SCALES_FILENAME == jquant.SCALES_FILENAME
    keep = lambda path: path[0] == "trunk"                  # noqa: E731
    _equal_trees(tquant.act_scales(stats, keep=keep),
                 jquant.act_scales(stats, keep=keep))


def test_save_load_scales_round_trip_and_jax_files(tmp_path):
    qtree = tquant.chain_scales(tquant.act_scales(_stats()), "vgg16")
    path = str(tmp_path / "q.json")
    tquant.save_scales(qtree, path, fingerprint=["a" * 64, "b" * 64],
                       epoch=3)
    _equal_trees(tquant.load_scales(path), qtree)
    assert tquant.load_scales_meta(path) == {
        "param_fingerprint": "a" * 64,
        "param_fingerprints": ["a" * 64, "b" * 64], "epoch": 3}
    # A JAX-written file loads into the same tree, and the port's file is
    # the JAX file byte for byte.
    jpath = str(tmp_path / "j.json")
    jquant.save_scales(jquant.chain_scales(jquant.act_scales(_stats()),
                                           "vgg16"), jpath,
                       fingerprint=["a" * 64, "b" * 64], epoch=3)
    _equal_trees(tquant.load_scales(jpath), qtree)
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    _equal_trees(jquant.load_scales(path), jquant.load_scales(jpath))
    # Tensor leaves save as their values.
    tpath = str(tmp_path / "t.json")
    tquant.save_scales(tquant.scales_to(qtree, "cpu"), tpath)
    _equal_trees(tquant.load_scales(tpath), qtree)
    with open(tpath, "w") as f:
        json.dump({"format": "other"}, f)
    with pytest.raises(ValueError):
        tquant.load_scales(tpath)


def test_param_fingerprint_binding(tmp_path, capsys):
    """Stable across a checkpoint save and load, changed by one element;
    `verify_scales_binding` accepts the raw or the EMA weights' print."""
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True,
                        generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    fp = tquant.param_fingerprint(sd)
    state = tstate.create_train_state(tconfig.ModelConfig(),
                                      tconfig.OptimConfig(), device="cpu",
                                      model=model)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state)
    payload, _, _ = mgr.load()
    assert tquant.param_fingerprint(payload["model"]) == fp
    bf16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    assert tquant.param_fingerprint(bf16) != fp
    changed = {k: v.clone() for k, v in sd.items()}
    changed["seq9_2.bias"][3] += 1e-6
    assert tquant.param_fingerprint(changed) != fp
    path = str(tmp_path / "q.json")
    tquant.save_scales({"seq8_1": {"act_scale": np.float32(0.1)}}, path,
                       fingerprint=["0" * 64, fp])
    tquant.verify_scales_binding(path, sd)
    with pytest.raises(ValueError, match="--recalibrate"):
        tquant.verify_scales_binding(path, changed)
    tquant.save_scales({"seq8_1": {"act_scale": np.float32(0.1)}}, path)
    tquant.verify_scales_binding(path, changed)
    assert "no param fingerprint" in capsys.readouterr().err


def test_attach_raises_on_unknown_paths_and_keeps_the_state_dict():
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True)
    keys = set(model.state_dict())
    tquant.attach_scales(model, {"trunk": {"conv1_1": {
        "act_scale": np.float32(0.1), "out_scale": np.float32(0.2)}}})
    assert model.trunk.conv1_1.quant.out_scale is not None
    assert model.trunk.conv1_2.quant is None
    assert set(model.state_dict()) == keys
    model.load_state_dict(model.state_dict(), strict=True)
    with pytest.raises(KeyError, match="conv9_9"):
        tquant.attach_scales(model, {"trunk": {"conv9_9": {
            "act_scale": np.float32(0.1)}}})
    with pytest.raises(KeyError):
        tquant.attach_scales(model, {"l2norm_4_3": {
            "act_scale": np.float32(0.1)}})
    with pytest.raises(ValueError):
        tquant.attach_scales(model, {"seq8_1": {"scale": np.float32(0.1)}})
    tquant.detach_scales(model)
    assert all(m.quant is None for m in model.modules()
               if isinstance(m, TorchConv))
    with tquant.scales_attached(model, {"seq8_1": {
            "act_scale": np.float32(0.1)}}, straight_through=True):
        assert model.seq8_1.quant.straight_through
    assert model.seq8_1.quant is None


# -------------------------------------------------------- SSD300 full width


@pytest.fixture(scope="module")
def ssd300():
    """JAX SSD300 at full width: its calibration over two images and its
    unchained int8 loc/conf on the first; the port's model (f32 weights,
    as the quantized Detector holds them)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 300, 300, 3), dtype=np.uint8)
    jmodel = JSSD300()
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3))))
    # Wide conf biases, so that the detections below have NMS work.
    variables = jax.tree_util.tree_map(np.array, variables)
    for i in range(6):
        b = variables["params"][f"conf_head_{i}"]["Conv_0"]["bias"]
        b[...] = rng.normal(0.0, 3.0, b.shape)
    jstats = jquant.calibrate(jmodel, variables["params"], [images])
    qtree = jquant.act_scales(jstats)
    japply = jax.jit(jmodel.apply)
    jloc, jconf = jax.device_get(japply(
        {"params": variables["params"], "quant": qtree},
        jnp.asarray(images[:1])))
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True)
    model.load_state_dict(from_flax_params(variables), strict=True)
    model.eval()
    return images, variables, jstats, qtree, np.asarray(jloc), \
        np.asarray(jconf), model, japply


def test_calibrate_ssd300_matches_jax(ssd300):
    images, _, jstats, _, _, _, model, _ = ssd300
    stats = tquant.calibrate(model, [images[:1], images[1:]])
    want = jax.tree_util.tree_flatten_with_path(jstats)[0]
    assert len(want) == 35
    for path, value in want:
        node = stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, value, rtol=1e-5,
                                   err_msg=str(path))
    assert tquant.count_quantized(tquant.act_scales(stats)) == 23
    assert model.training is False


def test_ssd300_int8_forward_matches_jax_chained_and_unchained(ssd300):
    images, _, _, qtree, jloc, jconf, model, _ = ssd300
    x = torch.from_numpy(images[:1])
    outs = {}
    for chained in (False, True):
        tree = tquant.chain_scales(qtree, "vgg16") if chained else qtree
        tquant.attach_scales(model, tree)
        with torch.inference_mode():
            outs[chained] = model(x)
        loc, conf = outs[chained]
        assert loc.shape == (1, 8732, 4) and conf.dtype == torch.float32
        np.testing.assert_allclose(loc.numpy(), jloc, rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(conf.numpy(), jconf, rtol=1e-4,
                                   atol=5e-5)
    tquant.detach_scales(model)
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])
    with torch.inference_mode():
        loc_f, _ = model(x)
    assert not torch.equal(loc_f, outs[False][0])        # it did quantize


def test_ssd300_int8_bf16_chained_equals_unchained(ssd300):
    """The bf16 serving model: the chained epilogue rounds through bf16
    first, so chaining changes no bit there either."""
    images, variables, _, qtree, _, _, _, _ = ssd300
    cfg = tconfig.ModelConfig(compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu", train=True).eval()
    model.load_state_dict(from_flax_params(variables), strict=True)
    outs = []
    for tree in (qtree, tquant.chain_scales(qtree, "vgg16")):
        tquant.attach_scales(model, tree)
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(images[:1])))
    assert outs[0][0].dtype == torch.bfloat16
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_detector_int8_detections_match_jax(ssd300):
    """`Detector(quant=)` against JAX's postprocess of its int8 forward
    (what JAX's `Detector(quant=)` computes), chained."""
    images, variables, _, qtree, jloc, jconf, _, _ = ssd300
    pp = dict(per_class_top_k=16, top_k=20, use_approx_top_k=False,
              anchor_prefilter=0)
    want = jax.device_get(jpost.postprocess(
        jnp.asarray(jloc), jnp.asarray(jconf),
        jnp.asarray(tpriors.ssd300_priors()),
        jconfig.PostprocessConfig(**pp)))
    det = tdetector.Detector(
        tconfig.Config(), from_flax_params(variables),
        postprocess_config=tconfig.PostprocessConfig(**pp), device="cpu",
        quant=tquant.chain_scales(qtree, "vgg16"))
    assert next(det.model.parameters()).dtype == torch.float32
    got = det.detect_batch(images[:1])
    valid = np.asarray(want.valid)
    assert valid.sum() > 5
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid], atol=1e-4)


def test_int8_with_flip_tta_matches_jax(ssd300):
    """int8 composes with flip TTA: both views run the quantized convs.
    JAX's side is its `forward_for_postprocess` and `postprocess` (what its
    `Detector` runs) over the port's chained int8 model, whose forward the
    tests above hold to JAX's; an XLA int8 forward of SSD300 costs ~16 s
    on the CPU."""
    images, variables, _, qtree, _, _, model, _ = ssd300
    chained = tquant.chain_scales(qtree, "vgg16")
    tquant.attach_scales(model, chained)

    class JModel:
        @staticmethod
        def apply(v, x, train=False):
            with torch.inference_mode():
                out = model(torch.from_numpy(np.array(x)))
            return tuple(jnp.asarray(o.numpy()) for o in out)

    pp = dict(per_class_top_k=16, top_k=20, use_approx_top_k=False,
              anchor_prefilter=0, tta_flip=True)
    jpp = jconfig.PostprocessConfig(**pp)
    priors = jnp.asarray(tpriors.ssd300_priors())
    jloc, jconf, jpri = jdetector.forward_for_postprocess(
        JModel, None, jnp.asarray(images[:1]), priors, jpp)
    tquant.detach_scales(model)
    want = jax.device_get(jpost.postprocess(jloc, jconf, jpri, jpp))
    det = tdetector.Detector(
        tconfig.Config(), from_flax_params(variables),
        postprocess_config=tconfig.PostprocessConfig(**pp), device="cpu",
        quant=chained)
    got = det.detect_batch(images[:1])
    valid = np.asarray(want.valid)
    assert valid.sum() > 5
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid], atol=1e-4)


# ----------------------------------------------------- ResNet-34 full width


@pytest.fixture(scope="module")
def resnet():
    jmodel = JSSDResNet34(dropout_rate=0.0)
    variables = jax.device_get(jax.jit(functools.partial(
        jmodel.init, train=False))(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 224, 224, 3))))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(5)
    for tap in ("t4", "t2", "t1"):
        b = variables["params"][f"conf_{tap}"]["Conv_0"]["bias"]
        b[...] = rng.normal(0.0, 3.0, b.shape)
    images = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    jstats = jquant.calibrate(jmodel, variables["params"], [images],
                              batch_stats=variables["batch_stats"])
    qtree = jquant.act_scales(jstats)
    paths = []

    def forward(v, x):
        """JAX's int8 forward, returning every TorchConv call's input and
        output beside (loc, conf)."""
        calls = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if (isinstance(context.module, jlayers.TorchConv)
                    and context.method_name == "__call__"):
                paths.append(context.module.path)
                calls.append((args[0], out))
            return out

        with fnn.intercept_methods(record):
            out = jmodel.apply(v, x)
        return out, calls

    out, calls = jax.device_get(jax.jit(forward)(dict(variables, quant=qtree),
                                                 jnp.asarray(images)))
    jfloat = jax.device_get(jax.jit(jmodel.apply)(variables,
                                                  jnp.asarray(images)))
    calls = [(path, x, y) for path, (x, y) in zip(paths, calls)]
    return variables, images, qtree, out, jfloat, calls


def test_resnet34_int8_convs_bit_equal_to_jax(resnet):
    """Every quantized conv call of JAX's int8 ResNet-34 forward (the stem,
    the 36 block and projection convs, ``neck0``, ``neck_down`` twice,
    ``neck_down2``), replayed through the port's attached conv on the same
    input, and the port calibrates the same scales.  To 1e-6: under `jit`
    XLA rounds the epilogue's rescale differently by an ulp (the eager
    `Int8Conv` above is bit-equal), while a wrong int8 step would be off by
    a whole scale."""
    variables, images, qtree, _, _, calls = resnet
    assert tquant.count_quantized(qtree) == 39
    assert tquant.chain_scales(qtree, "resnet34") == qtree
    model = _resnet_port(variables)
    stats = tquant.calibrate(model, [images])
    _close_trees(tquant.act_scales(stats), qtree, rtol=1e-5)
    tquant.attach_scales(model, qtree)
    modules = dict(model.named_modules())
    quantized = 0
    for path, x, want in calls:
        conv = modules[".".join(path)]
        if conv.quant is None:
            continue
        quantized += 1
        with torch.inference_mode():
            got = conv(_nchw(np.asarray(x)))
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=str(path))
    assert quantized == 40                 # neck_down runs twice


def _resnet_port(variables):
    model = build_model(tconfig.ModelConfig(backbone="resnet34",
                                            image_size=224, dropout_rate=0.0),
                        device="cpu", train=True).eval()
    model.load_state_dict(from_flax_params(variables), strict=True)
    return model


def _close_trees(got, want, rtol):
    for path, value in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, value, rtol=rtol, err_msg=str(path))


def test_resnet34_int8_forward_tracks_jax(resnet):
    """End to end the two int8 ResNet-34 forwards are not bit-equal: the
    port's eval BatchNorm (`F.batch_norm`) rounds a few outputs one ulp
    away from flax's, a later quantizer rounds one of them to the other
    int8 step, and 36 quantized convs in a row spread such steps.  So the
    port's int8 outputs are held to JAX's by the size of the quantization
    noise itself: their mean difference at most that between JAX's int8
    and float outputs times 1.5 (two int8 results whose roundings
    diverged are two draws of that noise, so their difference is up to
    sqrt(2) times each one's distance from the float result; measured
    1.05 times on loc), correlation above 0.999 (measured 0.9995)."""
    variables, images, qtree, jq, jf, _ = resnet
    model = tquant.attach_scales(_resnet_port(variables), qtree)
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
    for g, q, f in zip(got, jq, jf):
        g, q, f = g.numpy().ravel(), np.asarray(q).ravel(), \
            np.asarray(f).ravel()
        assert np.abs(g - q).mean() <= 1.5 * np.abs(q - f).mean()
        assert np.corrcoef(g, q)[0, 1] > 0.999

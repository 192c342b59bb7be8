"""The ResNet-34 family of the PyTorch port against the JAX package: the
prior generators, flax's BatchNorm and Dropout semantics, `SSDResNet34` at
full width (224 px, 189 priors) in eval and train mode, one full train
step, flip TTA and the Detector with Soft-NMS.  Weights and BN statistics
cross with `from_flax_params`; inputs come from numpy seeds.

Tolerances, with their reasons:
  * priors and `mirror_permutation`: bit-equal / index-equal (the same
    numpy code);
  * a standalone BN layer: output and updated statistics to 1e-6 (the same
    f32 formula, reductions summed in another order); bf16 output to 1e-2
    (one bf16 rounding of values ~3);
  * the full model in eval mode to rtol 1e-4 / atol 5e-5, as SSD300: XLA
    and oneDNN sum the conv products in another order, 36 convs deep;
  * train mode with dropout 0: the running statistics to 1e-5; the
    outputs to 1e-4 of their largest magnitude with a frozen trunk and
    5e-4 without.  At the 1x1 taps a batch of 2 gives each BN two values
    per channel, and after a ReLU many channels are nearly constant:
    there BN multiplies the f32 rounding of its input by up to
    1/sqrt(eps) ~ 316.  Against an f64 run of the port, both f32 results
    are off by the same order (measured on loc: the port 7.7e-5 and JAX
    2.7e-5 with the trunk frozen, 3.5e-4 and 4.1e-4 without, on outputs
    up to ~4), so neither package is the closer one;
  * one train step: loss to 1e-4, gradients to 5e-3 of their largest, as
    the SSD300 step (`test_torch_train.py`); a loc head's conv bias feeds
    a train-mode BN, which removes it, so its true gradient is 0 and both
    packages give rounding noise (< 1e-7);
  * flip TTA's merge to 1e-5: both sides merge JAX's forward outputs of
    the two views (the forwards themselves are held above), so what
    differs is the box decode and encode (2 ulp exp/log);
  * detections to 1e-4, as `test_torch_detector.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.infer import detector as jdetector
from objectdetection_ssd_tpu.models.ssd import SSDResNet34 as JSSDResNet34
from objectdetection_ssd_tpu.ops import priors as jpriors
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.infer import detector as tdetector
from objectdetection_ssd_torch.infer import postprocess as tpost
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.layers import BatchNorm, Dropout
from objectdetection_ssd_torch.models.ssd import SSDResNet34, build_model
from objectdetection_ssd_torch.ops import priors as tpriors
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return _t(x.transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


# ---------------------------------------------------------------- priors


@pytest.mark.parametrize("reference_order", [True, False])
def test_zoom_ratio_priors_bit_equal_to_jax(reference_order):
    got = tpriors.zoom_ratio_priors(reference_order)
    want = jpriors.zoom_ratio_priors(reference_order)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (189, 4)


def test_resnet34_priors_bit_equal_to_jax():
    got = tpriors.priors_for_model(tconfig.ModelConfig(backbone="resnet34"))
    want = jpriors.priors_for_model(jconfig.ModelConfig(backbone="resnet34"))
    assert got.shape == (189, 4) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Row-major (cx fast) here, x-slow in the reference generator.
    assert got[9, 0] > got[0, 0] and got[9, 1] == got[0, 1]
    zoom, _ = tpriors.zoom_ratio_priors(False)
    assert zoom[9, 0] == zoom[0, 0] and zoom[9, 1] > zoom[0, 1]


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("shape,train,dtype", [
    ((2, 5, 5, 8), True, "float32"),
    ((2, 1, 1, 8), True, "float32"),       # one value per channel and image
    ((1, 1, 1, 8), True, "float32"),       # one value per channel: var 0
    ((2, 5, 5, 8), False, "float32"),
    ((2, 5, 5, 8), True, "bfloat16"),
    ((2, 5, 5, 8), False, "bfloat16"),
])
def test_batchnorm_matches_flax(shape, train, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.5, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=not train, dtype=jdt)
    want, upd = bn.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x).astype(jdt), mutable=["batch_stats"])
    layer = BatchNorm(c)
    sd = from_flax_params({"params": {"bn": params},
                           "batch_stats": {"bn": stats}})
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    layer.train(train)
    tdt = getattr(torch, dtype)
    got = layer(_nchw(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_nhwc(got), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    new = upd["batch_stats"]
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-6, atol=1e-6)
    if not train:
        np.testing.assert_array_equal(layer.running_var.numpy(),
                                      stats["var"])


def test_dropout_masks_scaling_and_generator():
    x = torch.ones(3, 16, 5, 5)
    rate = 0.25
    for channelwise in (True, False):
        layer = Dropout(rate, channelwise=channelwise).train()
        y = layer(x, torch.Generator().manual_seed(0))
        kept = y != 0
        # Kept values are scaled by 1 / (1 - rate), dropped ones are 0.
        assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
        planes = kept.reshape(3, 16, 25)
        constant = (planes.all(-1) | (~planes).all(-1)).all()
        assert bool(constant) == channelwise
        assert 0.5 < kept.float().mean() < 0.95
        again = layer(x, torch.Generator().manual_seed(0))
        assert torch.equal(y, again)
        assert not torch.equal(y, layer(x, torch.Generator().manual_seed(1)))
        with pytest.raises(ValueError, match="Generator"):
            layer(x)
        assert layer.eval()(x) is x
    assert Dropout(0.0).train()(x) is x


def test_dropout_generator_follows_seed_and_step():
    def state_of(*layers):
        model = torch.nn.Sequential(torch.nn.Conv2d(1, 1, 1), *layers)
        return tstate.TrainState(model, *tstate.make_optimizer(
            model.named_parameters(), tconfig.OptimConfig()))

    state = state_of(Dropout(0.5, channelwise=True))
    x = torch.ones(2, 256, 4, 4)
    layer = state.model[1].train()

    def mask(seed, step):
        state.step = step
        return layer(x, tloop.dropout_generator(state, seed)) != 0

    assert torch.equal(mask(10, 5), mask(10, 5))
    assert not torch.equal(mask(10, 5), mask(10, 6))
    assert not torch.equal(mask(10, 5), mask(11, 5))
    # The generator lives on the model's device.
    assert tloop.dropout_generator(state_of(), 10).device == x.device


# ---------------------------------------------------------------- full width


def _variables(seed=0):
    """JAX SSDResNet34 variables at 224 px with BN scales, biases and
    running statistics drawn away from their init, as numpy."""
    jmodel = JSSDResNet34(dropout_rate=0.0)
    variables = jax.device_get(jax.jit(functools.partial(
        jmodel.init, train=False))(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 224, 224, 3))))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(seed)

    def perturb(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, path + (k,))
            elif k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == "scale":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias" and path[-1].endswith("bn"):
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)

    perturb(variables["params"])
    perturb(variables["batch_stats"])
    return jmodel, variables


@pytest.fixture(scope="module")
def resnet():
    jmodel, variables = _variables()
    images = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3),
                                               dtype=np.uint8)
    return jmodel, variables, images


def _port(variables, freeze_backbone=True, train=False):
    cfg = tconfig.ModelConfig(backbone="resnet34", image_size=224,
                              dropout_rate=0.0,
                              freeze_backbone=freeze_backbone)
    model = build_model(cfg, device="cpu", train=train)
    model.load_state_dict(from_flax_params(variables), strict=True)
    return model


def test_from_flax_params_covers_the_resnet_state_dict(resnet):
    _, variables, _ = resnet
    sd = from_flax_params(variables)
    model = SSDResNet34()
    assert set(sd) == set(model.state_dict())
    assert len([k for k in sd if k.endswith("running_var")]) == 36 + 6
    np.testing.assert_array_equal(
        sd["trunk.layer2_block1.downsample_bn.running_var"].numpy(),
        variables["batch_stats"]["trunk"]["layer2_block1"]["downsample_bn"]
        ["var"])
    np.testing.assert_array_equal(
        sd["neck_down.bn.weight"].numpy(),
        variables["params"]["neck_down"]["bn"]["scale"])
    assert (model.conf_t4.bias == -2.0).all()


def test_resnet34_eval_forward_matches_jax_full_width(resnet):
    jmodel, variables, images = resnet
    jloc, jconf = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    model = _port(variables)
    assert not model.training
    with torch.inference_mode():
        loc, conf = model(_t(images))
    assert loc.shape == (2, 189, 4) and conf.shape == (2, 189, 21)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=1e-4,
                               atol=5e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-4,
                               atol=5e-5)


@pytest.mark.parametrize("freeze_backbone", [True, False])
def test_resnet34_train_mode_matches_jax(resnet, freeze_backbone):
    """dropout 0: outputs and every updated running statistic, with
    neck_down's two updates in sequence; a frozen trunk keeps its BN in
    eval mode and its statistics unchanged."""
    _, variables, images = resnet
    jmodel = JSSDResNet34(dropout_rate=0.0, freeze_backbone=freeze_backbone)
    (jloc, jconf), upd = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
    model = _port(variables, freeze_backbone=freeze_backbone, train=True)
    assert model.training and model.trunk.training == (not freeze_backbone)
    loc, conf = model(_t(images))
    tol = 1e-4 if freeze_backbone else 5e-4
    for got, want in ((loc, jloc), (conf, jconf)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    want = from_flax_params({"params": {}, "batch_stats":
                             jax.device_get(upd["batch_stats"])})
    before = from_flax_params(variables)
    got = model.state_dict()
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        if name.startswith("trunk.") and freeze_backbone:
            assert torch.equal(got[name], before[name]), name
        moved += not torch.equal(got[name], before[name])
    assert moved == (2 * 6 if freeze_backbone else 2 * 42)


def _grad_capture():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


def test_resnet34_train_step_matches_jax(resnet):
    """One full train step, frozen trunk, dropout 0."""
    _, variables, images = resnet
    rng = np.random.default_rng(2)
    boxes = np.zeros((2, 4, 4), np.float32)
    classes = np.zeros((2, 4), np.int32)
    mask = np.zeros((2, 4), bool)
    for i, n in enumerate((3, 2)):
        lo = rng.uniform(0.0, 0.5, (n, 2))
        boxes[i, :n] = np.concatenate([lo, lo + rng.uniform(0.2, 0.5, (n, 2))],
                                      1)
        classes[i, :n] = rng.integers(0, 20, n)
        mask[i, :n] = True
    batch = {"images": images, "boxes": boxes, "classes": classes,
             "mask": mask}
    priors = tpriors.resnet34_priors()

    jmodel = JSSDResNet34(dropout_rate=0.0)
    tx = _grad_capture()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"],
                            opt_state=tx.init(variables["params"]), tx=tx,
                            apply_fn=jmodel.apply,
                            batch_stats=variables["batch_stats"])
    step = jax.jit(functools.partial(jloop.train_step,
                                     loss_config=jconfig.LossConfig()))
    new_jst, jmetrics = step(jst, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jnp.asarray(priors))
    jgrads = from_flax_params(jax.device_get(new_jst.opt_state))
    jstats = from_flax_params({"params": {}, "batch_stats": jax.device_get(
        new_jst.batch_stats)})

    cfg = tconfig.ModelConfig(backbone="resnet34", image_size=224,
                              dropout_rate=0.0)
    state = tstate.create_train_state(
        cfg, tconfig.OptimConfig(use_lr_schedule=False), device="cpu",
        state_dict=from_flax_params(variables))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = tloop.train_step(state, batch, _t(priors))
    assert float(metrics["num_pos"]) == float(jmetrics["num_pos"]) > 0
    for k in ("loss", "cls_loss", "loc_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    params = dict(state.model.named_parameters())
    for name, w in jgrads.items():
        if name.startswith("trunk."):
            assert params[name].grad is None and not w.abs().max(), name
            continue
        w = w.numpy()
        if name.startswith("loc_") and name.endswith("conv.bias"):
            assert np.abs(w).max() < 1e-7, name
            assert params[name].grad.abs().max() < 1e-7, name
            continue
        np.testing.assert_allclose(params[name].grad.numpy(), w, rtol=0,
                                   atol=5e-3 * np.abs(w).max(), err_msg=name)
    after = state.model.state_dict()
    for name, t in after.items():
        if name.startswith("trunk."):
            assert torch.equal(t, before[name]), name
    for name, w in jstats.items():
        np.testing.assert_allclose(after[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert state.step == 1


# ---------------------------------------------------------------- TTA


@pytest.mark.parametrize("backbone", ["vgg16", "resnet34"])
def test_mirror_permutation_index_equal_to_jax(backbone):
    priors = tpriors.priors_for_model(tconfig.ModelConfig(backbone=backbone))
    got = tdetector.mirror_permutation(priors)
    want = jdetector.mirror_permutation(priors)
    assert got is not None and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if backbone == "vgg16":
        np.testing.assert_array_equal(got[got], np.arange(len(got)))
    else:
        # The duplicated (0.5, 0.5, 1, 1): both map to the last of them.
        dup = np.flatnonzero((priors == [0.5, 0.5, 1.0, 1.0]).all(1))
        assert len(dup) == 2 and (got[dup] == dup[-1]).all()
    shifted = priors.copy()
    shifted[0, 0] += 0.013
    assert tdetector.mirror_permutation(shifted) is None
    assert jdetector.mirror_permutation(shifted) is None


@pytest.mark.parametrize("merge", ["averaged", "union"])
def test_forward_for_postprocess_tta_matches_jax(resnet, merge):
    """The port's merge runs on JAX's forward of whatever images it is
    given, so the flip (``images.flip(2)``) and the merge are what is
    compared."""
    jmodel, variables, images = resnet
    priors = tpriors.resnet34_priors().copy()
    if merge == "union":
        priors[5, 0] += 0.013                # no mirror partner
    jloc, jconf, jpri = jdetector.forward_for_postprocess(
        jmodel, variables, jnp.asarray(images), jnp.asarray(priors),
        jconfig.PostprocessConfig(tta_flip=True))
    apply = jax.jit(jmodel.apply)

    def jax_forward(x):
        return tuple(_t(np.asarray(o)) for o in apply(variables,
                                                       jnp.asarray(x.numpy())))

    perm = tdetector.mirror_permutation(priors)
    assert (perm is None) == (merge == "union")
    loc, conf, pri = tdetector.forward_for_postprocess(
        jax_forward, _t(images), _t(priors),
        tconfig.PostprocessConfig(tta_flip=True),
        None if perm is None else torch.from_numpy(perm).long())
    p = 189 if merge == "averaged" else 2 * 189
    assert loc.shape == (2, p, 4) and conf.shape == (2, p, 21)
    np.testing.assert_array_equal(pri.numpy(), np.asarray(jpri))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-5,
                               atol=1e-5)
    no_tta = tdetector.forward_for_postprocess(
        jax_forward, _t(images), _t(priors), tconfig.PostprocessConfig())
    assert no_tta[0].shape == (2, 189, 4) and no_tta[2].shape == (189, 4)


@pytest.mark.parametrize("nms_method,tta_flip", [
    ("hard", False), ("soft_gaussian", True), ("soft_linear", False)])
def test_detector_matches_jax(resnet, nms_method, tta_flip):
    """The slice as a whole: `Detector.detect_batch` of both packages on
    the ResNet-34 model, with conf biases drawn wide so that NMS has
    work."""
    _, variables, images = resnet
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(3)
    for tap in ("t4", "t2", "t1"):
        bias = variables["params"][f"conf_{tap}"]["Conv_0"]["bias"]
        bias[...] = rng.normal(0.0, 3.0, bias.shape)
    jcfg = jconfig.Config(model=jconfig.ModelConfig(backbone="resnet34",
                                                    image_size=224))
    tcfg = tconfig.Config(model=tconfig.ModelConfig(backbone="resnet34",
                                                    image_size=224))
    pp = dict(nms_method=nms_method, tta_flip=tta_flip)
    jdet = jdetector.Detector(jcfg, variables["params"],
                              variables["batch_stats"],
                              postprocess_config=jconfig.PostprocessConfig(
                                  **pp))
    tdet = tdetector.Detector(tcfg, from_flax_params(variables),
                              postprocess_config=tconfig.PostprocessConfig(
                                  **pp), device="cpu")
    want = jax.device_get(jdet.detect_batch(jnp.asarray(images)))
    got = tdet.detect_batch(images)
    valid = np.asarray(want.valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid], atol=1e-4)
    if nms_method == "hard":
        loc, conf = tdet.forward(images)
        cand, _, cvalid = tpost.select_candidates(loc, conf, tdet.priors,
                                                  tdet.pp_config)
        keep = tpost.greedy_nms_mask(tpost.box_ops.pairwise_iou(cand, cand),
                                     cvalid, 0.45)
        assert (cvalid & ~keep).any()


def test_bn_statistics_ride_checkpoints_resume_and_ema(tmp_path):
    """Save, resume, `checkpoint_weights(use_ema=True)` and
    `Detector.from_checkpoint`: the BN running statistics travel with the
    state_dict; the EMA covers parameters only, so ``--use-ema`` serves
    the averaged weights beside the live statistics."""
    from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(backbone="resnet34", image_size=224),
        train=tconfig.TrainConfig(checkpoint_dir=str(tmp_path),
                                  ema_decay=0.5))
    state = tstate.create_train_state(cfg.model, cfg.optim, device="cpu",
                                      ema=True)
    with torch.no_grad():
        state.model.neck_down.bn.running_var.fill_(3.0)
        state.model.trunk.stem_bn.running_mean.fill_(0.25)
        state.model.neck0.conv.weight.add_(1.0)        # EMA lags behind
    CheckpointManager(str(tmp_path)).save(0, state)
    fresh = tstate.create_train_state(cfg.model, cfg.optim, device="cpu",
                                      ema=True)
    fresh, _, epoch = CheckpointManager(str(tmp_path)).restore(fresh)
    assert epoch == 0
    for name, t in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], t), name
    assert not any("running" in n for n in fresh.ema)

    weights, _ = tdetector.checkpoint_weights(cfg, use_ema=True)
    assert torch.equal(weights["neck_down.bn.running_var"],
                       torch.full((256,), 3.0))
    assert torch.equal(weights["neck0.conv.weight"],
                       state.ema["neck0.conv.weight"])
    det = tdetector.Detector.from_checkpoint(cfg, use_ema=True, device="cpu")
    assert torch.equal(det.model.trunk.stem_bn.running_mean,
                       torch.full((64,), 0.25))
    assert det.model.trunk.stem_bn.running_mean.dtype == torch.float32
    dets = det.detect_batch(np.zeros((1, 224, 224, 3), np.uint8))
    assert dets.boxes_xyxy.shape == (1, 200, 4)

"""The train slice of the PyTorch port against the JAX package: config,
`collate`, the matcher, the multibox loss, the optimizer, the trunk's
freezing, one full-width SSD300 `train_step`, and five steps of a small
model.  Inputs come from numpy seeds and go through both packages; weights
cross with `from_flax_params`.

Tolerances, with their reasons:
  * matcher: bit-equal (the same f32 expression, first-index argmax);
  * loss values to rtol 1e-5 and its loc/conf gradients to 1e-5 of their
    largest magnitude (logsumexp and the reductions round differently in
    the two libraries: measured 4.3e-7); inputs have no CE ties, where
    the top-k gradient depends on the order of equal values;
  * optimizer: 1e-6 absolute over 4 steps (the same elementwise f32 ops);
  * the full-width step: loss to rtol 1e-4, each gradient leaf within
    5e-3 of its largest magnitude.  XLA and oneDNN sum conv products in
    another order, and that noise flips a few discrete choices: a max-pool
    window whose two largest values are within it (pool5's 3x3 windows
    overlap), a ReLU input at ~0.  Each flip moves one position's
    gradient; the worst leaf measured 3.4e-3 (conv5_3), the same with and
    without the K2 route.  The routed and unrouted port, which make the
    same choices, agree to 1e-4 of each leaf's largest magnitude;
  * five small-model steps: losses to rtol 1e-4, parameters within 1e-4 of
    each tensor's largest magnitude.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.data import pipeline as jpipeline
from objectdetection_ssd_tpu.losses import multibox as jmultibox
from objectdetection_ssd_tpu.models import backbones as jbackbones
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_tpu.ops import boxes as jboxes
from objectdetection_ssd_tpu.ops import matching as jmatching
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.data import pipeline as tpipeline
from objectdetection_ssd_torch.losses import multibox as tmultibox
from objectdetection_ssd_torch.models import backbones as tbackbones
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.layers import TorchConv, flatten_head
from objectdetection_ssd_torch.ops import matching as tmatching
from objectdetection_ssd_torch.ops.priors import ssd300_priors
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate

torch.set_num_threads(2)

ROUTED = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_boxes(rng, n):
    lo = rng.uniform(0.0, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([lo, lo + wh], 1).astype(np.float32)


def _gt_batch(rng, counts, max_boxes):
    """Padded GT: real rows first, padded rows with finite garbage."""
    b = len(counts)
    boxes = rng.uniform(-1, 2, (b, max_boxes, 4)).astype(np.float32)
    classes = rng.integers(-3, 30, (b, max_boxes)).astype(np.int32)
    mask = np.zeros((b, max_boxes), bool)
    for i, n in enumerate(counts):
        boxes[i, :n] = _random_boxes(rng, n)
        classes[i, :n] = rng.integers(0, 20, n)
        mask[i, :n] = True
    return boxes, classes, mask


# ---------------------------------------------------------------- config


def test_config_fields_match_jax():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(tconfig.LossConfig) == fields(jconfig.LossConfig)
    assert fields(tconfig.OptimConfig) == fields(jconfig.OptimConfig)
    assert fields(tconfig.DataConfig) == fields(jconfig.DataConfig)
    jtrain, ttrain = fields(jconfig.TrainConfig), fields(tconfig.TrainConfig)
    assert ttrain == {name: jtrain[name] for name in ttrain}
    jm, tm = fields(jconfig.ModelConfig), fields(tconfig.ModelConfig)
    for name in ("freeze_stages", "dw_pallas_convs", "compute_dtype",
                 "freeze_backbone", "dropout_rate"):
        assert tm[name] == jm[name]


def test_collate_matches_jax():
    rng = np.random.default_rng(0)
    examples = []
    for i, n in enumerate((3, 0, 7)):
        img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        boxes = _random_boxes(rng, n)
        classes = rng.integers(0, 20, n).astype(np.int32)
        examples.append((img, boxes, classes, 10 + i))
    want = jpipeline.collate([jpipeline.Example(*e) for e in examples], 5)
    got = tpipeline.collate([tpipeline.Example(*e) for e in examples], 5)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    empty = tpipeline.collate([], 4, image_size=8, image_dtype=np.uint8)
    assert empty["images"].shape == (0, 8, 8, 3)
    with pytest.raises(ValueError):
        tpipeline.collate([], 4)


# ---------------------------------------------------------------- matcher


def test_match_batch_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    priors = ssd300_priors()
    priors_xyxy = np.asarray(jboxes.cxcywh_to_xyxy(jnp.asarray(priors)))
    boxes, classes, mask = _gt_batch(rng, (4, 0, 6), max_boxes=6)
    # Image 0: objects 1 and 3 share their best prior; the last one wins.
    boxes[0, 3] = boxes[0, 1] + np.float32(0.002)
    best = np.argmax(np.asarray(jmatching._iou_gt_priors(
        jnp.asarray(boxes[0]), jnp.asarray(priors_xyxy))), axis=1)
    assert best[1] == best[3]

    want = jmatching.match_batch(jnp.asarray(boxes), jnp.asarray(classes),
                                 jnp.asarray(mask), jnp.asarray(priors_xyxy))
    got = tmatching.match_batch(_t(boxes), _t(classes), _t(mask),
                                _t(priors_xyxy))
    for name in ("matched_class", "matched_obj", "matched_iou"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got.matched_box.numpy(),
                                  np.asarray(want.matched_box))
    assert got.matched_obj[0, best[1]] == 3
    assert (got.matched_class[1] == tconfig.BACKGROUND_CLASS).all()
    single = tmatching.match_single(_t(boxes[2]), _t(classes[2]),
                                    _t(mask[2]), _t(priors_xyxy))
    np.testing.assert_array_equal(single.matched_class.numpy(),
                                  np.asarray(want.matched_class[2]))


# ---------------------------------------------------------------- loss


def _loss_inputs(seed, counts=(3, 5), max_boxes=6):
    rng = np.random.default_rng(seed)
    priors = ssd300_priors()
    p = priors.shape[0]
    offsets = rng.normal(0, 1, (len(counts), p, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (len(counts), p, 21)).astype(np.float32)
    return (offsets, logits) + _gt_batch(rng, counts, max_boxes) + (priors,)


@pytest.mark.parametrize("loss_config", [
    tconfig.LossConfig(),                         # partial top-k branch
    tconfig.LossConfig(hnm_topk=8),               # 3*N_pos > 8: full sort
    tconfig.LossConfig(hnm_topk=0),               # always the full sort
    tconfig.LossConfig(loc_loss="huber"),
], ids=["topk", "topk_too_small", "full_sort", "huber"])
def test_multibox_loss_and_grads_match_jax(loss_config):
    offsets, logits, boxes, classes, mask, priors = _loss_inputs(3)
    jcfg = jconfig.LossConfig(**dataclasses.asdict(loss_config))

    def jloss(o, lg):
        out = jmultibox.multibox_loss(o, lg, jnp.asarray(boxes),
                                      jnp.asarray(classes), jnp.asarray(mask),
                                      jnp.asarray(priors), jcfg)
        return out.total, out

    (_, want), (jgo, jgl) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(offsets), jnp.asarray(logits))
    o, lg = _t(offsets).requires_grad_(), _t(logits).requires_grad_()
    got = tmultibox.multibox_loss(o, lg, _t(boxes), _t(classes), _t(mask),
                                  _t(priors), loss_config)
    got.total.backward()

    assert int(got.num_pos) == int(want.num_pos) > 0
    assert 3 * int(got.num_pos) > 8
    for name in ("total", "cls", "loc"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5)
    for g, w in ((o.grad, jgo), (lg.grad, jgl)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_multibox_loss_without_objects_and_single_image():
    offsets, logits, boxes, classes, mask, priors = _loss_inputs(
        4, counts=(0, 2))
    jcfg, tcfg = jconfig.LossConfig(), tconfig.LossConfig()
    want = jmultibox.multibox_loss(*(jnp.asarray(a) for a in (
        offsets, logits, boxes, classes, mask, priors)), jcfg)
    got = tmultibox.multibox_loss(*(_t(a) for a in (
        offsets, logits, boxes, classes, mask, priors)), tcfg)
    np.testing.assert_allclose(float(got.total), float(want.total),
                               rtol=1e-5)
    empty = tmultibox.multibox_loss(*(_t(a[:1]) for a in (
        offsets, logits, boxes, classes, mask)), _t(priors), tcfg)
    assert int(empty.num_pos) == 0 and float(empty.total) == 0.0

    n = int(mask[1].sum())
    want1 = jmultibox.multibox_loss_single(
        jnp.asarray(offsets[1]), jnp.asarray(logits[1]),
        jnp.asarray(boxes[1, :n]), jnp.asarray(classes[1, :n]),
        jnp.asarray(priors), jcfg)
    got1 = tmultibox.multibox_loss_single(
        _t(offsets[1]), _t(logits[1]), _t(boxes[1, :n]), _t(classes[1, :n]),
        _t(priors), tcfg)
    np.testing.assert_allclose(float(got1.total), float(want1.total),
                               rtol=1e-5)


def test_focal_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (4, 21)).astype(np.float32)
    targets = (rng.uniform(size=(4, 21)) < 0.2).astype(np.float32)
    want = jax.value_and_grad(jmultibox.focal_loss)(jnp.asarray(logits),
                                                    jnp.asarray(targets))
    lg = _t(logits).requires_grad_()
    got = tmultibox.focal_loss(lg, _t(targets))
    got.backward()
    np.testing.assert_allclose(float(got), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------- optimizer


def test_optimizer_matches_optax_chain():
    """4 steps with the same gradients: bias 2x lr, wd before momentum,
    step decay, warmup and a frozen prefix."""
    rng = np.random.default_rng(6)
    shapes = {("trunk", "conv1_1", "kernel"): (3, 3, 2, 4),
              ("trunk", "conv1_1", "bias"): (4,),
              ("head", "kernel"): (3, 3, 4, 5), ("head", "bias"): (5,),
              ("l2norm", "scale"): (5,)}
    init = {k: rng.normal(0, 0.5, s).astype(np.float32)
            for k, s in shapes.items()}
    cfg = dict(lr=0.1, lr_decay_epochs=2, lr_decay_gamma=0.5,
               use_lr_schedule=True, warmup_steps=3)

    tree = {}
    for path, value in init.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(value)
    tx = jstate.make_optimizer(jconfig.OptimConfig(**cfg), steps_per_epoch=1,
                               frozen_prefixes=("trunk/conv1_1",))
    opt_state = tx.init(tree)

    names = {path: ".".join(path).replace("kernel", "weight")
             for path in init}
    params = {path: torch.nn.Parameter(_t(v.copy()))
              for path, v in init.items()}
    opt, sched = tstate.make_optimizer(
        [(names[p], params[p]) for p in init], tconfig.OptimConfig(**cfg),
        steps_per_epoch=1, frozen_prefixes=("trunk.conv1_1",))
    assert not params[("trunk", "conv1_1", "kernel")].requires_grad
    assert sorted(g["initial_lr"] for g in opt.param_groups) == [0.1, 0.2]

    for _ in range(4):
        grads = {p: rng.normal(0, 1, shapes[p]).astype(np.float32)
                 for p in init}
        gtree = jax.tree_util.tree_map(lambda x: x, tree)
        for path, g in grads.items():
            node = gtree
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = jnp.asarray(g)
        updates, opt_state = tx.update(gtree, opt_state, tree)
        tree = optax.apply_updates(tree, updates)

        opt.zero_grad()
        for path, p in params.items():
            if p.requires_grad:
                p.grad = _t(grads[path])
        opt.step()
        sched.step()
        for path, p in params.items():
            node = tree
            for key in path:
                node = node[key]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(node),
                                       rtol=0, atol=1e-6,
                                       err_msg=names[path])
    np.testing.assert_array_equal(
        params[("trunk", "conv1_1", "kernel")].detach().numpy(),
        init[("trunk", "conv1_1", "kernel")])


def test_step_decay_schedule_and_bias_paths():
    sched = tstate.step_decay_schedule(1.0, 0.1, steps_per_epoch=10,
                                       decay_epochs=7)
    jsched = jstate.step_decay_schedule(1.0, 0.1, steps_per_epoch=10,
                                        decay_epochs=7)
    for count in (0, 69, 70, 140):
        assert sched(count) == pytest.approx(float(jsched(count)))
    assert tstate.is_bias_path("trunk.conv1_1.bias")
    assert not tstate.is_bias_path("trunk.conv1_1.weight")
    assert not tstate.is_bias_path("l2norm_4_3.scale")


# ---------------------------------------------------------------- freezing


def test_vgg_frozen_prefixes_match_jax():
    for n in range(6):
        assert tbackbones.vgg_frozen_prefixes(n) == tuple(
            p.replace("/", ".") for p in jbackbones.vgg_frozen_prefixes(n))
    assert tbackbones.VGG_STAGE_PARAMS == jbackbones.VGG_STAGE_PARAMS


def test_trunk_freeze_cuts_gradients_like_jax():
    """freeze_stages=2 at 32 px: conv1/conv2 get no gradient (and no K2
    launch: conv2_2 is routed), conv3 onward match JAX's gradients."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (1, 32, 32, 3)).astype(np.float32)
    jtrunk = jbackbones.VGG16Trunk(freeze_stages=2)
    params = jax.jit(jtrunk.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    c4, fc7 = jtrunk.apply(params, jnp.asarray(x))
    p4 = rng.normal(size=c4.shape).astype(np.float32)
    p7 = rng.normal(size=fc7.shape).astype(np.float32)

    def jloss(p):
        a, b = jtrunk.apply(p, jnp.asarray(x))
        return jnp.sum(a * p4) + jnp.sum(b * p7)

    jgrads = from_flax_params(jax.device_get(jax.grad(jloss)(params)))
    trunk = tbackbones.VGG16Trunk(freeze_stages=2,
                                  dw_pallas_convs=("conv2_2", "conv3_1"))
    trunk.load_state_dict(from_flax_params(jax.device_get(params)),
                          strict=True)
    a, b = trunk(_t(x).permute(0, 3, 1, 2))
    loss = torch.sum(a.permute(0, 2, 3, 1) * _t(p4)) + torch.sum(
        b.permute(0, 2, 3, 1) * _t(p7))
    loss.backward()
    for name, param in trunk.named_parameters():
        if name.split(".")[0] in {"conv1_1", "conv1_2", "conv2_1",
                                  "conv2_2"}:
            assert param.grad is None, name
            assert not np.abs(jgrads[name].numpy()).any(), name
        else:
            w = jgrads[name].numpy()
            np.testing.assert_allclose(param.grad.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_create_train_state_freezes_and_groups():
    state = tstate.create_train_state(
        tconfig.ModelConfig(freeze_stages=1, compute_dtype="bfloat16"),
        tconfig.OptimConfig(lr=1e-3), device="cpu",
        generator=torch.Generator().manual_seed(0))
    model = state.model
    assert model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"trunk.conv1_1.weight", "trunk.conv1_1.bias",
                      "trunk.conv1_2.weight", "trunk.conv1_2.bias"}
    in_opt = {id(p) for g in state.optimizer.param_groups
              for p in g["params"]}
    assert len(in_opt) == sum(1 for p in model.parameters()
                              if p.requires_grad)
    lrs = {g["initial_lr"]: len(g["params"])
           for g in state.optimizer.param_groups}
    assert set(lrs) == {1e-3, 2e-3} and state.step == 0


# ---------------------------------------------------------------- full width


def _grad_capture():
    """An optax transformation whose state becomes the raw gradients and
    whose update is zero: JAX `train_step` then hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


@pytest.fixture(scope="module")
def full_width_step():
    """JAX `train_step` on SSD300 at 300 px, batch 1, f32 (one compile),
    and the port's step from the same bridged weights with the four conv1/
    conv2 convs routed (the plain K2 on the CPU)."""
    rng = np.random.default_rng(8)
    boxes, classes, mask = _gt_batch(rng, (3,), max_boxes=4)
    batch = {"images": rng.integers(0, 256, (1, 300, 300, 3),
                                    dtype=np.uint8),
             "boxes": boxes, "classes": classes, "mask": mask}
    priors = ssd300_priors()
    jmodel = JSSD300()
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3))))
    tx = _grad_capture()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"],
                            opt_state=tx.init(variables["params"]), tx=tx,
                            apply_fn=jmodel.apply)
    step = jax.jit(functools.partial(jloop.train_step,
                                     loss_config=jconfig.LossConfig()))
    new_jst, jmetrics = step(jst, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jnp.asarray(priors))
    jgrads = from_flax_params(jax.device_get(new_jst.opt_state))

    state = tstate.create_train_state(
        tconfig.ModelConfig(dw_pallas_convs=ROUTED),
        tconfig.OptimConfig(use_lr_schedule=False), device="cpu",
        state_dict=from_flax_params(variables))
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    state, metrics = tloop.train_step(state, batch, _t(priors))
    return (jax.device_get(jmetrics), jgrads, state, metrics, before,
            batch, priors)


def test_full_width_train_step_matches_jax(full_width_step):
    jmetrics, jgrads, state, metrics, _, _, _ = full_width_step
    assert set(metrics) == {"loss", "cls_loss", "loc_loss", "num_pos"}
    assert metrics["num_pos"].dtype == torch.float32
    assert float(metrics["num_pos"]) == float(jmetrics["num_pos"]) > 0
    for k in ("loss", "cls_loss", "loc_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    routed = {n for n, m in state.model.trunk.named_modules()
              if isinstance(m, TorchConv) and m.dw_route}
    assert routed == set(ROUTED)
    grads = dict(state.model.named_parameters())
    assert set(grads) == set(jgrads)
    for name, w in jgrads.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[name].grad.numpy(), w, rtol=0,
                                   atol=5e-3 * np.abs(w).max(),
                                   err_msg=name)


def test_full_width_routed_step_matches_cudnn_route(full_width_step):
    """The same step with ``dw_pallas_convs=()``: every gradient equals the
    routed step's to 1e-4 of its largest magnitude."""
    _, _, state, metrics, before, batch, priors = full_width_step
    plain = tstate.create_train_state(
        tconfig.ModelConfig(), tconfig.OptimConfig(use_lr_schedule=False),
        device="cpu", state_dict=before)
    plain, plain_metrics = tloop.train_step(plain, batch, _t(priors))
    assert float(plain_metrics["loss"]) == float(metrics["loss"])
    routed = dict(state.model.named_parameters())
    for name, p in plain.model.named_parameters():
        want = p.grad
        torch.testing.assert_close(routed[name].grad, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_full_width_step_updates_like_sgd(full_width_step):
    """The first update is -lr * (g + wd * p) (2x lr for biases), and the
    eval step leaves the state alone."""
    _, _, state, _, before, batch, priors = full_width_step
    cfg = tconfig.OptimConfig()
    for name, p in state.model.named_parameters():
        lr = cfg.lr * (cfg.bias_lr_multiplier if name.endswith(".bias")
                       else 1.0)
        want = before[name] - lr * (p.grad + cfg.weight_decay * before[name])
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7)
    assert state.step == 1
    after = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    m = tloop.eval_step(state, batch, _t(priors))
    assert set(m) == {"loss", "cls_loss", "loc_loss", "num_pos"}
    assert np.isfinite(float(m["loss"])) and state.step == 1
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), after[name]), name


@pytest.mark.parametrize("routed", [False, True], ids=["cudnn", "k2"])
def test_remat_step_equals_plain_step(full_width_step, routed):
    """``remat=True`` with freeze_stages=2, routed through K2 (its plain
    version here) and not: the same loss to 1e-6 and the same gradients to
    1e-6 of their largest; the checkpointed stages 3-5 run their forward
    twice (the recompute), the frozen stages 1-2 once."""
    _, _, _, _, before, batch, priors = full_width_step
    cfg = tconfig.ModelConfig(freeze_stages=2,
                              dw_pallas_convs=ROUTED + ("conv3_1",)
                              if routed else ())
    runs = {}
    for remat in (False, True):
        state = tstate.create_train_state(
            cfg, tconfig.OptimConfig(use_lr_schedule=False), device="cpu",
            state_dict=before)
        calls = {"conv1_1": 0, "conv3_1": 0}
        for name in calls:
            state.model.trunk.get_submodule(name).register_forward_hook(
                lambda *_, name=name: calls.__setitem__(name,
                                                        calls[name] + 1))
        state, metrics = tloop.train_step(state, batch, _t(priors),
                                          remat=remat)
        runs[remat] = (metrics, state, calls)
    (m0, s0, c0), (m1, s1, c1) = runs[False], runs[True]
    assert c0 == {"conv1_1": 1, "conv3_1": 1}
    assert c1 == {"conv1_1": 1, "conv3_1": 2}
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    plain = dict(s0.model.named_parameters())
    for name, p in s1.model.named_parameters():
        if name.split(".")[1] in {"conv1_1", "conv1_2", "conv2_1",
                                  "conv2_2"}:
            assert p.grad is None and plain[name].grad is None, name
            continue
        want = plain[name].grad
        torch.testing.assert_close(p.grad, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


# ---------------------------------------------------------------- small model


class JTiny(fnn.Module):
    """SSD-shaped: (B, 16, 16, 3) -> ((B, 16, 4), (B, 16, 21)), as
    `tests/test_train.py:TinySSD`."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.relu(fnn.Conv(8, (3, 3), strides=(4, 4), padding="SAME",
                              name="stem")(x))                 # 16 -> 4
        loc = fnn.Conv(4, (3, 3), padding="SAME", name="loc")(x)
        conf = fnn.Conv(21, (3, 3), padding="SAME", name="conf")(x)
        return (loc.reshape(x.shape[0], -1, 4),
                conf.reshape(x.shape[0], -1, 21))


class TTiny(torch.nn.Module):
    """The port's counterpart; its 3x3/s1/p1 heads take the K2 route."""

    def __init__(self):
        super().__init__()
        self.stem = TorchConv(3, 8, kernel=3, stride=4)   # SAME pads 0 here
        self.loc = TorchConv(8, 4, kernel=3, padding=1, dw_pallas=True)
        self.conf = TorchConv(8, 21, kernel=3, padding=1, dw_pallas=True)

    def forward(self, x, generator=None, remat=False):    # NHWC
        x = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        return flatten_head(self.loc(x), 4), flatten_head(self.conf(x), 21)


def _tiny_batch(bs=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (bs, 16, 16, 3)).astype(np.float32)
    boxes, classes, mask = _gt_batch(rng, [1 + i % 2 for i in range(bs)],
                                     max_boxes=3)
    return {"images": images, "boxes": boxes, "classes": classes,
            "mask": mask}


def test_small_model_five_steps_track_jax():
    centers = (np.arange(4) + 0.5) / 4
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    priors = np.stack([cx.ravel(), cy.ravel(), np.full(16, 0.25),
                       np.full(16, 0.25)], 1).astype(np.float32)
    batch = _tiny_batch()
    ocfg = dict(lr=0.05, use_lr_schedule=False)

    jst = jstate.create_train_state(JTiny(), jax.random.PRNGKey(0),
                                    jnp.asarray(batch["images"][:1]),
                                    jconfig.OptimConfig(**ocfg))
    step_fn, _ = jloop.make_jitted_steps(jnp.asarray(priors),
                                         jconfig.LossConfig(), mesh=None,
                                         donate=False)
    model = TTiny()
    params = jax.device_get(jst.params)
    model.load_state_dict({
        f"{m}.{'weight' if k == 'kernel' else k}":
            _t(v.transpose(3, 2, 0, 1) if k == "kernel" else v)
        for m, leaves in params.items() for k, v in leaves.items()},
        strict=True)
    state = tstate.TrainState(model, *tstate.make_optimizer(
        model.named_parameters(), tconfig.OptimConfig(**ocfg)))
    first = tloop.eval_step(state, batch, _t(priors))

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(5):
        jst, jm = step_fn(jst, jbatch)
        state, m = tloop.train_step(state, batch, _t(priors))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(float(first["loss"]), losses[0], rtol=1e-6)
    assert losses[-1] < losses[0]
    for m_name, leaves in jax.device_get(jst.params).items():
        for k, v in leaves.items():
            want = v.transpose(3, 2, 0, 1) if k == "kernel" else v
            name = f"{m_name}.{'weight' if k == 'kernel' else k}"
            got = dict(model.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)

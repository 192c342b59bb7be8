"""The port's Trainer, checkpoints, gradient accumulation and EMA against
the JAX package's, on a small detector pair: JAX's `TinyDet`
(`tests/test_end_to_end.py`) and a torch twin with its weights copied
across, fed the same batches by the two packages' Loaders.

Tolerances: the first train batch's loss to 1e-5 relative; per-epoch train
and test losses to 1e-4 relative (the conv summation order differs, and
SGD carries the difference through the epochs); accumulated updates and
the EMA to 1e-6.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.data import synthetic as jsynthetic
from objectdetection_ssd_tpu.data import voc as jvoc
from objectdetection_ssd_tpu.data.pipeline import Loader as JLoader
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_tpu.train.trainer import Trainer as JTrainer
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.data import voc
from objectdetection_ssd_torch.data.pipeline import Loader
from objectdetection_ssd_torch.infer.detector import checkpoint_weights
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate
from objectdetection_ssd_torch.train.checkpoint import CheckpointManager
from objectdetection_ssd_torch.train.trainer import Trainer

torch.set_num_threads(2)


class JTinyDet(fnn.Module):
    """`tests/test_end_to_end.py:TinyDet`: (B, 64, 64, 3) -> 16 priors."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(16, (5, 5), strides=(8, 8), padding="SAME")(x)  # 64->8
        x = fnn.relu(x)
        x = fnn.Conv(32, (3, 3), strides=(2, 2), padding="SAME")(x)  # 8->4
        x = fnn.relu(x)
        loc = fnn.Conv(4, (3, 3), padding="SAME")(x)
        conf = fnn.Conv(21, (3, 3), padding="SAME")(x)
        return loc.reshape(x.shape[0], -1, 4), conf.reshape(
            x.shape[0], -1, 21)


class TTinyDet(torch.nn.Module):
    """The twin: flax's SAME padding is none for the 5x5/8 conv at 64 px
    and (0, 1) for the 3x3/2 conv at 8 px."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(3, 16, 5, stride=8)
        self.Conv_1 = torch.nn.Conv2d(16, 32, 3, stride=2)
        self.Conv_2 = torch.nn.Conv2d(32, 4, 3, padding=1)
        self.Conv_3 = torch.nn.Conv2d(32, 21, 3, padding=1)

    def forward(self, x):                                  # NHWC
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        x = F.relu(self.Conv_1(F.pad(x, (0, 1, 0, 1))))
        n = x.shape[0]
        return (self.Conv_2(x).permute(0, 2, 3, 1).reshape(n, -1, 4),
                self.Conv_3(x).permute(0, 2, 3, 1).reshape(n, -1, 21))


def _twin(params) -> TTinyDet:
    model = TTinyDet()
    model.load_state_dict({
        f"{m}.{'weight' if k == 'kernel' else k}": torch.tensor(
            np.asarray(v).transpose(3, 2, 0, 1) if k == "kernel"
            else np.asarray(v))
        for m, leaves in jax.device_get(params).items()
        for k, v in leaves.items()}, strict=True)
    return model


def _assert_params_match(model, params, atol):
    got = dict(model.named_parameters())
    for m, leaves in jax.device_get(params).items():
        for k, v in leaves.items():
            v = np.asarray(v)
            want = v.transpose(3, 2, 0, 1) if k == "kernel" else v
            name = f"{m}.{'weight' if k == 'kernel' else k}"
            np.testing.assert_allclose(got[name].detach().numpy(), want,
                                       rtol=0, atol=atol, err_msg=name)


def _tiny_priors():
    centers = (np.arange(4) + 0.5) / 4
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    return np.stack([cx.ravel(), cy.ravel(), np.full(16, 0.3),
                     np.full(16, 0.3)], 1).astype(np.float32)


def _configs(root, ckpt, **train_kw):
    kw = dict(
        model=dict(image_size=64),
        data=dict(voc_root=str(root), batch_size=8, num_workers=0,
                  max_boxes=8),
        optim=dict(lr=0.01, use_lr_schedule=False),
        train=dict(num_epochs=2, seed=0, checkpoint_dir=str(ckpt),
                   log_every_steps=0, **train_kw))

    def build(mod):
        return mod.Config(model=mod.ModelConfig(**kw["model"]),
                          data=mod.DataConfig(**kw["data"]),
                          optim=mod.OptimConfig(**kw["optim"]),
                          train=mod.TrainConfig(**kw["train"]))
    return build(jconfig), build(tconfig)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    jsynthetic.generate_voc(str(root), num_2007=20, num_2012=4,
                            image_size=(96, 96), seed=7)
    return root


def _split(records):
    train_ids, val_ids = voc.train_val_split(len(records), 1 / 3, seed=10)
    return ([records[i] for i in train_ids], [records[i] for i in val_ids])


@pytest.fixture(scope="module")
def fitted(voc_root, tmp_path_factory):
    """Two epochs of the JAX Trainer and of the port's from the same
    weights, on the same batches (augment on, native)."""
    jcfg, tcfg = _configs(voc_root, tmp_path_factory.mktemp("ck"))
    jtr, jva = _split(jvoc.load_records(str(voc_root)))
    ttr, tva = _split(voc.load_records(str(voc_root)))
    jtrainer = JTrainer(
        jcfg, JLoader(jtr, jcfg.data, 64, train=True, seed=0),
        JLoader(jva, jcfg.data, 64, train=False, drop_last=True),
        model=JTinyDet(), priors=_tiny_priors())
    loaders = (Loader(ttr, tcfg.data, 64, train=True, seed=0),
               Loader(tva, tcfg.data, 64, train=False, drop_last=True))
    trainer = Trainer(tcfg, *loaders, model=_twin(jtrainer.state.params),
                      priors=_tiny_priors(), device="cpu")
    first = next(iter(loaders[0].epoch(0)))
    j_first = jloop.eval_step(jtrainer.state,
                              {k: jnp.asarray(v) for k, v in first.items()},
                              jnp.asarray(_tiny_priors()))
    t_first = tloop.eval_step(trainer.state, first, trainer.priors)
    jtrainer.fit()
    trainer.fit()
    return dict(jtrainer=jtrainer, trainer=trainer, loaders=loaders,
                cfg=tcfg, first=(float(j_first["loss"]),
                                 float(t_first["loss"])))


def test_first_batch_loss_matches_jax(fitted):
    want, got = fitted["first"]
    assert np.isfinite(got) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_history_and_step_match_jax(fitted):
    jtr, tr = fitted["jtrainer"], fitted["trainer"]
    assert len(tr.history["train"]) == len(tr.history["test"]) == 2
    for phase in ("train", "test"):
        np.testing.assert_allclose(tr.history[phase], jtr.history[phase],
                                   rtol=1e-4, err_msg=phase)
    assert tr.state.step == int(jtr.state.step) == 2 * len(
        fitted["loaders"][0])
    _assert_params_match(tr.state.model, jtr.state.params, atol=1e-4)
    stats = tr.phase_stats["train"]
    assert stats["images"] == 8 * len(fitted["loaders"][0])
    assert stats["steps"] == len(fitted["loaders"][0])


def test_resume_restores_history_and_weights(fitted):
    tr = fitted["trainer"]
    fresh = Trainer(fitted["cfg"], *fitted["loaders"], model=TTinyDet(),
                    priors=_tiny_priors(), device="cpu")
    assert fresh.maybe_resume()
    assert fresh.start_epoch == 2
    assert fresh.history == tr.history
    assert fresh.state.step == tr.state.step
    want = tr.state.model.state_dict()
    for name, t in fresh.state.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert (fresh.state.optimizer.state_dict()["state"].keys()
            == tr.state.optimizer.state_dict()["state"].keys())
    fresh.fit(num_epochs=3)                 # one more epoch
    assert fresh.state.step == 3 * len(fitted["loaders"][0])


def test_emergency_checkpoint_on_failure(fitted, tmp_path):
    cfg = fitted["cfg"].replace(train=dataclasses.replace(
        fitted["cfg"].train, checkpoint_dir=str(tmp_path / "ck")))
    trainer = Trainer(cfg, fitted["loaders"][0], None, model=TTinyDet(),
                      priors=_tiny_priors(), device="cpu")

    def fail_callback(epoch, tr):
        if epoch == 0:
            raise RuntimeError("injected fault")

    trainer.epoch_callback = fail_callback
    with pytest.raises(RuntimeError, match="injected fault"):
        trainer.fit()
    resumed = Trainer(cfg, fitted["loaders"][0], None, model=TTinyDet(),
                      priors=_tiny_priors(), device="cpu")
    assert resumed.maybe_resume() and resumed.start_epoch >= 1


def test_emergency_checkpoint_written_when_epoch_unsaved(fitted, tmp_path):
    """The failure comes before the epoch's regular save: the emergency
    save writes it, marked ``emergency``."""
    cfg = fitted["cfg"].replace(train=dataclasses.replace(
        fitted["cfg"].train, checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every_epochs=5))
    trainer = Trainer(cfg, fitted["loaders"][0], None, model=TTinyDet(),
                      priors=_tiny_priors(), device="cpu")

    def fail_callback(epoch, tr):
        raise RuntimeError("injected fault")

    trainer.epoch_callback = fail_callback
    with pytest.raises(RuntimeError, match="injected fault"):
        trainer.fit()
    _, meta, epoch = trainer.ckpt.load()
    assert epoch == 0 and meta["emergency"] is True
    assert len(meta["history"]["train"]) == 1


def test_eval_phase_covers_tail_like_jax(tmp_path):
    """11 records at batch 8, drop_last=False: the tail of 3 is padded, and
    the phase's loss is the loss over the 11 real images, as in JAX."""
    root = tmp_path / "voc"
    jsynthetic.generate_voc(str(root), num_2007=11, num_2012=0,
                            image_size=(64, 64), seed=5)
    jcfg, tcfg = _configs(root, tmp_path / "ck")
    jloader = JLoader(jvoc.load_records(str(root)), jcfg.data, 64,
                      train=False, drop_last=False)
    loader = Loader(voc.load_records(str(root)), tcfg.data, 64, train=False,
                    drop_last=False)
    assert len(loader) == len(jloader) == 2
    jtrainer = JTrainer(jcfg, jloader, eval_loader=jloader, model=JTinyDet(),
                        priors=_tiny_priors())
    trainer = Trainer(tcfg, loader, eval_loader=loader,
                      model=_twin(jtrainer.state.params),
                      priors=_tiny_priors(), device="cpu")
    got = trainer._run_phase(0, train=False)
    want = jtrainer._run_phase(0, train=False)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert trainer.phase_stats["test"]["images"] == 11


def test_device_prefetch_is_bit_identical_on_cpu(voc_root, tmp_path):
    records = voc.load_records(str(voc_root))

    def run(device_prefetch):
        _, cfg = _configs(voc_root, tmp_path / "ck",
                          device_prefetch=device_prefetch)
        trainer = Trainer(cfg, Loader(records, cfg.data, 64, seed=3),
                          model=_twin(JTinyDet().init(
                              jax.random.PRNGKey(1),
                              jnp.zeros((1, 64, 64, 3)))["params"]),
                          priors=_tiny_priors(), device="cpu")
        loss = trainer._run_phase(0, train=True)
        return loss, trainer.state.model.state_dict()

    loss_off, params_off = run(False)
    loss_on, params_on = run(True)
    assert loss_off == loss_on
    for name, t in params_off.items():
        assert torch.equal(t, params_on[name]), name


# ------------------------------------------- gradient accumulation and EMA


def test_grad_accumulation_matches_optax_multisteps():
    """k = 2 micro-steps per update, 8 micro-steps, with weight decay,
    momentum, 2x bias lr and a step decay on the update clock: the
    parameters after every micro-step equal `make_optimizer(...,
    grad_accum_steps=2)`'s to 1e-6, and do not move mid-window."""
    rng = np.random.default_rng(3)
    shapes = {("conv", "kernel"): (3, 3, 2, 4), ("conv", "bias"): (4,),
              ("head", "kernel"): (1, 1, 4, 5), ("head", "bias"): (5,)}
    init = {k: rng.normal(0, 0.5, s).astype(np.float32)
            for k, s in shapes.items()}
    cfg = dict(lr=0.1, lr_decay_epochs=1, lr_decay_gamma=0.5,
               use_lr_schedule=True, grad_accum_steps=2)
    tx = jstate.make_optimizer(jconfig.OptimConfig(**cfg), steps_per_epoch=2)
    tree = {m: {k: jnp.asarray(init[(m, k)]) for (mm, k) in init if mm == m}
            for m in ("conv", "head")}
    opt_state = tx.init(tree)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for m in ("conv", "head"):
                setattr(self, m, torch.nn.Module())
                for (mm, k), v in init.items():
                    if mm == m:
                        name = "weight" if k == "kernel" else k
                        getattr(self, m).register_parameter(
                            name, torch.nn.Parameter(torch.tensor(v)))

    net = Net()
    state = tstate.create_train_state(tconfig.ModelConfig(),
                                      tconfig.OptimConfig(**cfg),
                                      steps_per_epoch=2, model=net)
    params = dict(net.named_parameters())
    for micro in range(8):
        grads = {k: rng.normal(0, 1, s).astype(np.float32)
                 for k, s in shapes.items()}
        gtree = {m: {k: jnp.asarray(grads[(m, k)]) for (mm, k) in grads
                     if mm == m} for m in ("conv", "head")}
        updates, opt_state = tx.update(gtree, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        before = {n: p.detach().clone() for n, p in params.items()}
        state.optimizer.zero_grad()
        for (m, k), g in grads.items():
            params[f"{m}.{'weight' if k == 'kernel' else k}"].grad = (
                torch.tensor(g))
        moved = state.apply_gradients()
        assert moved == (micro % 2 == 1)
        for (m, k) in init:
            name = f"{m}.{'weight' if k == 'kernel' else k}"
            np.testing.assert_allclose(params[name].detach().numpy(),
                                       np.asarray(tree[m][k]), rtol=0,
                                       atol=1e-6, err_msg=name)
            if not moved:
                assert torch.equal(params[name].detach(), before[name])
    assert state.step == 8 and state.mini_step == 0
    assert state.scheduler.last_epoch == 4          # real updates


def test_ema_tracks_jax_over_five_steps():
    """EMA (d = 0.5) over 5 train steps of the tiny pair: seeded from the
    initial weights, e <- d*e + (1-d)*p per update; to 1e-6 of JAX's."""
    d = 0.5
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "boxes": np.tile(np.asarray([[0.1, 0.1, 0.5, 0.6],
                                          [0.4, 0.3, 0.9, 0.8]],
                                         np.float32), (4, 1, 1)),
             "classes": np.tile(np.asarray([3, 11], np.int32), (4, 1)),
             "mask": np.ones((4, 2), bool)}
    priors = _tiny_priors()
    ocfg = dict(lr=0.05, use_lr_schedule=False)
    jst = jstate.create_train_state(JTinyDet(), jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3)),
                                    jconfig.OptimConfig(**ocfg), ema=True)
    step, _ = jloop.make_jitted_steps(jnp.asarray(priors),
                                      jconfig.LossConfig(), mesh=None,
                                      donate=False, ema_decay=d)
    state = tstate.create_train_state(tconfig.ModelConfig(),
                                      tconfig.OptimConfig(**ocfg),
                                      model=_twin(jst.params), ema=True)
    for name, p in state.model.named_parameters():
        assert torch.equal(state.ema[name], p.detach())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(5):
        jst, _ = step(jst, jbatch)
        state, _ = tloop.train_step(state, batch, torch.tensor(priors),
                                    ema_decay=d)
    ema = TTinyDet()
    ema.load_state_dict(state.ema)
    _assert_params_match(ema, jst.ema_params, atol=1e-6)
    assert not torch.equal(state.ema["Conv_0.weight"],
                           state.model.Conv_0.weight.detach())


def test_ema_moves_only_on_update_boundaries():
    torch.manual_seed(0)
    model = TTinyDet()
    state = tstate.create_train_state(
        tconfig.ModelConfig(),
        tconfig.OptimConfig(lr=0.05, use_lr_schedule=False,
                            grad_accum_steps=2), model=model, ema=True)
    batch = {"images": torch.rand(2, 64, 64, 3),
             "boxes": torch.tensor([[[0.1, 0.1, 0.5, 0.6]]] * 2),
             "classes": torch.tensor([[4]] * 2, dtype=torch.int32),
             "mask": torch.ones(2, 1, dtype=torch.bool)}
    priors = torch.tensor(_tiny_priors())
    expect = {n: t.clone() for n, t in state.ema.items()}
    for micro in range(4):
        state, _ = tloop.train_step(state, batch, priors, ema_decay=0.5)
        if micro % 2:
            params = dict(state.model.named_parameters())
            expect = {n: e * 0.5 + params[n].detach() * 0.5
                      for n, e in expect.items()}
        for n, e in expect.items():
            torch.testing.assert_close(state.ema[n], e, rtol=0, atol=1e-7)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_retention_and_roundtrip_mid_accumulation(tmp_path):
    torch.manual_seed(1)
    state = tstate.create_train_state(
        tconfig.ModelConfig(),
        tconfig.OptimConfig(lr=0.05, use_lr_schedule=False,
                            grad_accum_steps=3), model=TTinyDet(), ema=True)
    batch = {"images": torch.rand(2, 64, 64, 3),
             "boxes": torch.tensor([[[0.1, 0.1, 0.5, 0.6]]] * 2),
             "classes": torch.tensor([[4]] * 2, dtype=torch.int32),
             "mask": torch.ones(2, 1, dtype=torch.bool)}
    priors = torch.tensor(_tiny_priors())
    for _ in range(4):                      # one update, one micro-step in
        tloop.train_step(state, batch, priors, ema_decay=0.9)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for epoch in range(5):
        mgr.save(epoch, state, metadata={"history": {"train": [epoch]}})
    mgr.wait()
    assert mgr.latest_epoch() == 4 and mgr.epochs() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["3", "4"]

    torch.manual_seed(9)
    fresh = tstate.create_train_state(
        tconfig.ModelConfig(),
        tconfig.OptimConfig(lr=0.05, use_lr_schedule=False,
                            grad_accum_steps=3), model=TTinyDet(), ema=True)
    fresh, meta, epoch = mgr.restore(fresh)
    assert epoch == 4 and meta == {"history": {"train": [4]}}
    assert (fresh.step, fresh.mini_step) == (state.step, state.mini_step) \
        == (4, 1)
    for a, b in zip(fresh.acc_grads, state.acc_grads):
        assert torch.equal(a, b)
    for _ in range(2):                      # close the window in both
        tloop.train_step(state, batch, priors, ema_decay=0.9)
        tloop.train_step(fresh, batch, priors, ema_decay=0.9)
    for (name, a), b in zip(state.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name in state.ema:
        assert torch.equal(state.ema[name], fresh.ema[name]), name


def test_checkpoint_weights_for_serving(tmp_path):
    cfg = tconfig.Config(train=tconfig.TrainConfig(
        checkpoint_dir=str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        checkpoint_weights(cfg)
    weights, epoch = checkpoint_weights(cfg, allow_random_init=True)
    assert epoch is None and "trunk.conv1_1.weight" in weights

    state = tstate.create_train_state(
        tconfig.ModelConfig(), tconfig.OptimConfig(), model=TTinyDet(),
        ema=True)
    state.ema = {n: t + 1.0 for n, t in state.ema.items()}
    CheckpointManager(str(tmp_path / "ck")).save(3, state)
    raw, epoch = checkpoint_weights(cfg, str(tmp_path / "ck"))
    ema, _ = checkpoint_weights(cfg, str(tmp_path / "ck"), use_ema=True)
    assert epoch == 3
    for name, t in state.model.state_dict().items():
        assert torch.equal(raw[name], t)
        assert torch.equal(ema[name], t + 1.0)
    state.ema = None
    CheckpointManager(str(tmp_path / "ck")).save(4, state)
    with pytest.raises(ValueError, match="EMA"):
        checkpoint_weights(cfg, str(tmp_path / "ck"), use_ema=True)

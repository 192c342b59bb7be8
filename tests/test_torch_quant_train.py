"""Quantization-aware training of the PyTorch port against the JAX
package: the straight-through fake-quant branch of `TorchConv` (JAX
`Int8Conv(straight_through=True)`), `train_step(quant_ste=)` /
`eval_step(quant_ste=)` and `Trainer.enable_qat`.

Tolerances, with their reasons:
  * the QAT branch: forward and gradients to 1e-5 of their largest (an
    f32 conv in another summation order);
  * one QAT train step: loss to rtol 1e-4, parameters to 1e-4 of each
    tensor's largest (`test_torch_train.py`'s small-model gate).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.models import layers as jlayers
from objectdetection_ssd_tpu.train import loop as jloop
from objectdetection_ssd_tpu.train import state as jstate
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.models.layers import (ConvQuant, TorchConv,
                                                     flatten_head)
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate
from objectdetection_ssd_torch.train.trainer import Trainer

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return _t(x.transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def test_straight_through_branch_matches_jax():
    """`tests/test_quant.py:302`: the QAT branch's forward, its weight and
    input gradients, and zero gradient where the input saturates."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 7, 4)).astype(np.float32)
    s_a = np.float32(np.abs(x).max() / 127.0)
    kernel = rng.normal(0, 0.2, (3, 3, 4, 8)).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    params = {"kernel": kernel, "bias": bias}
    jconv = jlayers.Int8Conv(features=8, kernel=3, stride=2, padding=1,
                             straight_through=True)
    up = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jconv.apply({"params": p}, xx, jnp.float32(s_a))
                       * up)

    jy = np.asarray(jconv.apply({"params": params}, jnp.asarray(x),
                                jnp.float32(s_a)))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    conv = TorchConv(4, 8, kernel=3, stride=2, padding=1)
    with torch.no_grad():
        conv.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(_t(bias))
    # out_scale is ignored by the straight-through branch.
    conv.quant = ConvQuant(torch.tensor(s_a), torch.tensor(0.5),
                           torch.float32, straight_through=True)
    tx = _nchw(x).requires_grad_(True)
    y = conv(tx)
    (y * _nchw(up)).sum().backward()
    for got, want in ((_nhwc(y), jy),
                      (conv.weight.grad.permute(2, 3, 1, 0).numpy(),
                       np.asarray(jg["kernel"])),
                      (conv.bias.grad.numpy(), np.asarray(jg["bias"])),
                      (_nhwc(tx.grad), np.asarray(jgx))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    sat = torch.full_like(tx, 1e6).requires_grad_(True)
    conv(sat).sum().backward()
    assert torch.count_nonzero(sat.grad) == 0


class JTinyQ(fnn.Module):
    """(B, 16, 16, 3) -> ((B, 16, 4), (B, 16, 21)) through three
    `TorchConv`s, the only layer QAT quantizes."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.relu(jlayers.TorchConv(8, kernel=3, stride=4, padding=1,
                                       name="stem")(x))      # 16 -> 4
        loc = jlayers.TorchConv(4, kernel=3, padding=1, name="loc")(x)
        conf = jlayers.TorchConv(21, kernel=3, padding=1, name="conf")(x)
        return (loc.reshape(x.shape[0], -1, 4),
                conf.reshape(x.shape[0], -1, 21))


class TTinyQ(torch.nn.Module):
    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.stem = TorchConv(3, 8, kernel=3, stride=4, padding=1)
        self.loc = TorchConv(8, 4, kernel=3, padding=1)
        self.conf = TorchConv(8, 21, kernel=3, padding=1)

    def forward(self, x, generator=None, remat=False):    # NHWC
        x = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        return flatten_head(self.loc(x), 4), flatten_head(self.conf(x), 21)


def _tiny_priors():
    centers = (np.arange(4) + 0.5) / 4
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    return np.stack([cx.ravel(), cy.ravel(), np.full(16, 0.3),
                     np.full(16, 0.3)], 1).astype(np.float32)


def _tiny_batch(bs=8, seed=0):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((bs, 2, 4), np.float32)
    lo = rng.uniform(0.05, 0.5, (bs, 2, 2))
    boxes[..., :2] = lo
    boxes[..., 2:] = lo + rng.uniform(0.2, 0.45, (bs, 2, 2))
    return {"images": rng.normal(0, 1, (bs, 16, 16, 3)).astype(np.float32),
            "boxes": boxes,
            "classes": rng.integers(0, 20, (bs, 2)).astype(np.int32),
            "mask": np.tile(np.asarray([[True, False]]), (bs, 1))}


_QAT_TREE = {"stem": {"act_scale": np.float32(0.03)},
             "loc": {"act_scale": np.float32(0.02),
                     "out_scale": np.float32(0.5)},
             "conf": {"act_scale": np.float32(0.02)}}


def _tiny_pair(ocfg):
    jst = jstate.create_train_state(JTinyQ(), jax.random.PRNGKey(0),
                                    jnp.zeros((1, 16, 16, 3)),
                                    jconfig.OptimConfig(**ocfg))
    model = TTinyQ()
    params = jax.device_get(jst.params)
    model.load_state_dict({
        f"{m}.{'weight' if k == 'kernel' else k}":
            _t(v.transpose(3, 2, 0, 1) if k == "kernel" else v)
        for m, leaves in params.items()
        for k, v in leaves["Conv_0"].items()}, strict=True)
    return jst, model


def test_qat_train_step_matches_jax():
    """`train_step(quant_ste=)` and `eval_step(quant_ste=)` against JAX's
    on one step of a small model, and the fake quant really ran."""
    ocfg = dict(lr=0.05, use_lr_schedule=False)
    priors = _tiny_priors()
    batch = _tiny_batch()
    jst, model = _tiny_pair(ocfg)
    q = jax.tree_util.tree_map(jnp.asarray, _QAT_TREE)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jeval = jloop.eval_step(jst, jbatch, jnp.asarray(priors),
                            jconfig.LossConfig(), quant_ste=q)
    # Eager, as under `jit` XLA divides by 127 as a multiply by its
    # reciprocal: a channel's largest weight then lands an ulp off the
    # clip's edge, where the straight-through gradient is halved.
    jst, jm = jloop.train_step(jst, jbatch, jnp.asarray(priors),
                               jconfig.LossConfig(), quant_ste=q)
    state = tstate.TrainState(model, *tstate.make_optimizer(
        model.named_parameters(), tconfig.OptimConfig(**ocfg)))
    float_eval = tloop.eval_step(state, batch, _t(priors))
    ev = tloop.eval_step(state, batch, _t(priors), quant_ste=_QAT_TREE)
    np.testing.assert_allclose(float(ev["loss"]), float(jeval["loss"]),
                               rtol=1e-5)
    assert float(ev["loss"]) != float(float_eval["loss"])
    state, m = tloop.train_step(state, batch, _t(priors),
                                quant_ste=_QAT_TREE)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert all(c.quant is None for c in (model.stem, model.loc, model.conf))
    named = dict(model.named_parameters())
    for m_name, leaves in jax.device_get(jst.params).items():
        for k, v in leaves["Conv_0"].items():
            want = v.transpose(3, 2, 0, 1) if k == "kernel" else v
            name = f"{m_name}.{'weight' if k == 'kernel' else k}"
            np.testing.assert_allclose(named[name].detach().numpy(), want,
                                       rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)


class _OneBatchLoader:
    """What `Trainer._run_phase` reads of a Loader: one batch per epoch."""

    def __init__(self, batch):
        self.batch = batch
        self.records = [None] * len(batch["images"])
        self.config = tconfig.DataConfig(batch_size=len(batch["images"]))

    def __len__(self):
        return 1

    def epoch(self, epoch):
        yield dict(self.batch)


def test_trainer_enable_qat_trains_through_fake_quant(tmp_path):
    """After `enable_qat` the Trainer's steps are `train_step(quant_ste=)`
    with the tree on its device: one epoch of `fit` equals that step."""
    priors = _tiny_priors()
    batch = _tiny_batch(seed=1)
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(image_size=16),
        optim=tconfig.OptimConfig(lr=0.05, use_lr_schedule=False),
        train=tconfig.TrainConfig(num_epochs=1, seed=0, log_every_steps=0,
                                  checkpoint_dir=str(tmp_path / "ck")))
    trainers = []
    for qat in (True, False):
        torch.manual_seed(0)
        tr = Trainer(cfg, _OneBatchLoader(batch), model=TTinyQ(),
                     priors=priors, device="cpu")
        if qat:
            tr.enable_qat(_QAT_TREE)
            assert isinstance(tr.quant_ste["stem"]["act_scale"],
                              torch.Tensor)
        trainers.append(tr)
    model = TTinyQ()
    model.load_state_dict(trainers[0].state.model.state_dict())
    ref = tstate.TrainState(model, *tstate.make_optimizer(
        model.named_parameters(), cfg.optim))
    tloop.train_step(ref, batch, _t(priors), quant_ste=_QAT_TREE)
    for tr in trainers:
        tr.fit()
    qat_w = trainers[0].state.model.stem.weight
    assert torch.equal(qat_w, ref.model.stem.weight)
    assert not torch.equal(qat_w, trainers[1].state.model.stem.weight)

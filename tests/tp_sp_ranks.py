"""What the spawned gloo ranks of the tensor- and spatial-parallel tests
run (`tests/test_torch_tp.py`, `test_torch_sp.py`, `test_torch_sp_uneven.py`,
`test_torch_tp_sp_cli.py`) and of QAT under a mesh
(`test_torch_qat_mesh.py`), and the launcher of every spawned-rank test.

A spawned rank imports the module of the function it runs, so this one
imports torch and the port only: no JAX, no JAX package, no test module
that imports them.  The tests hold what the ranks return against JAX and
against the port's single-process runs, which they compute themselves.
"""

import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from objectdetection_ssd_torch import cli
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.config import Config
from objectdetection_ssd_torch.data import voc
from objectdetection_ssd_torch.data.pipeline import Loader
from objectdetection_ssd_torch.infer import quant as tquant
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.models import layers
from objectdetection_ssd_torch.models.layers import (TorchConv, flatten_head,
                                                     max_pool, set_partition)
from objectdetection_ssd_torch.models.ssd import build_model
from objectdetection_ssd_torch.ops import priors as tpriors
from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.parallel.data_parallel import (MeshParallel,
                                                              full_tensor)
from objectdetection_ssd_torch.parallel.spatial import SpatialParallel
from objectdetection_ssd_torch.parallel.tensor_parallel import (
    TensorParallel, shard_model)
from objectdetection_ssd_torch.train import loop as tloop
from objectdetection_ssd_torch.train import state as tstate
from objectdetection_ssd_torch.train.trainer import Trainer

RANK_TIMEOUT_S = 240
# The conv1/conv2 convs whose filter gradient runs on K2 (its plain
# version on the CPU), as in `tests/test_torch_train.py`.
ROUTED = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
RESNET = tconfig.ModelConfig(backbone="resnet34", image_size=224)

# Every conv and pool geometry of the two families, at a map size where
# it runs: (name, kind, size, kernel, stride, padding, dilation, ceil).
GEOMETRIES = (
    ("vgg_conv3x3", "conv", 38, 3, 1, 1, 1, False),
    ("vgg_fc6", "conv", 19, 3, 1, 4, 4, False),
    ("vgg_fc7_1x1", "conv", 19, 1, 1, 0, 1, False),
    ("vgg_extra_s2", "conv", 19, 3, 2, 1, 1, False),
    ("vgg_extra_s2_10", "conv", 10, 3, 2, 1, 1, False),
    ("vgg_extra_valid_5", "conv", 5, 3, 1, 0, 1, False),
    ("vgg_extra_valid_3", "conv", 3, 3, 1, 0, 1, False),
    ("vgg_head_3", "conv", 3, 3, 1, 1, 1, False),
    ("vgg_head_1", "conv", 1, 3, 1, 1, 1, False),
    ("vgg_pool_150", "pool", 150, 2, 2, 0, 1, False),
    ("vgg_pool3_ceil", "pool", 75, 2, 2, 0, 1, True),
    ("vgg_pool4", "pool", 38, 2, 2, 0, 1, False),
    ("vgg_pool5", "pool", 19, 3, 1, 1, 1, False),
    ("resnet_stem", "conv", 224, 7, 2, 3, 1, False),
    ("resnet_stem_pool", "pool", 112, 3, 2, 1, 1, False),
    ("resnet_conv3x3", "conv", 14, 3, 1, 1, 1, False),
    ("resnet_conv3x3_s2", "conv", 28, 3, 2, 1, 1, False),
    ("resnet_downsample", "conv", 14, 1, 2, 0, 1, False),
    ("resnet_neck_7", "conv", 7, 3, 2, 1, 1, False),
    ("resnet_neck_4", "conv", 4, 3, 2, 1, 1, False),
    ("resnet_neck_2", "conv", 2, 3, 2, 1, 1, False),
)


# ---------------------------------------------------------------- launcher


def _rank_main(rank, fn, world, init_file, threads, args):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world, tmp_path, *args, threads=1):
    """Start ``fn(rank, world, *args)`` in ``world`` spawned processes
    joined in a gloo process group; returns the function that waits for
    them and re-raises a rank's failure there."""
    # A fresh rendezvous file per group: a used one holds stale addresses.
    init_file = str(tmp_path / f"pg{world}-{time.monotonic_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, init_file, threads, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S

    def join():
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{RANK_TIMEOUT_S} s")

    return join


def run_ranks(fn, world, tmp_path, *args, threads=1):
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    a gloo process group; re-raises a rank's failure here."""
    start_ranks(fn, world, tmp_path, *args, threads=threads)()


# ------------------------------------------------------------------ inputs


def ssd_batch():
    """One 300 px image with three boxes, the padded rows garbage (as
    `tests/test_torch_train.py:_gt_batch` pads them)."""
    rng = np.random.default_rng(12)
    boxes = rng.uniform(-1, 2, (1, 4, 4)).astype(np.float32)
    classes = rng.integers(-3, 30, (1, 4)).astype(np.int32)
    mask = np.zeros((1, 4), bool)
    lo = rng.uniform(0.0, 0.7, (3, 2))
    boxes[0, :3] = np.concatenate(
        [lo, lo + rng.uniform(0.05, 0.3, (3, 2))], 1)
    classes[0, :3] = rng.integers(0, 20, 3)
    mask[0, :3] = True
    return {"images": rng.integers(0, 256, (1, 300, 300, 3),
                                   dtype=np.uint8),
            "boxes": boxes, "classes": classes, "mask": mask}


def images():
    """The served image."""
    return np.random.default_rng(1).integers(0, 256, (1, 300, 300, 3),
                                             dtype=np.uint8)


def resnet_batch():
    rng = np.random.default_rng(5)
    boxes = np.zeros((2, 4, 4), np.float32)
    classes = np.zeros((2, 4), np.int32)
    mask = np.zeros((2, 4), bool)
    for i, n in enumerate((3, 1)):
        lo = rng.uniform(0.0, 0.5, (n, 2))
        boxes[i, :n] = np.concatenate(
            [lo, lo + rng.uniform(0.2, 0.5, (n, 2))], 1)
        classes[i, :n] = rng.integers(0, 20, n)
        mask[i, :n] = True
    return {"images": rng.integers(0, 256, (2, 224, 224, 3),
                                   dtype=np.uint8),
            "boxes": boxes, "classes": classes, "mask": mask}


def resnet_weights(tmp):
    """A seeded ResNet-34 state_dict (saved): (it, its path)."""
    state_dict = build_model(RESNET, device="cpu", train=True,
                             generator=torch.Generator().manual_seed(2)
                             ).state_dict()
    path = str(tmp / "resnet.pt")
    torch.save(state_dict, path)
    return state_dict, path


# ------------------------------------------------------------------ layers


def layer_errors(part, geometry, rng):
    """One layer of ``geometry`` under ``part`` (a channel- or
    row-partitioned input in, the whole output gathered) against the
    whole layer: the largest errors of the output and of the input,
    weight and bias gradients, each relative to the whole layer's
    largest (weight gradients summed over the ranks that hold parts of
    them)."""
    _, kind, size, k, s, p, d, ceil = geometry
    cin, cout = 4, 8
    x = torch.tensor(rng.normal(0, 1, (1, size, size, cin)),
                     dtype=torch.float32).permute(0, 3, 1, 2)
    whole_x = x.clone().requires_grad_()
    if kind == "conv":
        ref = TorchConv(cin, cout, k, stride=s, padding=p, dilation=d)
        ref.reset_parameters(torch.Generator().manual_seed(3))
        with torch.no_grad():
            ref.bias.normal_(0, 1, generator=torch.Generator().manual_seed(4))
        layer = TorchConv(cin, cout, k, stride=s, padding=p, dilation=d)
        layer.load_state_dict(ref.state_dict())
        if part.kind == "model":
            shard_model(layer, part)
        set_partition(layer, part)
        want = ref(whole_x)
    else:
        want = max_pool(whole_x, k, s, p, ceil)
    g = torch.tensor(rng.normal(0, 1, tuple(want.shape)),
                     dtype=torch.float32)
    (want * g).sum().backward()
    if part.kind == "model":
        lo, hi = part.channels(cin)
        local = x[:, lo:hi]
    else:
        lo, hi = part.rows(size)
        local = x[:, :, lo:hi]
    local = local.contiguous(memory_format=torch.channels_last)
    local.requires_grad_()
    if kind == "conv":
        y = layer(local)
    else:
        y = max_pool(local, k, s, p, ceil, part=part)
    got = part.whole(y, cout)
    ((got * g).sum() / part.ways).backward()

    def rel(a, b):
        assert a.shape == b.shape
        if not a.numel():            # a rank without rows of the map
            return 0.0
        return float((a - b).abs().max() / b.abs().max())

    grad_x = (whole_x.grad[:, lo:hi] if part.kind == "model"
              else whole_x.grad[:, :, lo:hi])
    out = {"forward": rel(got.detach(), want.detach()),
           "grad_x": rel(local.grad, grad_x)}
    if kind == "conv":
        for name in ("weight", "bias"):
            param = getattr(layer, name)
            grad = param.grad
            if isinstance(param, DTensor):
                grad = grad.to_local()
                if param.placements[-1] == Shard(0):
                    lo, hi = part.channels(cout)
                    out[name] = rel(grad, getattr(ref, name).grad[lo:hi])
                    continue
            grad = grad.clone()
            dist.all_reduce(grad, group=part.group)
            out[name] = rel(grad, getattr(ref, name).grad)
    return out


# ------------------------------------------------------------------- steps


def port_step(state_dict, batch, mesh=None):
    """One SSD300 SGD step (no schedule, conv1/conv2 routed); (metrics,
    whole gradients, state)."""
    state = tstate.create_train_state(
        tconfig.ModelConfig(dw_pallas_convs=ROUTED),
        tconfig.OptimConfig(use_lr_schedule=False), device="cpu",
        state_dict=state_dict, mesh=mesh)
    state, metrics = tloop.train_step(
        state, batch, torch.tensor(tpriors.ssd300_priors()))
    grads = {n: full_tensor(p.grad).clone()
             for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, state


def resnet_step(state_dict, batch, mesh=None):
    """One ResNet-34 SGD step in train mode (dropout 0.4, frozen trunk):
    (metrics, whole gradients, BN statistics)."""
    state = tstate.create_train_state(
        RESNET, tconfig.OptimConfig(use_lr_schedule=False), device="cpu",
        state_dict=state_dict, mesh=mesh)
    state, metrics = tloop.train_step(
        state, batch, torch.tensor(tpriors.resnet34_priors()), seed=3)
    grads = {n: full_tensor(p.grad).clone()
             for n, p in state.model.named_parameters()
             if p.grad is not None}
    stats = {n: t.clone() for n, t in state.model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def resnet_f64_grads(state_dict, mesh=None):
    """The ResNet-34 family with its trunk trained, in train mode, in f64,
    under a fixed linear loss of its outputs: (loss, whole gradients)."""
    cfg = tconfig.ModelConfig(backbone="resnet34", image_size=224,
                              freeze_backbone=False)
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(state_dict)
    model = model.double()
    model.dtype = torch.float64
    parallel = None if mesh is None else MeshParallel(model, mesh)
    loc, conf = model(torch.as_tensor(resnet_batch()["images"][:1]),
                      torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    loss = ((loc * torch.tensor(rng.normal(0, 1, tuple(loc.shape)))).sum()
            + (conf * torch.tensor(rng.normal(0, 1, tuple(conf.shape))))
            .sum())
    if parallel is None:
        loss.backward()
    else:
        parallel.backward(loss)
    return float(loss.detach()), {n: full_tensor(p.grad).clone()
                                  for n, p in model.named_parameters()}


def replicated_agree(state, world):
    """For each parameter that the ``model`` axis replicates: whether the
    parameter and its gradient are equal on every rank."""
    agree = {}
    for name, p in state.model.named_parameters():
        if p.placements[-1] != Replicate():
            continue
        same = True
        for t in (p.detach(), p.grad):
            t = t.to_local().contiguous()
            every = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(every, t)
            same &= all(torch.equal(every[0], u) for u in every)
        agree[name] = same
    return agree


# ---------------------------------------------------------------- serving


def wide_bias_state_dict(seed=0):
    """Seeded SSD300 weights with conf-head biases ~ N(0, 3), so that many
    candidates clear the threshold and NMS has work."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True,
                        generator=gen)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(6):
        bias = state_dict[f"conf_head_{i}.bias"]
        bias.copy_(torch.randn(bias.shape, generator=gen) * 3.0)
    return state_dict


def record_int8_calls(calls):
    """Wrap K3's entry so that each call's output is appended to
    ``calls``; returns the original."""
    original = layers.k3.int8_conv

    def recording(*args, **kw):
        out = original(*args, **kw)
        calls.append(out.clone())
        return out

    layers.k3.int8_conv = recording
    return original


def int8_reference(det_sd, tmp):
    """The chained scale tree calibrated on the served image and the
    single-process int8 Detector's detections and K3 call outputs, saved:
    their paths."""
    model = build_model(tconfig.ModelConfig(), device="cpu", train=True)
    model.load_state_dict(det_sd)
    qtree = tquant.chain_scales(tquant.act_scales(tquant.calibrate(
        model, [images()])), "vgg16")
    calls = []
    original = record_int8_calls(calls)
    try:
        dets = Detector(Config(), det_sd, device="cpu",
                        quant=qtree).detect_batch(images())
    finally:
        layers.k3.int8_conv = original
    qtree_path, single = str(tmp / "q.pt"), str(tmp / "int8_single.pt")
    torch.save(qtree, qtree_path)
    torch.save((dets, calls), single)
    return qtree_path, single


def int8_calls_equal(part, got, want):
    """Per K3 call: this rank's output equal, bit for bit, to its slice of
    the single-process output: its channels (tensor parallel) or the rows
    it computed (spatial)."""
    same = []
    for g, w in zip(got, want):
        if part.kind == "model":
            lo, hi = (part.channels(w.shape[1]) if g.shape[1] != w.shape[1]
                      else (0, w.shape[1]))
            ref = w[:, lo:hi]
        else:
            h = w.shape[2]
            lo, hi = part.rows(h)
            start = lo if hi > lo else min(lo, h - 1)
            ref = w[:, :, start:start + g.shape[2]]
        same.append(g.shape == ref.shape and torch.equal(g, ref))
    return len(got) == len(want), same


def detector_runs(part_mesh, weights, qtree, single_path):
    """f32 detections of the Detector on ``part_mesh``; int8: its
    detections and whether each K3 call equals the single-process
    Detector's (`int8_reference`)."""
    sd = torch.load(weights)
    out = {"f32": Detector(Config(), sd, device="cpu", mesh=part_mesh)
           .detect_batch(images())}
    calls = []
    original = record_int8_calls(calls)
    try:
        det = Detector(Config(), sd, device="cpu", quant=qtree,
                       mesh=part_mesh)
        out["int8"] = det.detect_batch(images())
    finally:
        layers.k3.int8_conv = original
    part = det.model.trunk.conv1_1.part
    _, single_calls = torch.load(single_path, weights_only=False)
    out["int8_calls"] = int8_calls_equal(part, calls, single_calls)
    return out


# ---------------------------------------------------------------- trainer


class PortTinyDet(nn.Module):
    """A small detector of the port's layers: (B, 64, 64, 3) normalized
    NHWC -> 16 priors (a 4 x 4 map, one anchor)."""

    def __init__(self):
        super().__init__()
        self.conv0 = TorchConv(3, 16, 5, stride=8, padding=2)     # 64 -> 8
        self.conv1 = TorchConv(16, 32, 3, stride=2, padding=1)    # 8 -> 4
        self.loc = TorchConv(32, 4, 3, padding=1)
        self.conf = TorchConv(32, 21, 3, padding=1)
        gen = torch.Generator().manual_seed(5)
        for m in (self.conv0, self.conv1, self.loc, self.conf):
            m.reset_parameters(gen)
        self.part = None

    def forward(self, x, generator=None, remat=False):
        x = x.permute(0, 3, 1, 2)
        if self.part is not None:
            x = self.part.enter(x)
        x = F.relu(self.conv1(F.relu(self.conv0(x))))
        return (flatten_head(self.loc(x), 4, self.part, 4),
                flatten_head(self.conf(x), 21, self.part, 21))


def tiny_priors():
    """`PortTinyDet`'s 16 priors (`tests/test_torch_trainer.py`'s)."""
    centers = (np.arange(4) + 0.5) / 4
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    return np.stack([cx.ravel(), cy.ravel(), np.full(16, 0.3),
                     np.full(16, 0.3)], 1).astype(np.float32)


def trainer_run(root, ckpt, mesh_shape=None, axes=("data",)):
    """A Trainer of `PortTinyDet` (batch 8, f32, two epochs; the config of
    `tests/test_torch_trainer.py:_configs`) on ``root``."""
    cfg = Config(
        model=tconfig.ModelConfig(image_size=64),
        data=tconfig.DataConfig(voc_root=str(root), batch_size=8,
                                num_workers=0, max_boxes=8),
        optim=tconfig.OptimConfig(lr=0.01, use_lr_schedule=False),
        train=tconfig.TrainConfig(num_epochs=2, seed=0,
                                  checkpoint_dir=str(ckpt),
                                  log_every_steps=0, mesh_shape=mesh_shape,
                                  mesh_axis_names=axes))
    records = voc.load_records(str(root))
    train_ids, val_ids = voc.train_val_split(len(records), 1 / 3, seed=10)
    shard = None if mesh_shape is None else (0, 1)
    return Trainer(cfg, Loader([records[i] for i in train_ids], cfg.data,
                               64, train=True, seed=0, shard=shard),
                   Loader([records[i] for i in val_ids], cfg.data, 64,
                          train=False, drop_last=False, shard=shard),
                   model=PortTinyDet(), priors=tiny_priors(), device="cpu")


# ------------------------------------------------------------------- ranks


def rank_tp(rank, world, tmp, weights, det_weights, qtree_path, single,
            root, out):
    """The rank's work on a (1, 2) data x model mesh."""
    mesh = mesh_lib.create_mesh((1, world), ("data", "model"), "cpu")
    part = TensorParallel(mesh)
    rng = np.random.default_rng(30)
    result = {"layers": {g[0]: layer_errors(part, g, rng)
                         for g in GEOMETRIES if g[1] == "conv"}}
    metrics, grads, state = port_step(torch.load(weights), ssd_batch(), mesh)
    result["step"] = (metrics, grads)
    result["replicated"] = replicated_agree(state, world)
    # Each rank holds its shard of every sharded parameter and momentum.
    local = total = 0
    for p in state.model.parameters():
        if p.placements[-1] == Shard(0):
            buf = state.optimizer.state[p]["momentum_buffer"]
            local += p.to_local().numel() + buf.to_local().numel()
            total += p.numel() + buf.numel()
    result["memory"] = (local, total)
    del state
    result["detector"] = detector_runs(
        mesh, det_weights, torch.load(qtree_path, weights_only=False),
        single)
    trainer = trainer_run(root, tmp / "tp_ckpt", (1, world),
                          ("data", "model"))
    trainer.fit()
    result["trainer"] = {
        "history": trainer.history, "step": trainer.state.step,
        "params": {n: full_tensor(p.detach()).clone() for n, p in
                   trainer.state.model.named_parameters()},
        "sharded": trainer.state.parallel.sharded,
        "replicated": replicated_agree(trainer.state, world)}
    torch.save(result, f"{out}.{rank}")


def rank_sp(rank, world, resnet_path, det_weights, qtree_path, single, out,
            weights=None):
    """The rank's work at ``spatial`` = ``world``: the layers, the ResNet-34
    step, the Detector; with ``weights``, the SSD300 step and the f64
    trained-trunk step (and no ResNet-34 f32 step)."""
    mesh = mesh_lib.create_mesh((1, world), ("data", "spatial"), "cpu")
    part = SpatialParallel(mesh)
    rng = np.random.default_rng(31)
    result = {"layers": {g[0]: layer_errors(part, g, rng)
                         for g in GEOMETRIES}}
    if weights is not None:
        result["step"] = port_step(torch.load(weights), ssd_batch(),
                                   mesh)[:2]
        result["f64"] = resnet_f64_grads(torch.load(resnet_path), mesh)
    else:
        result["resnet"] = resnet_step(torch.load(resnet_path),
                                       resnet_batch(), mesh)
    result["detector"] = detector_runs(
        mesh, det_weights, torch.load(qtree_path, weights_only=False),
        single)
    torch.save(result, f"{out}.{rank}")


def rank_cli(rank, world, root, port, out):
    """``cli train --tp`` and ``--sp``, then ``cli eval --tp`` and ``--sp
    --data-parallel 1``, as torchrun's ranks run them."""
    # torchrun's environment: `distributed.initialize` finds the group
    # joined and uses it.
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    common = ["--voc-root", str(root / "VOCdevkit"), "--device", "cpu",
              "--num-workers", "0", "--backbone", "resnet34",
              "--batch-size", "8"]
    printed = {}
    for name, argv in (
            ("train_tp", ["train", "--tp", "2", "--synthetic", "--epochs",
                          "1", "--checkpoint-dir", str(root / "tp")]),
            ("train_sp", ["train", "--sp", "2", "--epochs", "1",
                          "--checkpoint-dir", str(root / "sp")]),
            ("eval_tp", ["eval", "--tp", "2", "--checkpoint-dir",
                         str(root / "tp")]),
            ("eval_sp", ["eval", "--sp", "2", "--data-parallel", "1",
                         "--checkpoint-dir", str(root / "tp")])):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert cli.main(argv + common) == 0
        printed[name] = text.getvalue()
        dist.barrier()
    torch.save(printed, f"{out}.{rank}")


# --------------------------------------------------------- QAT on a mesh


class PortTinyQ(nn.Module):
    """`tests/test_torch_quant_train.py:TTinyQ`: (B, 16, 16, 3) -> 16
    priors through three `TorchConv`s, the only layer QAT quantizes."""

    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.stem = TorchConv(3, 8, kernel=3, stride=4, padding=1)
        self.loc = TorchConv(8, 4, kernel=3, padding=1)
        self.conf = TorchConv(8, 21, kernel=3, padding=1)

    def forward(self, x, generator=None, remat=False):    # NHWC
        x = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        return flatten_head(self.loc(x), 4), flatten_head(self.conf(x), 21)


def qat_step(model_config, optim, state_dict, batch, priors, qtree,
             mesh=None, model=None, conv_noise=None):
    """One QAT step: (global metrics, whole parameters after it).
    ``conv_noise``: a generator; every conv output is then moved by one
    ulp up or down at random (another summation order's rounding)."""
    state = tstate.create_train_state(
        model_config, optim, device="cpu", state_dict=state_dict,
        model=model, mesh=mesh)
    if conv_noise is not None:
        def ulp(module, args, out):
            sign = torch.randint(0, 2, out.shape, generator=conv_noise) * 2 - 1
            return out * (1 + 2.0 ** -23 * sign)
        for m in state.model.modules():
            if isinstance(m, TorchConv):
                m.register_forward_hook(ulp)
    state, metrics = tloop.train_step(state, batch, torch.as_tensor(priors),
                                      quant_ste=qtree)
    return ({k: float(v) for k, v in metrics.items()},
            {n: full_tensor(p.detach()).clone()
             for n, p in state.model.named_parameters()})


@contextlib.contextmanager
def xla_weight_scale():
    """QAT's per-channel weight scales as XLA computes JAX's under `jit`:
    ``max|w|`` times the f32 reciprocal of 127 (a constant divisor becomes
    a multiply), an ulp from the division the port and eager JAX do.  A
    weight that lands on a rounding tie then rounds the other way."""
    original = layers.k3.weight_scale
    recip = torch.tensor(1.0 / layers.k3.QMAX, dtype=torch.float32)

    def scale(weight):
        w = weight.detach().float()
        return torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) * recip, 1e-12)

    layers.k3.weight_scale = scale
    try:
        yield
    finally:
        layers.k3.weight_scale = original


def rank_qat(rank, world, inputs, root, port, out):
    """QAT steps on this rank's meshes: the small model's under ``data``
    (DDP) and ``data x fsdp`` (FSDP2) on this rank's rows, SSD300's under
    ``data x model`` and ``data x spatial`` on its data shard (the whole
    batch); then ``cli train --qat --tp 2`` as torchrun's ranks run it,
    recording the scale tree each rank trains with.  The SSD300 steps run
    again under `xla_weight_scale` (keys ``model_xla``, ``spatial_xla``),
    to be held against JAX's jitted steps."""
    inp = torch.load(inputs, weights_only=False)
    tiny, ssd = inp["tiny"], inp["ssd"]
    b = len(tiny["batch"]["images"]) // world
    rows = {k: v[rank * b:(rank + 1) * b] for k, v in tiny["batch"].items()}
    result = {}
    for key, shape, axes in (("data", (world,), ("data",)),
                             ("fsdp", (1, world), ("data", "fsdp"))):
        mesh = mesh_lib.create_mesh(shape, axes, "cpu")
        model = PortTinyQ()
        model.load_state_dict(tiny["state_dict"])
        result[key] = qat_step(tconfig.ModelConfig(), tiny["optim"], None,
                               rows, tiny["priors"], tiny["qtree"], mesh,
                               model)
    for key, axis in (("model", "model"), ("spatial", "spatial")):
        mesh = mesh_lib.create_mesh((1, world), ("data", axis), "cpu")
        for suffix, scales in (("", contextlib.nullcontext()),
                               ("_xla", xla_weight_scale())):
            with scales:
                result[key + suffix] = qat_step(
                    tconfig.ModelConfig(), ssd["optim"],
                    torch.load(ssd["weights"]), ssd["batch"],
                    tpriors.ssd300_priors(), ssd["qtree"], mesh)

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    seen = []
    original = Trainer.enable_qat

    def recording(self, qtree):
        seen.append(qtree)
        return original(self, qtree)

    Trainer.enable_qat = recording
    try:
        assert cli.main(inp["cli_argv"]) == 0
    finally:
        Trainer.enable_qat = original
    result["cli_scales"] = seen
    torch.save(result, f"{out}.{rank}")

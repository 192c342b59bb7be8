"""The port learns: `tests/test_learnability.py`'s three gates on the port.

A small detector trains on the class-colour-coded synthetic VOC (64 px
input, an 8x8 grid of two anchors) through the port's `train_step`, and
is scored through the port's `Detector` (``model=``, ``priors=``),
`postprocess` and `voc_map`:

* `test_detector_learns_synthetic_task`: mAP > 0.6, and > the untrained
  mAP + 0.4, after 100 epochs;
* `test_inference_variants_preserve_trained_map`: int8 PTQ (heads f32,
  3 convs), flip TTA and Soft-NMS keep a flip-trained model's mAP;
* `test_qat_recovers_int8_accuracy`: 30 QAT epochs through the fake-quant
  path bring the fully quantized model back to the f32 mAP.

The fixture, the configs, the epochs and the thresholds are JAX's.  The
three are marked ``slow``, as JAX's are:
``python -m pytest -m slow tests/test_torch_learnability.py``.  Two fast
tests hold the recipe to JAX's: from the same weights (a numpy seed) the
toy's first three train steps give JAX's losses to rtol 1e-4 and its
gradients within 5e-3 of each leaf's largest (the repo's train gate), and
the untrained detections score JAX's mAP to 1e-6.

The recipes are functions of the records, the device and an optional
packed cache, with their gates as functions, so that ``chip_smoke.py``
runs the same three on the card (where there is no PIL: the fixture's
pixels go into a cache).  This module imports no JAX at its top.
"""

import dataclasses
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_ssd_torch.config import (Config, DataConfig, LossConfig,
                                              ModelConfig, OptimConfig,
                                              PostprocessConfig)
from objectdetection_ssd_torch.data import synthetic, voc
from objectdetection_ssd_torch.data.pipeline import Loader
from objectdetection_ssd_torch.eval.voc_map import voc_map
from objectdetection_ssd_torch.infer import quant as quant_lib
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.models.layers import TorchConv
from objectdetection_ssd_torch.models.ssd import normalize_uint8
from objectdetection_ssd_torch.train import loop as loop_lib
from objectdetection_ssd_torch.train.state import create_train_state

IMG = 64
GRID = 8
NUM_FIXTURE_CLASSES = 4
# generate_voc's arguments, apart from the seed (3, 5 and 9 below).
FIXTURE = dict(num_2007=40, num_2012=8, image_size=(96, 96), max_objects=2,
               difficult_fraction=0.0, num_classes=NUM_FIXTURE_CLASSES,
               class_color_coding=True)
SEEDS = {"learns": 3, "variants": 5, "qat": 9}
DATA = DataConfig(batch_size=16, num_workers=0, max_boxes=4, augment=False)
OPTIM = OptimConfig(lr=0.01, use_lr_schedule=False)
LOSS = LossConfig(match_iou_threshold=0.4)
PP = PostprocessConfig(per_class_top_k=32, top_k=10, score_threshold=0.3,
                       use_approx_top_k=False)
EPOCHS = 100
# QAT: 70 f32 epochs, then 30 through the fake-quant path on the loader's
# epochs 100-129, as JAX's.
QAT_BASE_EPOCHS, QAT_EPOCHS, QAT_FIRST_EPOCH = 70, 30, 100


def _heads(x: torch.Tensor, loc_head: nn.Module, conf_head: nn.Module):
    """NCHW head maps -> ((B, P, 4), (B, P, 21)), anchors inner per cell
    as flax's NHWC reshape orders them."""
    b = x.shape[0]
    loc = loc_head(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
    conf = conf_head(x).permute(0, 2, 3, 1).reshape(b, -1, 21)
    return loc, conf


def _init(module: nn.Module, generator: Optional[torch.Generator]):
    for m in module.modules():
        if isinstance(m, TorchConv):
            m.reset_parameters(generator)
    return module


class SmallDet(nn.Module):
    """JAX's `SmallDet`: three 3x3 stride-2 convs (64 -> 32 -> 16 -> 8) and
    two 3x3 heads of 2 anchors per cell (P = 128).  flax's ``SAME`` at
    stride 2 on an even size pads 0 rows and columns before and 1 after,
    which is not torch's ``padding=1``: the pad is explicit.  Takes
    normalized NHWC floats, and the train step's ``(generator, remat)``,
    which it ignores."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = TorchConv(3, 32, 3, stride=2)
        self.conv2 = TorchConv(32, 64, 3, stride=2)
        self.conv3 = TorchConv(64, 64, 3, stride=2)
        self.loc = TorchConv(64, 2 * 4, 3, padding=1)
        self.conf = TorchConv(64, 2 * 21, 3, padding=1)
        _init(self, generator)

    def forward(self, images, generator=None, remat=False):
        x = images.permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = torch.relu(conv(F.pad(x, (0, 1, 0, 1))))
        return _heads(x, self.loc, self.conf)


class SmallDetQ(nn.Module):
    """JAX's `SmallDetQ`: `SmallDet` from `TorchConv(padding=1)` (which is
    flax's SAME padding at stride 2 on these sizes), with heads named
    ``loc_head`` / ``conf_head`` so that `act_scales` leaves them float by
    default."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c1 = TorchConv(3, 32, 3, stride=2, padding=1)
        self.c2 = TorchConv(32, 64, 3, stride=2, padding=1)
        self.c3 = TorchConv(64, 64, 3, stride=2, padding=1)
        self.loc_head = TorchConv(64, 2 * 4, 3, padding=1)
        self.conf_head = TorchConv(64, 2 * 21, 3, padding=1)
        _init(self, generator)

    def forward(self, images, generator=None, remat=False):
        x = images.permute(0, 3, 1, 2)
        for conv in (self.c1, self.c2, self.c3):
            x = torch.relu(conv(x))
        return _heads(x, self.loc_head, self.conf_head)


def priors() -> np.ndarray:
    """JAX's `_priors`: (0.3, 0.3) and (0.6, 0.6) at each of the 8x8 cell
    centres, the two anchors of a cell adjacent."""
    centers = (np.arange(GRID) + 0.5) / GRID
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    cells = np.stack([cx.ravel(), cy.ravel()], 1)
    pri = [np.concatenate([cells, np.tile([[w, h]], (len(cells), 1))], 1)
           for w, h in [(0.3, 0.3), (0.6, 0.6)]]
    return np.stack(pri, axis=1).reshape(-1, 4).astype(np.float32)


def fixture_records(root: str, seed: int) -> list:
    """The JAX test's fixture, as JPEG files (needs PIL)."""
    synthetic.generate_voc(root, seed=seed, **FIXTURE)
    return voc.load_records(root, train=True)


def loaders(records, cache_path: Optional[str] = None):
    """(train loader, eval loader) over the same records, as JAX's."""
    return (Loader(records, DATA, image_size=IMG, train=True, seed=0,
                   cache_path=cache_path),
            Loader(records, DATA, image_size=IMG, train=False,
                   cache_path=cache_path))


def new_state(model: nn.Module, device):
    return create_train_state(ModelConfig(), OPTIM, device=device,
                              model=model.to(device))


def train(state, loader, epochs: int, first_epoch: int = 0,
          flip_rng: Optional[np.random.Generator] = None, quant_ste=None):
    """``epochs`` epochs of `train_step`; with ``flip_rng``, each batch is
    mirrored (images and boxes) with probability 1/2, as in JAX's
    variants test.  Returns (state, the last step's metrics)."""
    pri = torch.from_numpy(priors())
    metrics = None
    for epoch in range(first_epoch, first_epoch + epochs):
        for batch in loader.epoch(epoch):
            if flip_rng is not None and flip_rng.random() < 0.5:
                boxes = batch["boxes"].copy()
                boxes[..., 0] = 1.0 - batch["boxes"][..., 2]
                boxes[..., 2] = 1.0 - batch["boxes"][..., 0]
                batch = dict(batch, boxes=boxes,
                             images=batch["images"][:, :, ::-1, :].copy())
            state, metrics = loop_lib.train_step(state, batch, pri, LOSS,
                                                 quant_ste=quant_ste)
    return state, metrics


def detector_map(detector: Detector, loader) -> float:
    """mAP of ``detector`` over ``loader``'s first epoch, normalized by the
    share of the 20 classes the fixture holds (voc_map averages over 20)."""
    det_b, det_c, det_s, gt_b, gt_c = [], [], [], [], []
    for batch in loader.epoch(0):
        dets = [t.cpu().numpy() for t in detector.detect_batch(
            batch["images"])]
        boxes, scores, classes, valid = dets
        for i in range(len(valid)):
            det_b.append(boxes[i][valid[i]])
            det_c.append(classes[i][valid[i]])
            det_s.append(scores[i][valid[i]])
            m = batch["mask"][i]
            gt_b.append(batch["boxes"][i][m])
            gt_c.append(batch["classes"][i][m])
    _, mean_ap = voc_map(det_b, det_c, det_s, gt_b, gt_c)
    return mean_ap * 20 / NUM_FIXTURE_CLASSES


def map_variant(name: str, factory: Callable[[], nn.Module], state_dict,
                loader, device, pp: PostprocessConfig = PP,
                quant=None) -> float:
    """mAP through the variant plumbing: a `Detector` serving a fresh
    ``factory()`` module with ``state_dict``, the toy's priors, ``pp``
    (flip TTA, Soft-NMS) and the int8 scale tree ``quant``.  ``name``
    labels the measurement for callers that count launches per variant
    (``chip_smoke.py``)."""
    del name
    det = Detector(Config(), state_dict, postprocess_config=pp, quant=quant,
                   model=factory(), priors=priors(), device=device)
    return detector_map(det, loader)


def calibration_batches(loader) -> List[torch.Tensor]:
    """The train images themselves, normalized, as JAX calibrates."""
    return [normalize_uint8(torch.from_numpy(b["images"]))
            for b in loader.epoch(0)]


def calibrated(factory, state_dict, loader, device,
               quantize_heads: bool = False) -> dict:
    model = factory().to(device)
    model.load_state_dict(state_dict)
    return quant_lib.act_scales(
        quant_lib.calibrate(model, calibration_batches(loader)),
        quantize_heads=quantize_heads)


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


# ------------------------------------------------------- the three recipes


def recipe_learns(records, device, cache_path=None,
                  measure: Callable = map_variant) -> dict:
    loader, eval_loader = loaders(records, cache_path)
    state = new_state(SmallDet(_generator()), device)
    before = measure("untrained", SmallDet, state.model.state_dict(),
                     eval_loader, device)
    state, metrics = train(state, loader, EPOCHS)
    after = measure("trained", SmallDet, state.model.state_dict(),
                    eval_loader, device)
    return {"before": before, "after": after,
            "loss": float(metrics["loss"])}


def failures_learns(r: dict) -> List[str]:
    out = []
    if not np.isfinite(r["loss"]):
        out.append(f"final loss {r['loss']}")
    if not r["after"] > 0.6:
        out.append(f"mAP {r['after']:.4f} <= 0.6")
    if not r["after"] > r["before"] + 0.4:
        out.append(f"mAP {r['after']:.4f} <= untrained "
                   f"{r['before']:.4f} + 0.4")
    return out


def recipe_variants(records, device, cache_path=None,
                    measure: Callable = map_variant) -> dict:
    loader, eval_loader = loaders(records, cache_path)
    state = new_state(SmallDetQ(_generator()), device)
    # Trained WITH random flips: TTA's premise is a flip-robust model.
    state, metrics = train(state, loader, EPOCHS,
                           flip_rng=np.random.default_rng(1))
    sd = state.model.state_dict()
    base = measure("f32", SmallDetQ, sd, eval_loader, device)
    qtree = calibrated(SmallDetQ, sd, eval_loader, device)
    return {
        "loss": float(metrics["loss"]),
        "base": base,
        "quantized_convs": quant_lib.count_quantized(qtree),
        "int8": measure("int8", SmallDetQ, sd, eval_loader, device,
                        quant=qtree),
        "tta": measure("tta", SmallDetQ, sd, eval_loader, device,
                       pp=dataclasses.replace(PP, tta_flip=True)),
        "soft_nms": measure("soft_nms", SmallDetQ, sd, eval_loader, device,
                            pp=dataclasses.replace(
                                PP, nms_method="soft_gaussian")),
    }


def failures_variants(r: dict) -> List[str]:
    out = []
    base = r["base"]
    if not base > 0.6:
        out.append(f"base mAP {base:.4f} <= 0.6")
    if r["quantized_convs"] != 3:
        out.append(f"{r['quantized_convs']} quantized convs, not 3")
    for key, margin in (("int8", 0.03), ("tta", 0.005), ("soft_nms", 0.05)):
        if not r[key] > base - margin:
            out.append(f"{key} mAP {r[key]:.4f} <= base {base:.4f} - "
                       f"{margin}")
    return out


def recipe_qat(records, device, cache_path=None,
               measure: Callable = map_variant) -> dict:
    loader, eval_loader = loaders(records, cache_path)
    state = new_state(SmallDetQ(_generator()), device)
    state, _ = train(state, loader, QAT_BASE_EPOCHS)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    base = measure("f32", SmallDetQ, sd, eval_loader, device)
    # Quantize everything, the heads too (the harsher setting).
    qtree = calibrated(SmallDetQ, sd, eval_loader, device,
                       quantize_heads=True)
    before = measure("int8 before QAT", SmallDetQ, sd, eval_loader, device,
                     quant=qtree)
    # Fine-tune through the fake-quant path with the same scales.
    state, metrics = train(state, loader, QAT_EPOCHS,
                           first_epoch=QAT_FIRST_EPOCH,
                           quant_ste=qtree)
    after = measure("int8 after QAT", SmallDetQ, state.model.state_dict(),
                    eval_loader, device, quant=qtree)
    return {"base_f32": base, "int8_before_qat": before,
            "int8_after_qat": after, "loss": float(metrics["loss"]),
            "quantized_convs": quant_lib.count_quantized(qtree)}


def failures_qat(r: dict) -> List[str]:
    out = []
    if not np.isfinite(r["loss"]):
        out.append(f"final QAT loss {r['loss']}")
    if not r["base_f32"] > 0.6:
        out.append(f"base mAP {r['base_f32']:.4f} <= 0.6")
    if not r["int8_after_qat"] > r["base_f32"] - 0.02:
        out.append(f"int8 after QAT {r['int8_after_qat']:.4f} <= base "
                   f"{r['base_f32']:.4f} - 0.02")
    if not r["int8_after_qat"] >= r["int8_before_qat"] - 0.005:
        out.append(f"int8 after QAT {r['int8_after_qat']:.4f} < before "
                   f"{r['int8_before_qat']:.4f} - 0.005")
    return out


RECIPES = {"learns": (recipe_learns, failures_learns),
           "variants": (recipe_variants, failures_variants),
           "qat": (recipe_qat, failures_qat)}


def _run_slow(tmp_path, key: str) -> Dict:
    torch.manual_seed(0)
    recipe, failures = RECIPES[key]
    records = fixture_records(str(tmp_path), SEEDS[key])
    result = recipe(records, "cpu")
    print(json.dumps({key: result}))
    assert not failures(result), (failures(result), result)
    return result


@pytest.mark.slow
def test_detector_learns_synthetic_task(tmp_path):
    _run_slow(tmp_path, "learns")


@pytest.mark.slow
def test_inference_variants_preserve_trained_map(tmp_path):
    _run_slow(tmp_path, "variants")


@pytest.mark.slow
def test_qat_recovers_int8_accuracy(tmp_path):
    _run_slow(tmp_path, "qat")


# ------------------------------------------------ the recipe against JAX's

# The torch module of each JAX parameter path.
_TORCH_NAMES = {
    "SmallDet": {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
                 "Conv_3": "loc", "Conv_4": "conf"},
    "SmallDetQ": {f"{n}/Conv_0": n for n in
                  ("c1", "c2", "c3", "loc_head", "conf_head")},
}
_TORCH_MODELS = {"SmallDet": SmallDet, "SmallDetQ": SmallDetQ}


def _jax_toy(name: str):
    import test_learnability
    return getattr(test_learnability, name)()


def _numpy_params(jmodel, seed: int, conf_bias=None) -> dict:
    """A flax parameter tree of ``jmodel``'s shapes drawn from a numpy seed:
    kernels at lecun scale, small random biases; ``conf_bias`` (21,)
    offsets both anchors' class logits."""
    import jax
    import jax.numpy as jnp
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            fan_in = np.prod(leaf.shape[:3])
            return rng.normal(0, 1 / np.sqrt(fan_in),
                              leaf.shape).astype(np.float32)
        b = rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if conf_bias is not None and leaf.shape == (42,):
            b += np.tile(conf_bias, 2).astype(np.float32)
        return b
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _to_torch(name: str, params: dict) -> Dict[str, torch.Tensor]:
    flat = {}
    for top, node in params.items():
        if "kernel" not in node:                  # TorchConv's inner Conv_0
            top, node = f"{top}/Conv_0", node["Conv_0"]
        module = _TORCH_NAMES[name][top]
        flat[f"{module}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(node["kernel"])
                                 .transpose(3, 2, 0, 1)))
        flat[f"{module}.bias"] = torch.from_numpy(np.array(node["bias"]))
    return flat


def _grads_to_torch(name: str, grads: dict) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in _to_torch(name, grads).items()}


def _first_batch(tmp_path) -> dict:
    records = fixture_records(str(tmp_path), SEEDS["learns"])
    batch = next(iter(loaders(records)[0].epoch(0)))
    return {k: batch[k] for k in ("images", "boxes", "classes", "mask")}


@pytest.mark.parametrize("name", ["SmallDet", "SmallDetQ"])
def test_toy_three_steps_match_jax(tmp_path, name):
    import functools

    import jax
    import jax.numpy as jnp
    import optax

    from objectdetection_ssd_tpu import config as jconfig
    from objectdetection_ssd_tpu.train import loop as jloop
    from objectdetection_ssd_tpu.train import state as jstate

    batch = _first_batch(tmp_path)
    jmodel = _jax_toy(name)
    params = _numpy_params(jmodel, seed=11)
    jst = jstate.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
        jconfig.OptimConfig(lr=0.01, use_lr_schedule=False))
    jst = jst.replace(params=params, opt_state=jst.tx.init(params))
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))
    jloss = jconfig.LossConfig(match_iou_threshold=0.4)
    step = jax.jit(functools.partial(jloop.train_step, loss_config=jloss))
    jpriors = jnp.asarray(priors())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = _TORCH_MODELS[name]()
    model.load_state_dict(_to_torch(name, params), strict=True)
    state = new_state(model, "cpu")
    pri = torch.from_numpy(priors())
    for i in range(3):
        cap = jst.replace(tx=capture, opt_state=capture.init(jst.params))
        jgrads = _grads_to_torch(
            name, jax.device_get(step(cap, jbatch, jpriors)[0].opt_state))
        jst, jm = step(jst, jbatch, jpriors)
        state, m = loop_lib.train_step(state, batch, pri, LOSS)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        assert float(m["num_pos"]) == float(jm["num_pos"]) > 0
        got = dict(model.named_parameters())
        assert set(got) == set(jgrads)
        for key, want in jgrads.items():
            np.testing.assert_allclose(
                got[key].grad.numpy(), want, rtol=0,
                atol=5e-3 * np.abs(want).max(), err_msg=f"step {i} {key}")


def test_untrained_toy_map_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from objectdetection_ssd_tpu.config import \
        PostprocessConfig as JPostprocessConfig
    from objectdetection_ssd_tpu.eval.voc_map import voc_map as jvoc_map
    from objectdetection_ssd_tpu.infer.postprocess import postprocess
    from objectdetection_ssd_tpu.models.ssd import prepare_input

    records = fixture_records(str(tmp_path), SEEDS["learns"])
    eval_loader = loaders(records)[1]
    jmodel = _jax_toy("SmallDet")
    # Class 0 (aeroplane, one of the fixture's four) well above the rest,
    # so that untrained boxes pass the 0.3 score threshold.
    bias = np.full(21, -2.0)
    bias[0], bias[1] = 3.0, 1.0
    params = _numpy_params(jmodel, seed=12, conf_bias=bias)
    jpp = JPostprocessConfig(per_class_top_k=32, top_k=10,
                             score_threshold=0.3, use_approx_top_k=False)

    @jax.jit
    def infer(images):
        loc, conf = jmodel.apply({"params": params},
                                 prepare_input(images, jnp.float32))
        return postprocess(loc, conf, jnp.asarray(priors()), jpp)

    det_b, det_c, det_s, gt_b, gt_c = [], [], [], [], []
    for batch in eval_loader.epoch(0):
        dets = jax.device_get(infer(jnp.asarray(batch["images"])))
        for i in range(len(dets.valid)):
            v = dets.valid[i]
            det_b.append(dets.boxes_xyxy[i][v])
            det_c.append(dets.classes[i][v])
            det_s.append(dets.scores[i][v])
            m = batch["mask"][i]
            gt_b.append(batch["boxes"][i][m])
            gt_c.append(batch["classes"][i][m])
    _, want = jvoc_map(det_b, det_c, det_s, gt_b, gt_c)
    want = want * 20 / NUM_FIXTURE_CLASSES
    assert sum(len(b) for b in det_b) > 0 and want > 0

    got = map_variant("untrained", SmallDet, _to_torch("SmallDet", params),
                      eval_loader, "cpu")
    assert abs(got - want) <= 1e-6, (got, want)

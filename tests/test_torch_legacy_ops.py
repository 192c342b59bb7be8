"""The port's legacy box ops (`ops/boxes.py`: `mixed_class_nms`,
`decode_tanh`, the (y, x, y, x) converters, `pairwise_iou_rescaled`),
`ops/priors.py:ssd_paper_scale` and the package-level names, against the
JAX package's on the CPU.  Inputs are drawn with numpy from a seed.

* `mixed_class_nms`: keep masks equal to JAX's over 5 random trials and on
  batched inputs, with ties among the probabilities, and to the
  reference's own mask math (`Util.py:524-543`, transcribed as in
  `tests/test_legacy_ops.py`);
* the (y, x, y, x) family: exact;
* `decode_tanh` on the 189 zoom/ratio priors and `pairwise_iou_rescaled`
  with one image size and with per-image sizes: 1e-6;
* `ssd_paper_scale(1..6)`: equal.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu.ops import boxes as jboxes
from objectdetection_ssd_tpu.ops import priors as jpriors
from objectdetection_ssd_torch.ops import boxes as tboxes
from objectdetection_ssd_torch.ops import priors as tpriors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_set(rng, shape, num_classes=4, tie_levels=None):
    """Random xyxy boxes (shape + (4,)) inside [0, 1], class ids and
    probabilities; with ``tie_levels`` the probabilities take that many
    values, so many pairs tie."""
    ctr = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.1, 0.5, shape + (2,))
    xyxy = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    classes = rng.integers(0, num_classes, shape).astype(np.int32)
    if tie_levels:
        probs = rng.integers(1, tie_levels + 1, shape) / tie_levels
    else:
        probs = rng.uniform(0, 1, shape)
    return xyxy, classes, probs.astype(np.float32)


def _reference_removed(xyxy, classes, probs, thr):
    """The reference's removed set (`Util.py:524-543`): the union of
    where(iou & same_class & (prob_i < prob_j))[0] and
    where(iou & same_class & ~(prob_i < prob_j))[1], the diagonal's IoU
    set to 0.01 first."""
    n = xyxy.shape[0]
    t = torch.from_numpy(xyxy)
    lo = torch.max(t[:, None, :2], t[None, :, :2])
    hi = torch.min(t[:, None, 2:], t[None, :, 2:])
    inter = torch.clamp(hi - lo, min=0).prod(-1)
    area = (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
    iou_val = inter / (area[:, None] + area[None, :] - inter)
    iou_val.fill_diagonal_(0.01)
    p = torch.from_numpy(probs).view(1, n)
    cl = torch.from_numpy(classes.astype(np.float32)).view(1, n)
    iou = iou_val > thr
    same = (cl - cl.transpose(0, 1)) == 0
    iltj = (p.transpose(0, 1) - p) < 0
    removed = set(torch.where(iou & same & iltj)[0].tolist())
    removed |= set(torch.where(iou & same & ~iltj)[1].tolist())
    return removed


@pytest.mark.parametrize("tie_levels", [None, 5])
def test_mixed_class_nms_matches_jax_and_the_reference(tie_levels):
    rng = np.random.default_rng(0)
    thr = 0.3
    for trial in range(5):
        xyxy, classes, probs = _random_set(rng, (40,), tie_levels=tie_levels)
        got = tboxes.mixed_class_nms(torch.from_numpy(xyxy),
                                     torch.from_numpy(classes),
                                     torch.from_numpy(probs), thr).numpy()
        want = np.asarray(jboxes.mixed_class_nms(
            jnp.asarray(xyxy), jnp.asarray(classes), jnp.asarray(probs),
            thr))
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        assert set(np.flatnonzero(~got).tolist()) == _reference_removed(
            xyxy, classes, probs, thr), f"trial {trial}"


def test_mixed_class_nms_batched_matches_jax():
    rng = np.random.default_rng(1)
    xyxy, classes, probs = _random_set(rng, (2, 3, 24), tie_levels=4)
    got = tboxes.mixed_class_nms(torch.from_numpy(xyxy),
                                 torch.from_numpy(classes),
                                 torch.from_numpy(probs)).numpy()
    want = np.asarray(jboxes.mixed_class_nms(
        jnp.asarray(xyxy), jnp.asarray(classes), jnp.asarray(probs)))
    assert got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got, want)
    # Each set on its own gives the same mask: the sets do not mix.
    for i in range(2):
        for j in range(3):
            one = tboxes.mixed_class_nms(torch.from_numpy(xyxy[i, j]),
                                         torch.from_numpy(classes[i, j]),
                                         torch.from_numpy(probs[i, j]))
            np.testing.assert_array_equal(one.numpy(), got[i, j])


def test_mixed_class_nms_ties_suppress_both_and_never_self():
    box = [0.1, 0.1, 0.5, 0.5]
    xyxy = torch.tensor([box, box, [0.6, 0.6, 0.9, 0.9], box])
    keep = tboxes.mixed_class_nms(xyxy, torch.tensor([1, 1, 1, 2]),
                                  torch.tensor([0.7, 0.7, 0.9, 0.1]))
    # 0 and 1 tie: both go; 2 overlaps nothing; 3 is of another class.
    assert keep.tolist() == [False, False, True, True]


@pytest.mark.parametrize("fn", ["xyxy_to_yxyx", "yxyx_to_xyxy",
                                "cxcywh_to_yxyx", "yxyx_to_cxcywh"])
def test_yxyx_family_matches_jax_exactly(fn):
    x = np.random.default_rng(2).uniform(0.1, 0.9, (3, 7, 4)).astype(
        np.float32)
    got = getattr(tboxes, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jboxes, fn)(jnp.asarray(x)))
    assert got.shape == (3, 7, 4)
    np.testing.assert_array_equal(got, want)


def test_yxyx_converters_are_inverse_shuffles():
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (5, 4)).astype(np.float32))
    assert torch.equal(tboxes.xyxy_to_yxyx(x), x[:, [1, 0, 3, 2]])
    assert torch.equal(tboxes.yxyx_to_xyxy(tboxes.xyxy_to_yxyx(x)), x)


def test_decode_tanh_on_zoom_ratio_priors_matches_jax():
    pri, gs = tpriors.zoom_ratio_priors(reference_order=False)
    jpri, jgs = jpriors.zoom_ratio_priors(reference_order=False)
    np.testing.assert_array_equal(pri, jpri)
    np.testing.assert_array_equal(gs, jgs)
    pred = np.random.default_rng(4).normal(0, 1.5, (2, 189, 4)).astype(
        np.float32)
    got = tboxes.decode_tanh(torch.from_numpy(pred), pri, gs)
    want = np.asarray(jboxes.decode_tanh(jnp.asarray(pred), jnp.asarray(jpri),
                                         jnp.asarray(jgs)))
    assert got.shape == (2, 189, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # Tensors in, the same result; zero activations give the priors.
    again = tboxes.decode_tanh(torch.from_numpy(pred), torch.from_numpy(pri),
                               torch.from_numpy(gs))
    assert torch.equal(again, got)
    zero = tboxes.decode_tanh(torch.zeros(189, 4), pri, gs)
    np.testing.assert_allclose(zero.numpy(), pri, rtol=0, atol=1e-6)


def test_pairwise_iou_rescaled_matches_jax():
    rng = np.random.default_rng(5)
    sizes = np.asarray([[500.0, 375.0], [333.0, 480.0], [640.0, 427.0]],
                       np.float32)
    lo = rng.uniform(0, 0.5, (3, 6, 2)) * sizes[:, None]
    hi = lo + rng.uniform(0.1, 0.5, (3, 6, 2)) * sizes[:, None]
    raw = np.concatenate([lo, hi], -1).astype(np.float32)       # pixels
    olo = rng.uniform(0, 200, (3, 5, 2))
    other = np.concatenate([olo, olo + rng.uniform(20, 100, (3, 5, 2))],
                           -1).astype(np.float32)              # 300 frame
    # One size for every image, and one size per image, (B, 1, 2).
    for wh in (sizes[0], sizes[:, None, :]):
        got = tboxes.pairwise_iou_rescaled(torch.from_numpy(raw), wh,
                                           torch.from_numpy(other))
        want = np.asarray(jboxes.pairwise_iou_rescaled(
            jnp.asarray(raw), jnp.asarray(wh), jnp.asarray(other)))
        assert got.shape == (3, 6, 5) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # Per image: image i's boxes rescaled by image i's size.
    per = tboxes.pairwise_iou_rescaled(torch.from_numpy(raw),
                                       torch.from_numpy(sizes[:, None, :]),
                                       torch.from_numpy(other))
    for i in range(3):
        one = tboxes.pairwise_iou_rescaled(torch.from_numpy(raw[i]),
                                           sizes[i], torch.from_numpy(other[i]))
        np.testing.assert_array_equal(per[i].numpy(), one.numpy())


def test_ssd_paper_scale_matches_jax():
    got = [tpriors.ssd_paper_scale(k) for k in range(1, 7)]
    assert got == [jpriors.ssd_paper_scale(k) for k in range(1, 7)]
    assert got == [0.2, 0.34, 0.48, 0.62, 0.76, 0.9]


def test_package_level_names_resolve_to_the_submodules():
    # A fresh interpreter: the lazy names import their modules on first use.
    code = (
        "import importlib, sys\n"
        "import objectdetection_ssd_torch as pkg\n"
        "assert 'torch' not in sys.modules\n"
        "from objectdetection_ssd_torch import (Config, build_model,\n"
        "    ssd300_priors, postprocess, multibox_loss)\n"
        "for name, module in pkg._SOURCE.items():\n"
        "    obj = getattr(importlib.import_module(module), name)\n"
        "    assert getattr(pkg, name) is obj, name\n"
        "assert set(pkg.__all__) <= set(dir(pkg))\n"
        "print(len(pkg._SOURCE), pkg.__version__)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["31", "0.3.0"]

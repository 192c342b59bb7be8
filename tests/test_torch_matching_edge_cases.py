"""`tests/test_matching_edge_cases.py`'s matcher and loss edge cases on
the port, each also held to the JAX function on the same inputs: the
matched classes exactly, the losses to 1e-5 (rtol and atol)."""

import jax.numpy as jnp
import numpy as np
import torch

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.losses import multibox as jmultibox
from objectdetection_ssd_tpu.ops import matching as jmatching
from objectdetection_ssd_torch.config import LossConfig
from objectdetection_ssd_torch.losses.multibox import multibox_loss
from objectdetection_ssd_torch.ops import matching

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _match_both(gt, cls, mask, priors_xyxy):
    """The port's and JAX's `match_single`; their matched classes must be
    equal.  Returns the port's."""
    res = matching.match_single(_t(gt).float(), _t(cls).int(),
                                _t(mask).bool(), _t(priors_xyxy).float())
    jres = jmatching.match_single(jnp.asarray(gt, jnp.float32),
                                  jnp.asarray(cls, jnp.int32),
                                  jnp.asarray(mask), jnp.asarray(
                                      priors_xyxy, jnp.float32))
    np.testing.assert_array_equal(res.matched_class.numpy(),
                                  np.asarray(jres.matched_class))
    return res


def _loss_both(off, logits, boxes, classes, mask, pri, cfg=None):
    """The port's and JAX's `multibox_loss`; total, cls and loc must agree
    to 1e-5 and num_pos exactly.  Returns the port's."""
    out = multibox_loss(_t(off).float(), _t(logits).float(),
                        _t(boxes).float(), _t(classes).int(),
                        _t(mask).bool(), _t(pri).float(),
                        cfg or LossConfig())
    jcfg = (jconfig.LossConfig() if cfg is None
            else jconfig.LossConfig(loc_loss=cfg.loc_loss))
    jout = jmultibox.multibox_loss(
        jnp.asarray(off, jnp.float32), jnp.asarray(logits, jnp.float32),
        jnp.asarray(boxes, jnp.float32), jnp.asarray(classes, jnp.int32),
        jnp.asarray(mask), jnp.asarray(pri, jnp.float32), jcfg)
    for key in ("total", "cls", "loc"):
        np.testing.assert_allclose(float(getattr(out, key)),
                                   float(getattr(jout, key)), **TOL,
                                   err_msg=key)
    assert int(out.num_pos) == int(jout.num_pos)
    return out


def test_more_objects_than_priors():
    # Every object force-claims its best prior; with 4 objects and 2 priors
    # the later claimants win (in-place assignment order).
    priors_xyxy = [[0.0, 0.0, 0.5, 0.5],
                   [0.5, 0.5, 1.0, 1.0]]
    gt = [[0.0, 0.0, 0.4, 0.4],
          [0.05, 0.05, 0.45, 0.45],
          [0.55, 0.55, 0.95, 0.95],
          [0.6, 0.6, 1.0, 1.0]]
    res = _match_both(gt, [1, 2, 3, 4], np.ones(4, bool), priors_xyxy)
    assert res.matched_class[0] == 2   # object 1 overrode object 0
    assert res.matched_class[1] == 4   # object 3 overrode object 2


def test_identical_objects_tie():
    priors_xyxy = [[0.0, 0.0, 0.5, 0.5]]
    gt = [[0.0, 0.0, 0.5, 0.5],
          [0.0, 0.0, 0.5, 0.5]]
    res = _match_both(gt, [3, 7], np.ones(2, bool), priors_xyxy)
    # last object wins the forced claim
    assert res.matched_class[0] == 7


def test_mask_excludes_padded_duplicates():
    priors_xyxy = [[0.0, 0.0, 0.5, 0.5]]
    gt = [[0.0, 0.0, 0.5, 0.5],
          [0.0, 0.0, 0.5, 0.5]]
    res = _match_both(gt, [3, 7], np.asarray([True, False]), priors_xyxy)
    assert res.matched_class[0] == 3   # padded row 1 can't claim


def test_loss_batch_with_empty_image():
    """An image with zero GT contributes no positives; the batch must still
    produce finite losses driven by the other image."""
    pri = np.asarray([[0.25, 0.25, 0.5, 0.5], [0.75, 0.75, 0.3, 0.3]],
                     np.float32)
    boxes = np.zeros((2, 2, 4), np.float32)
    classes = np.zeros((2, 2), np.int32)
    mask = np.zeros((2, 2), bool)
    boxes[0, 0] = [0.0, 0.0, 0.5, 0.5]
    classes[0, 0] = 5
    mask[0, 0] = True
    logits = np.zeros((2, 2, 21), np.float32)
    off = np.zeros((2, 2, 4), np.float32)
    out = _loss_both(off, logits, boxes, classes, mask, pri)
    assert np.isfinite(float(out.total))
    assert int(out.num_pos) == 1


def test_loss_all_empty_batch_is_finite():
    pri = np.asarray([[0.5, 0.5, 0.2, 0.2]], np.float32)
    out = _loss_both(np.zeros((1, 1, 4)), np.zeros((1, 1, 21)),
                     np.zeros((1, 2, 4)), np.zeros((1, 2), np.int32),
                     np.zeros((1, 2), bool), pri)
    assert np.isfinite(float(out.total))
    assert int(out.num_pos) == 0


def test_huber_option_differs_from_l1():
    rng = np.random.default_rng(0)
    pri = np.concatenate([rng.uniform(0.3, 0.7, (8, 2)),
                          rng.uniform(0.2, 0.4, (8, 2))], 1).astype(np.float32)
    gt = np.asarray([[[0.3, 0.3, 0.7, 0.7]]], np.float32)
    cls = np.asarray([[2]], np.int32)
    mask = np.ones((1, 1), bool)
    off = rng.normal(0, 3, (1, 8, 4)).astype(np.float32)   # big errors
    logits = rng.normal(0, 1, (1, 8, 21)).astype(np.float32)
    l1 = _loss_both(off, logits, gt, cls, mask, pri, LossConfig(loc_loss="l1"))
    hub = _loss_both(off, logits, gt, cls, mask, pri,
                     LossConfig(loc_loss="huber"))
    assert float(hub.loc) < float(l1.loc)   # huber caps large residuals
    np.testing.assert_allclose(float(hub.cls), float(l1.cls), rtol=1e-6)

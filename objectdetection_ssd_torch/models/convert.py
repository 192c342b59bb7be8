"""Weight bridges into this port's ``state_dict`` — the port of
`objectdetection_ssd_tpu/models/convert.py`, plus the inverse bridge from
the JAX package's variables.

`from_flax_params`: the JAX models' variables (the nested dict of numpy
arrays that ``init`` returns, or its ``"params"`` entry) -> state_dict, so
no flax is needed here:

  ``trunk/conv1_1/Conv_0/{kernel,bias}`` -> ``trunk.conv1_1.{weight,bias}``
  ``l2norm_4_3/scale``                   -> ``l2norm_4_3.scale``
  BN ``.../bn1/{scale,bias}``            -> ``....bn1.{weight,bias}``
  ``batch_stats`` ``.../bn1/{mean,var}`` -> ``....bn1.running_{mean,var}``

Kernels go from flax HWIO to torch OIHW, the inverse of
`objectdetection_ssd_tpu/models/convert.py:_conv`.  Output-channel order is
kept, so each head's (anchor, coord/class) interleave is unchanged.  Load the
result with ``load_state_dict(strict=True)`` so that a missing or extra name
fails loudly.

The torch loaders (the ``--init-*`` flags) map a torchvision ``vgg16`` or
``resnet34`` state_dict, or a reference SSD_300 checkpoint
(`train_function.py:114-120`), straight to this port's names; torch convs
are already OIHW.  VGG's fully-connected fc6/fc7 become the atrous conv_fc6
and the 1x1 conv_fc7 by strided decimation (`subsample`, reference
`Util.py:555-560`, `Model.py:145-157`).  `merge_state_dict` lays such a
partial state_dict over a model's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
# The JAX models' BatchNorm module names: bn, bn1, stem_bn, downsample_bn.
_BN_NAME = re.compile(r"(.*_)?bn\d*")


def from_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested flax variables (numpy leaves) -> torch ``state_dict``.

    Takes the params tree or the whole variables dict of ``init``; of the
    latter ``"params"`` and ``"batch_stats"`` are read (``quant_stats`` is
    calibration state).  A ``scale`` leaf is a BatchNorm's ``weight`` when
    its module is named as the JAX models name their BNs (``bn``, ``bn1``,
    ``stem_bn``, ``downsample_bn``), else it stays ``scale`` (the L2Norm).
    """
    stats: Mapping[str, Any] = {}
    if "params" in tree:
        stats = tree.get("batch_stats", {})
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, np.float32)
        *modules, leaf_name = (p for p in path if p != "Conv_0")
        if leaf_name == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected an HWIO kernel,"
                                 f" got shape {arr.shape}")
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf_name == "scale" and modules and _BN_NAME.fullmatch(
                modules[-1]):
            name = "weight"
        elif leaf_name in ("bias", "scale"):
            name = leaf_name
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(modules + [name])] = torch.tensor(arr)
    for path, leaf in _flatten(stats):
        *modules, leaf_name = path
        if leaf_name not in _STAT_NAMES:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        out[".".join(modules + [_STAT_NAMES[leaf_name]])] = torch.tensor(
            np.asarray(leaf, np.float32))
    return out


def _np(x) -> np.ndarray:
    """A torch tensor or array as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.tensor(_np(x))


def subsample(x: np.ndarray, steps: Sequence[Optional[int]]) -> np.ndarray:
    """Strided decimation per dimension; None keeps the dim
    (the reference's `subsampling`, `Util.py:555-560`)."""
    for d, s in enumerate(steps):
        if s is None:
            continue
        x = np.take(x, np.arange(0, x.shape[d], s), axis=d)
    return x


def _conv(out: Dict[str, torch.Tensor], name: str, w, b=None) -> None:
    out[f"{name}.weight"] = _t(w)
    if b is not None:
        out[f"{name}.bias"] = _t(b)


# torchvision vgg16 `features.<idx>` conv indices -> our trunk module names.
_VGG_FEATURE_MAP = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}


def vgg16_trunk_params(state_dict: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 state_dict -> ``trunk.*`` entries of `SSD300`."""
    out: Dict[str, torch.Tensor] = {}
    for idx, name in _VGG_FEATURE_MAP.items():
        _conv(out, f"trunk.{name}", state_dict[f"features.{idx}.weight"],
              state_dict[f"features.{idx}.bias"])
    fc6_w = _np(state_dict["classifier.0.weight"]).reshape(4096, 512, 7, 7)
    _conv(out, "trunk.conv_fc6",
          subsample(fc6_w, [4, None, 3, 3]),               # (1024, 512, 3, 3)
          subsample(_np(state_dict["classifier.0.bias"]), [4]))
    fc7_w = _np(state_dict["classifier.3.weight"]).reshape(4096, 4096, 1, 1)
    _conv(out, "trunk.conv_fc7",
          subsample(fc7_w, [4, 4, None, None]),            # (1024, 1024, 1, 1)
          subsample(_np(state_dict["classifier.3.bias"]), [4]))
    return out


_REF_EXTRAS = ("seq8", "seq9", "seq10", "seq11")
_REF_HEAD_MAP = {
    "c_4_bb": "loc_head_0", "c_4_cl": "conf_head_0",
    "c_7_bb": "loc_head_1", "c_7_cl": "conf_head_1",
    "c_8_bb": "loc_head_2", "c_8_cl": "conf_head_2",
    "c_9_bb": "loc_head_3", "c_9_cl": "conf_head_3",
    "c_10_bb": "loc_head_4", "c_10_cl": "conf_head_4",
    "c_11_bb": "loc_head_5", "c_11_cl": "conf_head_5",
}
# conv_4_3 Sequential: vgg features 0..15 at the same positions, the ceil
# pool at 16, then conv4_x at 17/19/21 (`Model.py:135-139`).  seq5 holds
# conv5_x at Sequential positions 1/3/5 (`Model.py:140-143`).
_REF_CONV43_IDX = {k: v for k, v in _VGG_FEATURE_MAP.items() if k <= 21}
_REF_SEQ5_IDX = {1: "conv5_1", 3: "conv5_2", 5: "conv5_3"}


def ssd300_reference_params(cnn_state_dict: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """Reference SSD_300 checkpoint -> the full `SSD300` state_dict."""
    sd = cnn_state_dict
    out: Dict[str, torch.Tensor] = {}
    for idx, name in _REF_CONV43_IDX.items():
        _conv(out, f"trunk.{name}", sd[f"conv_4_3.{idx}.weight"],
              sd[f"conv_4_3.{idx}.bias"])
    for idx, name in _REF_SEQ5_IDX.items():
        _conv(out, f"trunk.{name}", sd[f"seq5.{idx}.weight"],
              sd[f"seq5.{idx}.bias"])
    for name in ("conv_fc6", "conv_fc7"):
        _conv(out, f"trunk.{name}", sd[f"{name}.weight"], sd[f"{name}.bias"])
    # (1, 512, 1, 1) -> (512,)
    out["l2norm_4_3.scale"] = _t(_np(sd["rescaling_conv_4_3"]).reshape(-1))
    for ref in _REF_EXTRAS:
        # Sequential(conv, relu, conv, relu): convs at 0 and 2
        # (`Model.py:163-166`).
        _conv(out, f"{ref}_1", sd[f"{ref}.0.weight"], sd[f"{ref}.0.bias"])
        _conv(out, f"{ref}_2", sd[f"{ref}.2.weight"], sd[f"{ref}.2.bias"])
    for ref, ours in _REF_HEAD_MAP.items():
        _conv(out, ours, sd[f"{ref}.weight"], sd[f"{ref}.bias"])
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference torch checkpoint file (its ``cnn_state_dict``, or a
    bare state_dict) and convert it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["cnn_state_dict"] if "cnn_state_dict" in ckpt else ckpt
    return ssd300_reference_params(sd)


def _bn(out: Dict[str, torch.Tensor], name: str,
        sd: Mapping[str, Any], prefix: str) -> None:
    """torch BatchNorm2d ``prefix`` -> the port's `BatchNorm` ``name`` (the
    same four names; ``num_batches_tracked`` has no counterpart)."""
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{leaf}"] = _t(sd[f"{prefix}.{leaf}"])


def resnet34_trunk_params(state_dict: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """torchvision resnet34 state_dict -> ``trunk.*`` entries (parameters
    and BN statistics) of `SSDResNet34` (the reference's pretrained frozen
    trunk, `Model.py:21-30,81-86`)."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "trunk.stem_conv", state_dict["conv1.weight"])
    _bn(out, "trunk.stem_bn", state_dict, "bn1")
    for si, n_blocks in enumerate((3, 4, 6, 3)):
        for b in range(n_blocks):
            t = f"layer{si + 1}.{b}"
            name = f"trunk.layer{si + 1}_block{b + 1}"
            _conv(out, f"{name}.conv1", state_dict[f"{t}.conv1.weight"])
            _conv(out, f"{name}.conv2", state_dict[f"{t}.conv2.weight"])
            _bn(out, f"{name}.bn1", state_dict, f"{t}.bn1")
            _bn(out, f"{name}.bn2", state_dict, f"{t}.bn2")
            if f"{t}.downsample.0.weight" in state_dict:
                _conv(out, f"{name}.downsample_conv",
                      state_dict[f"{t}.downsample.0.weight"])
                _bn(out, f"{name}.downsample_bn", state_dict,
                    f"{t}.downsample.1")
    return out


def merge_state_dict(base: Mapping[str, torch.Tensor],
                     overrides: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``base`` with a subset of its entries replaced by ``overrides`` (cast
    to base's dtype and device).  Every override must name an entry of
    ``base`` with the same shape — a converter/model drift fails loudly
    instead of training from a silently partial init."""
    merged = dict(base)
    for key, value in overrides.items():
        if key not in base:
            raise KeyError(f"init override {key} not present in the model "
                           f"(model entries: {sorted(base)[:8]}...)")
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(base[key].shape):
            raise ValueError(f"init override {key}: shape "
                             f"{tuple(value.shape)} != model "
                             f"{tuple(base[key].shape)}")
        merged[key] = value.to(base[key].device, base[key].dtype)
    return merged

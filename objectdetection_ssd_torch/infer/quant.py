"""Post-training int8 quantization (PTQ) and quantization-aware training
scales — the port of `objectdetection_ssd_tpu/infer/quant.py`.

Symmetric PTQ without model-code changes:
  * `calibrate` runs the float model and records every conv's input
    ``max|x|`` (`models/layers.py:TorchConv`); a module applied twice (the
    ResNet-34 ``neck_down``) gets the max over both calls, and batches fold
    by a running max.
  * `act_scales` turns them into a scale tree ``{module path: {"act_scale":
    absmax / 127}}``, keyed by the JAX module paths (``trunk/conv1_1``), so
    a tree or a ``quant_scales.json`` written by the JAX package drives the
    port unchanged.  The heads stay float unless ``quantize_heads``.
  * `chain_scales` adds ``out_scale`` (the consumer's ``act_scale``) on each
    exact requant-chain edge; `attach_scales` hands the tree to the convs,
    which then run int8 on kernel K3 (or, for QAT, straight-through
    fake-quant) through the model's usual ``forward``.
  * The scales are bound to the weights they were made for by
    `param_fingerprint`; `verify_scales_binding` refuses a file made for
    other weights.

Scale trees are nested dicts of floats (``np.float32`` or f32 tensors).

Typical use::

    stats = calibrate(model, batches)
    qtree = chain_scales(act_scales(stats), "vgg16")
    detector = Detector(cfg, state_dict, quant=qtree)
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import sys
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from objectdetection_ssd_torch.models.layers import ConvQuant, TorchConv

# Head convs stay float by default: the path segments of SSD300's
# loc_head_i / conf_head_i and SSDResNet34's loc_t* / conf_t*.
DEFAULT_EXCLUDE_PREFIXES = ("loc", "conf")

SCALES_FILENAME = "quant_scales.json"
_FORMAT = "act_scales/1"

Path = Tuple[str, ...]


def _leaves(tree: Mapping[str, Any], prefix: Path = ()
            ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of a nested dict, keys sorted at every level (the order
    of JAX's ``tree_flatten_with_path``)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _set(tree: Dict[str, Any], path: Path, value: Any) -> None:
    node = tree
    for seg in path[:-1]:
        node = node.setdefault(seg, {})
    node[path[-1]] = value


def _convs(model: nn.Module) -> Dict[Path, TorchConv]:
    return {tuple(name.split(".")): m for name, m in model.named_modules()
            if isinstance(m, TorchConv)}


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[Any]) -> Dict[str, Any]:
    """Run ``batches`` through the float ``model`` in eval mode (BatchNorm
    on its running statistics) and return every conv's input ``max|x|`` in
    f32 as ``{path...: {"absmax": np.float32}}``, a running max across
    batches (and across the calls of one module within a forward).  An
    empty input records 0.

    ``batches``: image batches as the model takes them (uint8 or
    normalized NHWC), numpy arrays or tensors.  The model must have no
    scales attached."""
    convs = _convs(model)
    if any(conv.quant is not None for conv in convs.values()):
        raise ValueError("calibrate runs the float model: detach_scales "
                         "first")
    device = next(model.parameters()).device
    running: Dict[Path, torch.Tensor] = {}

    def hook(path):
        def record(module, args):
            x = args[0]
            absmax = (x.float().abs().amax() if x.numel()
                      else torch.zeros((), device=x.device))
            prev = running.get(path)
            running[path] = absmax if prev is None else torch.maximum(
                prev, absmax)
        return record

    handles = [conv.register_forward_pre_hook(hook(path))
               for path, conv in convs.items()]
    was_training = model.training
    model.eval()
    n_batches = 0
    try:
        for images in batches:
            model(torch.as_tensor(images).to(device))
            n_batches += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if n_batches == 0:
        raise ValueError("calibrate() needs at least one batch")
    paths = sorted(running)
    values = torch.stack([running[p] for p in paths]).cpu().numpy()
    out: Dict[str, Any] = {}
    for path, value in zip(paths, values):
        _set(out, path + ("absmax",), np.float32(value))
    return out


def act_scales(stats: Mapping[str, Any],
               keep: Optional[Callable[[Path], bool]] = None,
               quantize_heads: bool = False) -> Dict[str, Any]:
    """The scale tree of calibration ``stats``: each ``absmax`` leaf becomes
    ``act_scale = absmax / 127`` (f32), and modules ``keep(path)`` rejects
    are dropped.  By default any path with a segment starting with
    ``loc``/``conf`` (the heads) is dropped; ``quantize_heads`` keeps
    them."""
    if keep is None:
        if quantize_heads:
            keep = lambda path: True                       # noqa: E731
        else:
            keep = lambda path: not any(                   # noqa: E731
                seg.startswith(DEFAULT_EXCLUDE_PREFIXES) for seg in path)
    out: Dict[str, Any] = {}
    for path, absmax in _leaves(stats):
        if path[-1] != "absmax":
            raise ValueError(f"not a calibration leaf: {'/'.join(path)}")
        if keep(path[:-1]):
            _set(out, path[:-1] + ("act_scale",),
                 np.float32(np.asarray(absmax) / 127.0))
    return out


# Requant-chain edges of the SSD300/VGG16 family: (producer, consumer)
# paths where the producer's output has exactly one consumer and only
# quantization-commuting ops (ReLU, max pool: both monotone) lie between,
# so the producer can emit int8 in the consumer's scale with bit-identical
# results.  Left out, because a second float consumer reads their output:
# conv4_3 (the L2Norm tap), conv_fc7 (a head tap) and every seq*_2 (its
# head pair and the next pyramid stage).
VGG16_CHAIN_EDGES: Tuple[Tuple[Path, Path], ...] = (
    (("trunk", "conv1_1"), ("trunk", "conv1_2")),
    (("trunk", "conv1_2"), ("trunk", "conv2_1")),      # across pool1
    (("trunk", "conv2_1"), ("trunk", "conv2_2")),
    (("trunk", "conv2_2"), ("trunk", "conv3_1")),      # across pool2
    (("trunk", "conv3_1"), ("trunk", "conv3_2")),
    (("trunk", "conv3_2"), ("trunk", "conv3_3")),
    (("trunk", "conv3_3"), ("trunk", "conv4_1")),      # across ceil pool3
    (("trunk", "conv4_1"), ("trunk", "conv4_2")),
    (("trunk", "conv4_2"), ("trunk", "conv4_3")),
    (("trunk", "conv5_1"), ("trunk", "conv5_2")),
    (("trunk", "conv5_2"), ("trunk", "conv5_3")),
    (("trunk", "conv5_3"), ("trunk", "conv_fc6")),     # across 3x3/1 pool5
    (("trunk", "conv_fc6"), ("trunk", "conv_fc7")),
    (("seq8_1",), ("seq8_2",)),
    (("seq9_1",), ("seq9_2",)),
    (("seq10_1",), ("seq10_2",)),
    (("seq11_1",), ("seq11_2",)),
)

CHAIN_EDGES = {"vgg16": VGG16_CHAIN_EDGES,
               # BatchNorm (an affine map, not quantization-commuting) sits
               # between ResNet-34's convs: no exact edge.
               "resnet34": ()}


def _subtree(tree: Mapping[str, Any], path: Path):
    node = tree
    for seg in path:
        if not isinstance(node, Mapping) or seg not in node:
            return None
        node = node[seg]
    return node


def chain_scales(qtree: Mapping[str, Any],
                 backbone: str = "vgg16") -> Dict[str, Any]:
    """A copy of ``qtree`` in which the producer of every
    ``CHAIN_EDGES[backbone]`` edge whose two ends are both quantized gains
    ``out_scale = consumer.act_scale``: its K3 epilogue then emits int8 in
    the consumer's scale.  Bit-identical to the unchained graph."""
    out = copy.deepcopy(dict(qtree))
    for src, dst in CHAIN_EDGES.get(backbone, ()):
        s, d = _subtree(out, src), _subtree(out, dst)
        if (isinstance(s, dict) and "act_scale" in s
                and isinstance(d, dict) and "act_scale" in d):
            s["out_scale"] = d["act_scale"]
    return out


def unchain_scales(qtree: Mapping[str, Any]) -> Dict[str, Any]:
    """A copy of ``qtree`` without any ``out_scale`` (the inverse of
    `chain_scales`): a QAT run saves the chained tree, and
    ``--no-int8-chain`` must strip it."""
    out = copy.deepcopy(dict(qtree))

    def strip(node):
        if isinstance(node, dict):
            node.pop("out_scale", None)
            for v in node.values():
                strip(v)
    strip(out)
    return out


def count_quantized(qtree: Mapping[str, Any]) -> int:
    """Convs the tree quantizes (``act_scale`` leaves)."""
    return sum(1 for path, _ in _leaves(qtree) if path[-1] == "act_scale")


def attach_scales(model: nn.Module, qtree: Mapping[str, Any],
                  straight_through: bool = False) -> nn.Module:
    """Make the convs of ``qtree`` run quantized: int8 on K3, or with
    ``straight_through`` the QAT fake-quant branch; every other conv runs
    float (earlier scales are dropped).  The outputs are in the model's
    compute dtype (``model.dtype``, else f32).  Raises KeyError for a path
    that names no conv of ``model`` and ValueError for a leaf other than
    ``act_scale`` / ``out_scale``.  Returns ``model``."""
    convs = _convs(model)
    nodes: Dict[Path, Dict[str, Any]] = {}
    for path, value in _leaves(qtree):
        if path[-1] not in ("act_scale", "out_scale"):
            raise ValueError(f"unknown scale leaf {'/'.join(path)}")
        if path[:-1] not in convs:
            raise KeyError(f"no conv at {'/'.join(path[:-1])} of the "
                           "model")
        nodes.setdefault(path[:-1], {})[path[-1]] = value
    dtype = getattr(model, "dtype", torch.float32)
    quant = {}
    for path, node in nodes.items():
        if "act_scale" not in node:
            raise ValueError(f"{'/'.join(path)} has an out_scale and no "
                             "act_scale")
        device = convs[path].weight.device

        def scale(v):
            return torch.clamp_min(torch.as_tensor(
                v, dtype=torch.float32).to(device), 1e-12)

        quant[path] = ConvQuant(
            act_scale=scale(node["act_scale"]),
            out_scale=(None if "out_scale" not in node
                       else scale(node["out_scale"])),
            dtype=dtype, straight_through=straight_through)
    for path, conv in convs.items():
        conv.quant = quant.get(path)
    return model


def detach_scales(model: nn.Module) -> nn.Module:
    """Every conv of ``model`` back to float.  Returns ``model``."""
    for conv in _convs(model).values():
        conv.quant = None
    return model


@contextlib.contextmanager
def scales_attached(model: nn.Module, qtree: Optional[Mapping[str, Any]],
                    straight_through: bool = False):
    """`attach_scales` for the duration of the block (nothing when
    ``qtree`` is None), then `detach_scales`."""
    if qtree is None:
        yield model
        return
    attach_scales(model, qtree, straight_through)
    try:
        yield model
    finally:
        detach_scales(model)


def scales_to(qtree: Mapping[str, Any], device) -> Dict[str, Any]:
    """The tree with every leaf a f32 scalar tensor on ``device``."""
    out: Dict[str, Any] = {}
    for path, value in _leaves(qtree):
        _set(out, path, torch.as_tensor(value, dtype=torch.float32).to(
            device))
    return out


def param_fingerprint(state_dict: Mapping[str, torch.Tensor]) -> str:
    """sha256 over a ``state_dict``'s entries in sorted key order: each
    key, dtype, shape and bytes.  Binds a saved scale file to the exact
    weights it was made for, whatever device they live on."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        t = state_dict[key].detach().cpu().contiguous()
        h.update(key.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def save_scales(qtree: Mapping[str, Any], path: str,
                fingerprint: Union[None, str, Sequence[str]] = None,
                epoch: Optional[int] = None) -> None:
    """Write a scale tree as ``act_scales/1`` JSON (``a/b/act_scale`` ->
    float), with the fingerprints of the weights it serves (the raw and the
    EMA weights of a QAT run) and the checkpoint's epoch."""
    blob: Dict[str, Any] = {
        "format": _FORMAT,
        "scales": {"/".join(p): float(v) for p, v in _leaves(qtree)}}
    if fingerprint is not None:
        fps: List[str] = ([fingerprint] if isinstance(fingerprint, str)
                          else list(fingerprint))
        blob["param_fingerprint"] = fps[0]
        if len(fps) > 1:
            blob["param_fingerprints"] = fps
    if epoch is not None:
        blob["epoch"] = int(epoch)
    with open(path, "w") as f:
        json.dump(blob, f, indent=2)


def _read_scales_blob(path: str) -> Dict[str, Any]:
    with open(path) as f:
        blob = json.load(f)
    if blob.get("format") != _FORMAT:
        raise ValueError(f"{path}: not an {_FORMAT} file")
    return blob


def load_scales(path: str) -> Dict[str, Any]:
    """The scale tree of a `save_scales` file (np.float32 leaves)."""
    out: Dict[str, Any] = {}
    for key, val in _read_scales_blob(path)["scales"].items():
        _set(out, tuple(key.split("/")), np.float32(val))
    return out


def load_scales_meta(path: str) -> Dict[str, Any]:
    """A scale file's binding: ``param_fingerprint``,
    ``param_fingerprints`` and ``epoch``, where present."""
    blob = _read_scales_blob(path)
    return {k: blob[k] for k in ("param_fingerprint", "param_fingerprints",
                                 "epoch") if k in blob}


def verify_scales_binding(path: str,
                          state_dict: Mapping[str, torch.Tensor]) -> None:
    """ValueError when ``path`` records fingerprints and none is
    ``state_dict``'s: the scales were made for other weights.  A file
    without a fingerprint passes with a warning on stderr."""
    meta = load_scales_meta(path)
    want = meta.get("param_fingerprints") or (
        [meta["param_fingerprint"]] if "param_fingerprint" in meta else None)
    if want is None:
        print(f"warning: {path} has no param fingerprint; cannot verify it "
              "matches the checkpoint", file=sys.stderr)
        return
    got = param_fingerprint(state_dict)
    if got not in want:
        raise ValueError(
            f"{path} was produced for different weights (fingerprint "
            f"{want[0][:12]}... vs checkpoint {got[:12]}...): the "
            "checkpoint directory was retrained without --qat, or the file "
            "was copied.  Pass --recalibrate to ignore it and calibrate "
            "fresh scales, or re-run `train --qat` to produce matching "
            "ones.")

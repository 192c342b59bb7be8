"""Weight bridge: the JAX package's SSD300 parameter tree -> this port's
``state_dict``.

The tree is the nested dict of numpy arrays that ``SSD300().init(...)``
returns (or its ``"params"`` entry), so no flax is needed here:

  ``trunk/conv1_1/Conv_0/{kernel,bias}`` -> ``trunk.conv1_1.{weight,bias}``
  ``l2norm_4_3/scale``                   -> ``l2norm_4_3.scale``
  ``seq8_1`` ... ``seq11_2``, ``loc_head_i``, ``conf_head_i`` likewise.

Kernels go from flax HWIO to torch OIHW, the inverse of
`objectdetection_ssd_tpu/models/convert.py:_conv`.  Output-channel order is
kept, so each head's (anchor, coord/class) interleave is unchanged.  Load the
result with ``load_state_dict(strict=True)`` so that a missing or extra name
fails loudly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested flax SSD300 params (numpy leaves) -> torch ``state_dict``.

    Takes the params tree or the whole variables dict of ``init``; of the
    latter only ``"params"`` is read (``quant_stats`` is calibration state).
    """
    if "params" in tree:
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
        elif leaf_name in ("bias", "scale"):
            name = leaf_name
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(modules + [name])] = torch.tensor(arr)
    return out

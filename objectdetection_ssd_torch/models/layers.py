"""Building-block layers — the port of `objectdetection_ssd_tpu/models/layers.py`.

The JAX package works NHWC and gives every conv and pool explicit symmetric
padding so that the SSD300 pyramid follows torch's output-size arithmetic.
Here the layers are torch's own, in NCHW (``channels_last`` memory on the
card); what this module adds is the flax initialisers, flax's ``dtype=``
casts (each conv computes in its input's dtype, casting its weight and
bias at use), the routing of a conv's filter gradient through kernel K2,
the L2Norm arithmetic and the NHWC head flatten.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_ssd_torch.ops.dw_cuda import conv3x3p1

# flax's truncated-normal stddev correction: the std of a unit normal cut to
# [-2, 2] (`jax.nn.initializers.variance_scaling`).
_TRUNC_STD = 0.87962566103423978


class TorchConv(nn.Conv2d):
    """Conv2d with the JAX `TorchConv`'s geometry arguments and flax init.

    ``kernel_init`` names the flax initialiser of the counterpart:
    ``"lecun_normal"`` (flax's default, the VGG trunk) or
    ``"xavier_uniform"`` (extra pyramid and heads, reference
    `Model.py:198-200`).  Biases start at zero.

    The conv computes in its input's dtype: the weight and bias are cast to
    it at use (no-ops when they already are), which is flax's ``dtype=``
    for a model whose parameters stay f32.

    ``dw_pallas``: route the filter gradient through kernel K2
    (`ops/dw_cuda.py:Conv3x3P1`), as the JAX `TorchConv(dw_pallas=True)`
    routes it through its Pallas kernel.  Only 3x3/stride-1/pad-1/
    dilation-1 geometry takes the route; other geometry stays on the plain
    conv.  Either way the parameters are ``weight`` and ``bias``, so a
    ``state_dict`` loads into both.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 kernel_init: str = "lecun_normal", dw_pallas: bool = False):
        if kernel_init not in ("lecun_normal", "xavier_uniform"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.kernel_init = kernel_init
        self.dw_route = dw_pallas and (kernel, stride, padding, dilation) \
            == (3, 1, 1, 1)
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=padding, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(x.dtype)
        bias = self.bias.to(x.dtype)
        if self.dw_route:
            # The bias is added outside the Function, as the JAX
            # `_DWPallasConv` adds it (`layers.py:160-162`).
            return conv3x3p1(x, weight) + bias[:, None, None]
        return self._conv_forward(x, weight, bias)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            if self.kernel_init == "xavier_uniform":
                nn.init.xavier_uniform_(self.weight, generator=generator)
            else:
                fan_in = self.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
            nn.init.zeros_(self.bias)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """Max pool with torch semantics: -inf padding, and ``ceil_mode``
    extends the grid at the bottom/right (reference pool3, `Model.py:137`).
    The JAX counterpart pads explicitly to get the same windows."""
    return F.max_pool2d(x, window, stride, padding=padding,
                        ceil_mode=ceil_mode)


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learnable per-channel rescale
    (reference `Model.py:132-133,206-210`).

    ``x / sqrt(sum(x^2) + eps) * scale`` with the sum in f32 and the norm
    cast back to ``x.dtype`` — the JAX `L2Norm` (`layers.py:316-322`).  Not
    `F.normalize`, which clamps the norm instead of adding ``eps``.
    """

    def __init__(self, channels: int, scale_init: float = 20.0,
                 epsilon: float = 1e-12):
        super().__init__()
        self.scale_init = scale_init
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.full((channels,), scale_init))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, C, H, W)
        sumsq = torch.sum(torch.square(x.float()), dim=1, keepdim=True)
        norm = torch.sqrt(sumsq + self.epsilon)
        return (x / norm.to(x.dtype)) * self.scale.to(x.dtype)[:, None, None]


def flatten_head(x: torch.Tensor, last: int) -> torch.Tensor:
    """(B, k*last, H, W) -> (B, H*W*k, last), rows ordered by
    (row, col, anchor) like the priors — the reference's
    permute(0,2,3,1)+view (`Model.py:212`) and the JAX NHWC reshape."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, last)

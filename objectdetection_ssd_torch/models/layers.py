"""Building-block layers — the port of `objectdetection_ssd_tpu/models/layers.py`.

The JAX package works NHWC and gives every conv and pool explicit symmetric
padding so that the SSD300 pyramid follows torch's output-size arithmetic.
Here the layers are torch's own, in NCHW (``channels_last`` memory on the
card); what this module adds is the flax initialisers, flax's ``dtype=``
casts (each conv computes in its input's dtype, casting its weight and
bias at use), the routing of a conv's filter gradient through kernel K2,
the L2Norm arithmetic, flax's BatchNorm and Dropout semantics (the ResNet-34
family) and the NHWC head flatten.
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
    `Model.py:198-200`).  Biases start at ``bias_init`` (default zero);
    ``use_bias=False`` gives a conv without one (the ResNet trunk).

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
                 kernel_init: str = "lecun_normal", dw_pallas: bool = False,
                 use_bias: bool = True, bias_init: float = 0.0):
        if kernel_init not in ("lecun_normal", "xavier_uniform"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.dw_route = dw_pallas and (kernel, stride, padding, dilation) \
            == (3, 1, 1, 1)
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=padding, dilation=dilation, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.dw_route:
            # The bias is added outside the Function, as the JAX
            # `_DWPallasConv` adds it (`layers.py:160-162`).
            y = conv3x3p1(x, weight)
            return y if bias is None else y + bias[:, None, None]
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
            if self.bias is not None:
                nn.init.constant_(self.bias, self.bias_init)


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


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` (flax 0.12) on NCHW activations, which
    torch's ``nn.BatchNorm2d`` is not:

    * train mode normalizes with the batch statistics, computed in f32
      (or wider) whatever the input dtype, the variance as
      ``mean(x^2) - mean(x)^2`` clipped at 0 (biased;
      ``use_fast_variance``), and updates the running statistics
      ``r <- 0.99 * r + 0.01 * batch`` once per call, in f32 and outside
      autograd;
    * eval mode normalizes with the running statistics (`F.batch_norm`,
      which updates nothing);
    * epsilon 1e-5; the output is ``(x - mean) * (rsqrt(var + eps) *
      weight) + bias`` in f32, cast to the input's dtype.

    Parameters ``weight`` / ``bias`` and buffers ``running_mean`` /
    ``running_var`` stay f32 in every model (`models.ssd.build_model`), as
    flax keeps ``scale``, ``bias`` and ``batch_stats`` f32; their names are
    torch's, so a torchvision ``BatchNorm2d`` state_dict maps one to one
    (without ``num_batches_tracked``).  Train mode also takes a batch with
    one value per channel (variance 0), as flax does.
    """

    MOMENTUM = 0.99
    EPSILON = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.EPSILON)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.detach())
        mul = torch.rsqrt(var + self.EPSILON) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` with an explicit generator: in train mode each
    element (``channelwise=False``) or each (image, channel) plane
    (``channelwise=True``, flax ``broadcast_dims=(1, 2)`` on NHWC, torch's
    Dropout2d) is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``, else zeroed.  The mask is drawn with
    ``torch.rand(..., generator=generator)`` on the input's device, so a
    generator seeded alike gives the same masks; ``F.dropout`` takes no
    generator.  Eval mode, or ``rate == 0``, is the identity."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate = rate
        self.channelwise = channelwise

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("dropout in train mode draws its mask from an "
                             "explicit torch.Generator; none was given")
        b, c, h, w = x.shape
        shape = (b, 1, 1, c) if self.channelwise else (b, h, w, c)
        keep_prob = 1.0 - self.rate
        # Drawn NHWC, like the JAX masks, and viewed NCHW (channels_last).
        keep = torch.rand(shape, generator=generator,
                          device=x.device).permute(0, 3, 1, 2) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def flatten_head(x: torch.Tensor, last: int) -> torch.Tensor:
    """(B, k*last, H, W) -> (B, H*W*k, last), rows ordered by
    (row, col, anchor) like the priors — the reference's
    permute(0,2,3,1)+view (`Model.py:212`) and the JAX NHWC reshape."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, last)

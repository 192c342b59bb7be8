"""Building-block layers — the port of `objectdetection_ssd_tpu/models/layers.py`.

The JAX package works NHWC and gives every conv and pool explicit symmetric
padding so that the SSD300 pyramid follows torch's output-size arithmetic.
Here the layers are torch's own, in NCHW (``channels_last`` memory on the
card); what this module adds is the flax initialisers, flax's ``dtype=``
casts (each conv computes in its input's dtype, casting its weight and
bias at use), the routing of a conv's filter gradient through kernel K2,
the int8 and straight-through (QAT) branches of a quantized conv (JAX
`Int8Conv`, kernel K3), the route of max pooling through kernel K5
(int8 pooled natively), the L2Norm arithmetic, flax's
BatchNorm and Dropout semantics (the ResNet-34 family) and the NHWC head
flatten.

Tensor and spatial parallelism hook in here.  A model partitioned over a
mesh (`set_partition`) gives its convs, L2Norms, dropouts and the callers
of `max_pool` and `flatten_head` a ``part``: a
`parallel/tensor_parallel.py:TensorParallel` (this rank's output channels
of every conv) or a `parallel/spatial.py:SpatialParallel` (this rank's
rows of every map).  Under tensor parallelism the parameters are DTensors
holding this rank's channels, which the layers read through `_local`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from objectdetection_ssd_torch.ops import bias_relu as k4
from objectdetection_ssd_torch.ops import int8_conv as k3
from objectdetection_ssd_torch.ops import max_pool as k5
from objectdetection_ssd_torch.ops.dw_cuda import conv3x3p1
from objectdetection_ssd_torch.parallel.collectives import all_reduce_sum

# flax's truncated-normal stddev correction: the std of a unit normal cut to
# [-2, 2] (`jax.nn.initializers.variance_scaling`).
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class ConvQuant:
    """The quantization a conv runs with (`infer/quant.py:attach_scales`).

    ``act_scale``: the calibrated activation scale ``s_a`` (f32 scalar
    tensor on the conv's device, already ``max(s_a, 1e-12)``);
    ``out_scale``: the next conv's ``s_a`` on a requant-chained edge, else
    None; ``dtype``: the model's compute dtype, which the int8 branch
    outputs whatever its input's dtype (an int8 input is already
    quantized); ``straight_through``: the QAT branch instead of the int8
    one."""

    act_scale: torch.Tensor
    out_scale: Optional[torch.Tensor]
    dtype: torch.dtype
    straight_through: bool = False


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it already is, so that an
    exported program (`infer/export.py`) records no operator for it."""
    return t if t.dtype == dtype else t.to(dtype)


def _local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's part of a tensor-parallel parameter or buffer (a
    DTensor, `parallel/tensor_parallel.py:shard_model`), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _spatial(part) -> bool:
    return part is not None and part.kind == "spatial"


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through (identity) gradient (`layers.py:33`)."""
    return x + (torch.round(x) - x).detach()


def _ste_fake_quant(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``ste_round(clip(v / s, -127, 127)) * s``; the clip as max then min,
    whose gradient at a tie is halved as `jnp.clip`'s is."""
    lim = k3.scalar(k3.QMAX, v)
    return _ste_round(torch.minimum(torch.maximum(v / s, -lim), lim)) * s


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

    ``quant`` (a `ConvQuant`, set by `infer/quant.py:attach_scales`, not a
    parameter or buffer: the ``state_dict`` keeps its keys) selects the
    JAX `Int8Conv` (`layers.py:39-138`) and wins over the K2 route:
    * int8: weights quantized per output channel from the f32 weights,
      once per weight version (an update in place, a load or a move
      re-quantizes); the input quantized by ``act_scale`` unless it is
      already int8 (a chained edge); the conv on kernel K3, whose epilogue
      rescales by ``act_scale * s_w``, adds the bias and rounds to
      ``dtype``, or requantizes to int8 by ``out_scale``;
    * straight-through (QAT): both operands fake-quantized in f32 with the
      scales held constant, an f32 conv, the bias, then ``dtype``;
      ``out_scale`` is ignored.  It runs under tensor and spatial
      parallelism too (`_quant_forward`).

    ``part`` (`set_partition`): under tensor parallelism the conv holds
    its output channels of a DTensor weight and gathers its input's
    channels when it gets a shard of them (narrower than
    ``in_channels``); under spatial parallelism it reads the input rows
    its output rows need (`SpatialParallel.extend`: a halo exchange, zero
    rows outside the map) and runs with padding 0 in H.  The K2 route
    runs there on this rank's rows plus one halo row each side, with a
    zero gradient row at each halo position, so its dW sums exactly this
    rank's rows; K3 runs on the int8 rows, padded with zero columns in W,
    at padding 0.
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
        self.quant: Optional[ConvQuant] = None
        self._int8_weight = None     # (weight version key, w_q, s_w)
        self.part = None

    def int8_weight(self):
        """(``w_q`` int8 (Cout, kh, kw, Cin), ``s_w`` f32 (Cout,)) of the
        current weights, quantized once per weight version.

        Under `torch.export` the weights are fake tensors without a
        version to key on: the pair cached by an eager call made just
        before tracing is returned, and enters the program as constants
        (`infer/export.py:export_detector` makes that call)."""
        if torch.compiler.is_exporting():
            if self._int8_weight is None:
                raise RuntimeError("quantize the int8 weights (an eager "
                                   "int8_weight() call) before tracing")
            return self._int8_weight[1:]
        w = _local(self.weight)
        key = (w._version, w.data_ptr(), w.device, w.dtype)
        if self._int8_weight is None or self._int8_weight[0] != key:
            with torch.no_grad():
                self._int8_weight = (key,) + k3.quantize_weight(w)
        return self._int8_weight[1:]

    def _quant_forward(self, x: torch.Tensor, q: ConvQuant) -> torch.Tensor:
        bias = None if self.bias is None else _cast(_local(self.bias),
                                                    torch.float32)
        geometry = (self.stride[0], self.padding[0], self.dilation[0])
        if q.straight_through:
            # Under tensor parallelism: this rank's output channels of the
            # weight, whose scales are those of the whole weight's channels,
            # on the gathered input.  Under spatial partitioning: this
            # rank's input rows, quantized before the halo exchange (a zero
            # row stays zero), then the conv at padding 0 in H.
            w = _local(self.weight).float()
            s_w = k3.weight_scale(w)[:, None, None, None]
            x_q = _ste_fake_quant(x.float(), q.act_scale)
            w_q = _ste_fake_quant(w, s_w)
            if _spatial(self.part):
                stride, padding, dilation = geometry
                ext, rows = self.part.extend(x_q, self.kernel_size[0],
                                             stride, padding, dilation)
                y = self.part.narrow_rows(
                    F.conv2d(ext, w_q, None, stride, (0, padding), dilation),
                    0, rows)
            else:
                y = F.conv2d(x_q, w_q, None, *geometry)
            if bias is not None:
                y = y + bias[:, None, None]
            return y.to(q.dtype)
        w_q, s_w = self.int8_weight()
        x_q = (x if x.dtype == torch.int8
               else k3.quantize_activation(x, q.act_scale))
        bias = None if bias is None else bias.detach()
        if not _spatial(self.part):
            return k3.int8_conv(x_q, w_q, q.act_scale * s_w, bias,
                                *geometry, q.dtype, q.out_scale)
        stride, padding, dilation = geometry
        ext, rows = self.part.extend(x_q, self.kernel_size[0], stride,
                                     padding, dilation, pad_w=padding)
        y = k3.int8_conv(ext, w_q, q.act_scale * s_w, bias, stride, 0,
                         dilation, q.dtype, q.out_scale)
        return self.part.narrow_rows(y, 0, rows)

    def _spatial_forward(self, x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
        part = self.part
        if self.dw_route:
            # Rows [a - 1, b + 1): K2's p1 conv over them, whose first and
            # last output rows are dropped.
            ext, rows = part.extend(x, 3, 1, 1, 1)
            y = part.narrow_rows(conv3x3p1(ext, weight), 1, rows)
            return y if bias is None else y + bias[:, None, None]
        stride, padding, dilation = (self.stride[0], self.padding[0],
                                     self.dilation[0])
        ext, rows = part.extend(x, self.kernel_size[0], stride, padding,
                                dilation)
        y = F.conv2d(ext, weight, bias, stride, (0, padding), dilation)
        return part.narrow_rows(y, 0, rows)

    def _fuses_bias_relu(self, x: torch.Tensor) -> bool:
        """Whether the forward's bias add and ReLU run on kernel K4: a
        plain conv with a bias (no ``part``, ``quant`` or K2 route) on a
        CUDA input, with nothing for autograd to record."""
        return (x.is_cuda and self.bias is not None and self.part is None
                and self.quant is None and not self.dw_route
                and not (torch.is_grad_enabled()
                         and (x.requires_grad or self.weight.requires_grad
                              or self.bias.requires_grad)))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """The conv, then ReLU with ``relu=True``.  On the card's inference
        forward of a plain conv with a bias (`_fuses_bias_relu`) cuDNN runs
        without the bias and K4 adds it and applies the ReLU in one pass
        (`ops/bias_relu.py`); everywhere else the conv adds its bias and
        ``F.relu`` follows."""
        if self.part is not None:
            x = self.part.full_channels(x, self.in_channels)
        if self.quant is not None:
            y = self._quant_forward(x, self.quant)
            return F.relu(y) if relu else y
        weight = _cast(_local(self.weight), x.dtype)
        bias = (None if self.bias is None
                else _cast(_local(self.bias), x.dtype))
        if relu and self._fuses_bias_relu(x):
            return k4.conv_bias_relu(self._conv_forward(x, weight, None),
                                     bias)
        if _spatial(self.part):
            y = self._spatial_forward(x, weight, bias)
        elif self.dw_route:
            # The bias is added outside the Function, as the JAX
            # `_DWPallasConv` adds it (`layers.py:160-162`).
            y = conv3x3p1(x, weight)
            y = y if bias is None else y + bias[:, None, None]
        else:
            y = self._conv_forward(x, weight, bias)
        return F.relu(y) if relu else y

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


def pools_on_k5(x: torch.Tensor) -> bool:
    """Whether `max_pool` runs on kernel K5: a CUDA input with nothing for
    autograd to record (``inference_mode``, ``no_grad``, or an input that
    does not require grad).  The train step keeps ``F.max_pool2d``, whose
    backward reads the indices it saves."""
    return x.is_cuda and not (torch.is_grad_enabled() and x.requires_grad)


def max_pool(x: torch.Tensor, window, stride, padding=0,
             ceil_mode: bool = False, part=None) -> torch.Tensor:
    """Max pool with torch semantics: -inf padding, and ``ceil_mode``
    extends the grid at the bottom/right (reference pool3, `Model.py:137`).
    The JAX counterpart pads explicitly to get the same windows.  ``window``,
    ``stride`` and ``padding`` are ints, or (H, W) pairs without a spatial
    ``part``.

    On the card's inference forward (`pools_on_k5`) kernel K5 pools the
    ``channels_last`` map without writing indices (`ops/max_pool.py`), and
    an int8 input (the requant-chained graph; the max commutes with the
    monotone quantization) is pooled as int8.  Everywhere else the plain
    version runs: ``F.max_pool2d``, an int8 input through f16, which holds
    every value in [-127, 127] exactly.  Padding never wins, as the JAX
    pool's -128 padding does not.

    Under spatial parallelism (``part``) the pool reads the input rows its
    output rows need, ``-inf`` (int8: -128) outside the map, and pools
    them with padding 0 in H; channel shards pool as they are."""
    if _spatial(part):
        fill = -128 if x.dtype == torch.int8 else -math.inf
        ext, rows = part.extend(x, window, stride, padding, 1, ceil_mode,
                                fill=fill)
        y = max_pool(ext, (window, window), (stride, stride), (0, padding),
                     ceil_mode)
        return part.narrow_rows(y, 0, rows)
    if pools_on_k5(x):
        return k5.layer_max_pool(x, k5.pair(window), k5.pair(stride),
                                 k5.pair(padding), ceil_mode)
    return k5.max_pool_plain(x, window, stride, padding, ceil_mode)


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learnable per-channel rescale
    (reference `Model.py:132-133,206-210`).

    ``x / sqrt(sum(x^2) + eps) * scale`` with the sum in f32 and the norm
    cast back to ``x.dtype`` — the JAX `L2Norm` (`layers.py:316-322`).  Not
    `F.normalize`, which clamps the norm instead of adding ``eps``.

    Under tensor parallelism (``part``) a channel-shard input is
    normalized with its scale's shard: the squares are summed over the
    local channels and the sums all-reduced over the ``model`` group.
    """

    def __init__(self, channels: int, scale_init: float = 20.0,
                 epsilon: float = 1e-12):
        super().__init__()
        self.scale_init = scale_init
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.full((channels,), scale_init))
        self.part = None

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, C, H, W)
        sumsq = torch.sum(torch.square(x.float()), dim=1, keepdim=True)
        if self.part is not None and x.shape[1] != self.scale.shape[0]:
            sumsq = all_reduce_sum(sumsq, self.part.group)
        norm = torch.sqrt(sumsq + self.epsilon)
        return (x / _cast(norm, x.dtype)) * _cast(_local(self.scale),
                                                  x.dtype)[:, None, None]


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

    ``group``: the process group of a data-parallel step
    (`parallel/data_parallel.py`), None on one process.  With a group,
    train mode takes its statistics over the global batch, as flax's
    BatchNorm does under a JAX mesh: each rank sums ``x`` and ``x^2`` over
    its rows, the sums and the counts are added across the group (a
    differentiable all-reduce), and the sums divided by the count.  The
    group is every rank of a data-parallel or spatial step (the ranks of a
    ``spatial`` group hold other rows of the same images, and as many as
    they own), the ``data`` group of a tensor-parallel one (whose
    parameters and statistics are DTensors of this rank's channels).
    """

    MOMENTUM = 0.99
    EPSILON = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.group: Optional[dist.ProcessGroup] = None
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
        weight, bias = _local(self.weight), _local(self.bias)
        running_mean = _local(self.running_mean)
        running_var = _local(self.running_var)
        if not self.training:
            return F.batch_norm(x, running_mean, running_var, weight, bias,
                                False, 0.0, self.EPSILON)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.group is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            sums = xf.sum(dim=(0, 2, 3))
            sums = all_reduce_sum(
                torch.stack([sums, (xf * xf).sum(dim=(0, 2, 3)),
                             torch.full_like(sums,
                                             xf.numel() // xf.shape[1])]),
                self.group)
            mean, mean_sq = sums[0] / sums[2], sums[1] / sums[2]
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            running_mean.copy_(m * running_mean + (1.0 - m) * mean.detach())
            running_var.copy_(m * running_var + (1.0 - m) * var.detach())
        mul = torch.rsqrt(var + self.EPSILON) * weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + bias[:, None, None]
        return y.to(x.dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` with an explicit generator: in train mode each
    element (``channelwise=False``) or each (image, channel) plane
    (``channelwise=True``, flax ``broadcast_dims=(1, 2)`` on NHWC, torch's
    Dropout2d) is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``, else zeroed.  The mask is drawn with
    ``torch.rand(..., generator=generator)`` on the input's device, so a
    generator seeded alike gives the same masks; ``F.dropout`` takes no
    generator.  Eval mode, or ``rate == 0``, is the identity.

    ``shard = (index, count)``: this process holds rows ``index * b`` to
    ``(index + 1) * b`` of a global batch of ``count * b`` rows
    (`parallel/data_parallel.py`); the mask is drawn at the global shape
    and this process keeps its rows, so every row gets the mask it gets
    in one process.  Under tensor parallelism (``part``) it also keeps
    its channels of the ``features`` wide mask when ``x`` is a channel
    shard; under spatial parallelism its rows of the map (whose height is
    its width)."""

    def __init__(self, rate: float, channelwise: bool = False,
                 features: Optional[int] = None):
        super().__init__()
        self.rate = rate
        self.channelwise = channelwise
        self.features = features
        self.shard: Optional[tuple] = None
        self.part = None

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
        index, count = self.shard or (0, 1)
        rows = b * count
        part = self.part
        width = c
        if part is not None and part.kind == "model":
            if self.features is None:
                raise ValueError("dropout under tensor parallelism needs "
                                 "its features")
            width = self.features
        height = w if _spatial(part) else h
        shape = ((rows, 1, 1, width) if self.channelwise
                 else (rows, height, w, width))
        keep_prob = 1.0 - self.rate
        # Drawn NHWC, like the JAX masks, and viewed NCHW (channels_last).
        u = torch.rand(shape, generator=generator, device=x.device)
        u = u[index * b:(index + 1) * b]
        if width != c:
            lo, hi = part.channels(width)
            u = u[..., lo:hi]
        if _spatial(part) and not self.channelwise:
            lo, hi = part.rows(height)
            u = u[:, lo:hi]
        keep = u.permute(0, 3, 1, 2) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def flatten_head(x: torch.Tensor, last: int, part=None,
                 channels: Optional[int] = None) -> torch.Tensor:
    """(B, k*last, H, W) -> (B, H*W*k, last), rows ordered by
    (row, col, anchor) like the priors — the reference's
    permute(0,2,3,1)+view (`Model.py:212`) and the JAX NHWC reshape.

    Under a ``part`` the head is made whole first: its rows gathered
    (spatial), or its channels (tensor parallel) when ``x`` holds a shard
    of its ``channels`` (the head's width, ``k * last``)."""
    if part is not None:
        x = part.whole(x, channels)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, last)


def set_partition(model: nn.Module, part) -> nn.Module:
    """Give every module of ``model`` that takes one (convs, L2Norms,
    dropouts, the trunks and models that pool and flatten) the partition
    ``part`` (`parallel/tensor_parallel.py`, `parallel/spatial.py`), or
    None to run whole again."""
    for m in model.modules():
        if hasattr(m, "part"):
            m.part = part
    return model

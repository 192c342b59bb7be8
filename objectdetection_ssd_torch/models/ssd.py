"""SSD300 (VGG-16) and the ResNet-34 variant — the port of
`objectdetection_ssd_tpu/models/ssd.py`.

Input NHWC (B, S, S, 3), uint8 or already-normalized float, like the JAX
models; output ``(loc (B, P, 4), conf (B, P, 21))`` in the compute dtype:
S = 300 and P = 8732 for SSD300, S = 224 and P = 189 for `SSDResNet34`.
Inside, the network runs NCHW: the NHWC input permuted to NCHW is a
``channels_last`` tensor, which is the memory format cuDNN prefers on the
card.

Structure (reference `Model.py:128-235`): VGG taps conv4_3 (L2-normalized,
learnable rescale init 20) and fc7; extra pyramid seq8 (1x1 -> 256, 3x3/s2/p1
-> 512, 10x10), seq9 (1x1 -> 128, 3x3/s2/p1 -> 256, 5x5), seq10 and seq11
(1x1 -> 128, 3x3 VALID -> 256: 3x3, then 1x1); per-tap 3x3 loc/conf heads
with k = [4, 6, 6, 6, 4, 4] anchors per cell, flattened (row, col,
anchor)-major and concatenated in tap order -> 8732 rows aligned with
`ops.priors.ssd300_priors`.

ResNet-34 variant (reference `Model.py:12-126`, JAX `ssd.py:139-223`): the
trunk (frozen by default: no gradient, BN on its running statistics even in
train mode), element dropout on its ReLU'd 7x7 output, 3x3 neck blocks
Conv -> ReLU -> BN -> channel dropout (the stride-2 ``neck_down`` applied
twice with the same weights, 7 -> 4 -> 2, then ``neck_down2`` 2 -> 1), and
at the 4x4, 2x2, 1x1 taps a loc head Conv -> BN -> channel dropout and a
conf conv with bias -2; k = 9 anchors per cell -> 189 rows aligned with
`ops.priors.resnet34_priors`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_ssd_torch.config import (IMAGENET_MEAN, IMAGENET_STD,
                                              ModelConfig,
                                              NUM_CLASSES_WITH_BG)
from objectdetection_ssd_torch.device import DeviceLike, resolve_device
from objectdetection_ssd_torch.models.backbones import (ResNet34Trunk,
                                                        VGG16Trunk)
from objectdetection_ssd_torch.models.layers import (BatchNorm, Dropout,
                                                     L2Norm, TorchConv,
                                                     flatten_head)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Tap channels and anchors per cell, in head order.
_TAP_CHANNELS = (512, 1024, 512, 256, 256, 256)
_TAP_ANCHORS = (4, 6, 6, 6, 4, 4)
# Extra pyramid blocks: (name, in, mid, out, stride, padding of the 3x3).
_EXTRAS = (("seq8", 1024, 256, 512, 2, 1),     # 19 -> 10
           ("seq9", 512, 128, 256, 2, 1),      # 10 -> 5
           ("seq10", 256, 128, 256, 1, 0),     # 5 -> 3 (VALID)
           ("seq11", 256, 128, 256, 1, 0))     # 3 -> 1 (VALID)


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 RGB NHWC -> ImageNet-normalized f32 NHWC, computed in f32 as
    ``(x * (1/255) - mean) / std`` (a multiply by the reciprocal, as
    `models/ssd.py:58-62` writes it); float inputs are taken as already
    normalized and pass through."""
    if x.dtype != torch.uint8:
        return x
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.float() * (1.0 / 255.0) - mean) / std


def prepare_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 RGB NHWC -> ImageNet-normalized NCHW activations in ``dtype``
    (`normalize_uint8`, then the cast).  The permute gives an NCHW view with
    ``channels_last`` strides, without a copy.
    """
    return normalize_uint8(x).to(dtype).permute(0, 3, 1, 2)


class SSD300(nn.Module):
    """VGG-16 SSD300.  (B, 300, 300, 3) -> ((B, 8732, 4), (B, 8732, C)).

    The network computes in ``dtype``, whatever dtype its parameters are
    held in (flax's ``dtype=``).  ``freeze_stages`` and ``dw_pallas_convs``
    go to the trunk (`VGG16Trunk`).  ``part``: the model's partition over
    a mesh (`models/layers.py:set_partition`), None when it runs whole.
    """

    def __init__(self, num_classes: int = NUM_CLASSES_WITH_BG,
                 l2_norm_scale_init: float = 20.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 freeze_stages: int = 0,
                 dw_pallas_convs: Sequence[str] = ()):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.trunk = VGG16Trunk(freeze_stages=freeze_stages,
                                dw_pallas_convs=tuple(dw_pallas_convs))
        self.l2norm_4_3 = L2Norm(512, scale_init=l2_norm_scale_init)
        for name, cin, mid, out, stride, padding in _EXTRAS:
            self.add_module(f"{name}_1", TorchConv(
                cin, mid, kernel=1, kernel_init="xavier_uniform"))
            self.add_module(f"{name}_2", TorchConv(
                mid, out, kernel=3, stride=stride, padding=padding,
                kernel_init="xavier_uniform"))
        for i, (cin, k) in enumerate(zip(_TAP_CHANNELS, _TAP_ANCHORS)):
            self.add_module(f"loc_head_{i}", TorchConv(
                cin, 4 * k, kernel=3, padding=1,
                kernel_init="xavier_uniform"))
            self.add_module(f"conf_head_{i}", TorchConv(
                cin, num_classes * k, kernel=3, padding=1,
                kernel_init="xavier_uniform"))
        self.part = None
        self.reset_parameters(generator)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """Flax-style init from ``generator``, in module order."""
        for m in self.modules():
            if isinstance(m, TorchConv):
                m.reset_parameters(generator)
        self.l2norm_4_3.reset_parameters()

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` is accepted for the registry's one forward
        signature; SSD300 has no dropout.  ``remat``: recompute the trunk's
        stage interiors in the backward (`VGG16Trunk.forward`)."""
        del generator
        x = prepare_input(images, self.dtype)
        if self.part is not None:
            x = self.part.enter(x)
        conv4_3, x = self.trunk(x, remat=remat)
        return ssd300_post_trunk(self, conv4_3, x)


def ssd300_post_trunk(model: SSD300, conv4_3: torch.Tensor, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything after the VGG trunk: L2Norm, extra pyramid, heads
    (`models/ssd.py:65-108`).  Under tensor parallelism each tap is
    gathered once for the convs that read it."""
    part = model.part
    full = ((lambda t, c: t) if part is None else part.full_channels)
    x = full(x, 1024)
    taps: List[torch.Tensor] = [full(model.l2norm_4_3(conv4_3), 512), x]
    for name, _, _, out, _, _ in _EXTRAS:
        x = getattr(model, f"{name}_1")(x, relu=True)
        x = full(getattr(model, f"{name}_2")(x, relu=True), out)
        taps.append(x)
    locs, confs = [], []
    for i, (tap, k) in enumerate(zip(taps, _TAP_ANCHORS)):
        locs.append(flatten_head(getattr(model, f"loc_head_{i}")(tap), 4,
                                 part, 4 * k))
        confs.append(flatten_head(getattr(model, f"conf_head_{i}")(tap),
                                  model.num_classes, part,
                                  model.num_classes * k))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


# The ResNet-34 variant's head taps, in head order, and its anchors per
# cell (the JAX model's default k = 9, which pairs with the 189 priors).
_RESNET_TAPS = ("t4", "t2", "t1")
_RESNET_ANCHORS = 9


class _NeckBlock(nn.Module):
    """Conv -> ReLU -> BN -> channel dropout (reference `Model.py:56-62`)."""

    def __init__(self, in_features: int, features: int, stride: int,
                 dropout_rate: float):
        super().__init__()
        self.conv = TorchConv(in_features, features, kernel=3, stride=stride,
                              padding=1)
        self.bn = BatchNorm(features)
        self.drop = Dropout(dropout_rate, channelwise=True, features=features)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.drop(self.bn(self.conv(x, relu=True)), generator)


class _LocHead(nn.Module):
    """Conv -> BN -> channel dropout, no ReLU (reference `conv2d_final`,
    `Model.py:64-70`)."""

    def __init__(self, in_features: int, out: int, dropout_rate: float):
        super().__init__()
        self.conv = TorchConv(in_features, out, kernel=3, padding=1)
        self.bn = BatchNorm(out)
        self.drop = Dropout(dropout_rate, channelwise=True, features=out)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.drop(self.bn(self.conv(x)), generator)


class SSDResNet34(nn.Module):
    """ResNet-34 SSD.  (B, 224, 224, 3) -> ((B, 189, 4), (B, 189, C)), the
    rows of `ops.priors.resnet34_priors`.

    ``freeze_backbone``: the trunk runs under ``torch.no_grad()`` (JAX's
    ``stop_gradient``) and stays in eval mode under ``model.train()``, so
    its BNs use and keep their running statistics.  In train mode with
    ``dropout_rate > 0`` the forward needs ``generator`` (on the model's
    device) for the dropout masks.
    """

    def __init__(self, num_classes: int = NUM_CLASSES_WITH_BG,
                 dropout_rate: float = 0.4, freeze_backbone: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.freeze_backbone = freeze_backbone
        self.dtype = dtype
        self.trunk = ResNet34Trunk()
        self.trunk_drop = Dropout(dropout_rate, features=512)
        self.neck0 = _NeckBlock(512, 256, 1, dropout_rate)       # 7x7
        # The reference applies its stride-2 neck conv twice with the same
        # weights (`Model.py:91-96`): one module, called twice.
        self.neck_down = _NeckBlock(256, 256, 2, dropout_rate)   # 4x4, 2x2
        self.neck_down2 = _NeckBlock(256, 256, 2, dropout_rate)  # 1x1
        k = _RESNET_ANCHORS
        for tap in _RESNET_TAPS:
            self.add_module(f"loc_{tap}", _LocHead(256, 4 * k, dropout_rate))
            self.add_module(f"conf_{tap}", TorchConv(
                256, num_classes * k, kernel=3, padding=1,
                bias_init=-2.0))                                 # Model.py:39
        self.part = None
        self.reset_parameters(generator)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """Flax init from ``generator``, in module order: lecun-normal
        kernels, BN scale 1, bias 0, mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, TorchConv):
                m.reset_parameters(generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def train(self, mode: bool = True) -> "SSDResNet34":
        super().train(mode)
        if self.freeze_backbone:
            self.trunk.train(False)
        return self

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``remat`` is accepted and changes nothing: the remat markers are
        the VGG trunk's, as in the JAX package."""
        del remat
        x = prepare_input(images, self.dtype)
        part = self.part
        if part is not None:
            x = part.enter(x)
        if self.freeze_backbone:
            with torch.no_grad():
                feats = self.trunk(x)                           # (B, 512, 7, 7)
        else:
            feats = self.trunk(x)
        feats = self.trunk_drop(F.relu(feats), generator)
        x = self.neck0(feats, generator)
        # Under tensor parallelism each tap is gathered once for the three
        # convs that read it.
        full = ((lambda t: t) if part is None
                else (lambda t: part.full_channels(t, 256)))
        x4 = full(self.neck_down(x, generator))
        x2 = full(self.neck_down(x4, generator))
        x1 = full(self.neck_down2(x2, generator))
        k = _RESNET_ANCHORS
        locs, confs = [], []
        for tap, t in zip(_RESNET_TAPS, (x4, x2, x1)):
            locs.append(flatten_head(getattr(self, f"loc_{tap}")(t, generator),
                                     4, part, 4 * k))
            confs.append(flatten_head(getattr(self, f"conf_{tap}")(t),
                                      self.num_classes, part,
                                      self.num_classes * k))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def build_model(config: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> nn.Module:
    """Model registry keyed on ``config.backbone``: the model on ``device``
    (default ``cuda``), ``channels_last``, computing in the compute dtype,
    with weights drawn from ``generator``.

    For serving (``train=False``) the model is in eval mode and holds its
    conv and L2Norm parameters in the compute dtype.  For training it is in
    train mode and holds them in f32; each layer casts them to the compute
    dtype at use.  BatchNorm parameters and statistics stay f32 in both.
    """
    dev = resolve_device(device)
    if config.compute_dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {config.compute_dtype!r}")
    dtype = _DTYPES[config.compute_dtype]
    if config.backbone == "vgg16":
        model = SSD300(num_classes=config.num_classes,
                       l2_norm_scale_init=config.l2_norm_scale_init,
                       generator=generator, dtype=dtype,
                       freeze_stages=config.freeze_stages,
                       dw_pallas_convs=config.dw_pallas_convs)
    elif config.backbone == "resnet34":
        model = SSDResNet34(num_classes=config.num_classes,
                            dropout_rate=config.dropout_rate,
                            freeze_backbone=config.freeze_backbone,
                            generator=generator, dtype=dtype)
    else:
        raise ValueError(f"unknown backbone: {config.backbone!r}")
    model = model.to(device=dev, dtype=torch.float32 if train else dtype,
                     memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.float()
    return model.train(train)

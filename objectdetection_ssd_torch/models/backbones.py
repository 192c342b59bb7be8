"""Trunks: VGG-16 (SSD300 flavor) and ResNet-34 — the port of
`objectdetection_ssd_tpu/models/backbones.py` (`VGG16Trunk` /
`apply_vgg_stages`, `BasicBlock`, `ResNet34Trunk`).

Geometry for 300x300 inputs (reference `Model.py:131-162`):
  conv1_1-2 + pool 2/2          -> (B,   64, 150, 150)
  conv2_1-2 + pool 2/2          -> (B,  128,  75,  75)
  conv3_1-3 + ceil pool 2/2     -> (B,  256,  38,  38)   (Model.py:137)
  conv4_1-3                     -> conv4_3 tap (B, 512, 38, 38)
  pool 2/2 + conv5_1-3 + pool 3/1/p1 + atrous fc6 (3x3, dilation 4,
  padding 4) + fc7 (1x1)        -> (B, 1024, 19, 19)    (Model.py:142-162)

Parameter names follow the JAX tree (``trunk/conv1_1/Conv_0/kernel`` ->
``trunk.conv1_1.weight``), see `models.convert.from_flax_params`.
Training features: ``freeze_stages``, the filter-gradient route of the
named convs through kernel K2 (``dw_pallas_convs``) and remat: with
``remat=True`` each stage runs under ``torch.utils.checkpoint``, so only
the stage boundaries (the JAX ``VGG_STAGE_CKPT`` names: the pool outputs,
the conv4_3 tap and fc7) are kept for the backward.

ResNet-34 (`Model.py:21-30`): 7x7/2 stem, BN, ReLU, 3x3/2 max pool, stages
of [3, 4, 6, 3] basic blocks with [64, 128, 256, 512] channels; 224 px ->
56, 28, 14, 7.  Module names are flax's (``stem_conv``, ``stem_bn``,
``layer{s}_block{b}.{conv1,bn1,conv2,bn2,downsample_conv,downsample_bn}``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from objectdetection_ssd_torch.models.layers import (BatchNorm, TorchConv,
                                                     max_pool)

# (stage name, conv count, output channels) of the plain 3x3/p1 conv blocks.
_VGG_BLOCKS = (("conv1", 2, 64), ("conv2", 2, 128), ("conv3", 3, 256),
               ("conv4", 3, 512), ("conv5", 3, 512))

# Conv names per VGG stage: the freeze cut below and the optimizer's frozen
# prefixes (`train/state.py`).
VGG_STAGE_PARAMS = (
    ("conv1_1", "conv1_2"),
    ("conv2_1", "conv2_2"),
    ("conv3_1", "conv3_2", "conv3_3"),
    ("conv4_1", "conv4_2", "conv4_3"),
    ("conv5_1", "conv5_2", "conv5_3", "conv_fc6", "conv_fc7"),
)


def vgg_frozen_prefixes(freeze_stages: int) -> Tuple[str, ...]:
    """Parameter-name prefixes (``trunk.conv1_1``, ...) of the first
    ``freeze_stages`` stages — the JAX function's slash-joined prefixes
    with dots."""
    return tuple(f"trunk.{name}" for stage in VGG_STAGE_PARAMS[:freeze_stages]
                 for name in stage)


class VGG16Trunk(nn.Module):
    """VGG-16 features through conv_fc7, returning the two SSD taps:
    (conv4_3 (B, 512, 38, 38) before the L2Norm, fc7 (B, 1024, 19, 19)).

    ``freeze_stages``: detach the output of the first N stages (1=conv1 ..
    5=the whole trunk incl. fc6/fc7) at the stage boundary, as the JAX
    trunk's stop_gradient does, so no gradient (and no K2 launch) reaches
    them.  ``dw_pallas_convs``: the 3x3 trunk convs whose filter gradient
    runs on K2.
    """

    def __init__(self, freeze_stages: int = 0,
                 dw_pallas_convs: Sequence[str] = ()):
        super().__init__()
        self.freeze_stages = freeze_stages
        cin = 3
        for name, n, features in _VGG_BLOCKS:
            for i in range(n):
                conv = f"{name}_{i + 1}"
                self.add_module(conv, TorchConv(
                    cin, features, kernel=3, padding=1,
                    dw_pallas=conv in dw_pallas_convs))
                cin = features
        self.conv_fc6 = TorchConv(512, 1024, kernel=3, padding=4, dilation=4)
        self.conv_fc7 = TorchConv(1024, 1024, kernel=1)
        self.part = None         # the pools' partition (`set_partition`)

    def _block(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        for i in range(n):
            x = getattr(self, f"{name}_{i + 1}")(x, relu=True)
        return x

    def _cut(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        return x.detach() if self.freeze_stages >= stage else x

    def _stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage`` (1-5) from the previous boundary to the next."""
        if stage <= 4:
            name, n, _ = _VGG_BLOCKS[stage - 1]
            x = self._cut(self._block(x, name, n), stage)
            if stage == 4:
                return x                                        # conv4_3
            # 300 -> 150 -> 75 -> 38 (ceil mode, Model.py:137)
            return max_pool(x, 2, 2, ceil_mode=stage == 3, part=self.part)
        x = max_pool(x, 2, 2, part=self.part)                   # 38 -> 19
        x = max_pool(self._block(x, "conv5", 3), 3, 1, padding=1,
                     part=self.part)                            # 19 -> 19
        x = self.conv_fc6(x, relu=True)
        x = self.conv_fc7(x, relu=True)
        return self._cut(x, 5)

    def forward(self, x: torch.Tensor, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``remat``: recompute each stage's interior in the backward
        (frozen stages, which have no backward, run plainly)."""
        for stage in range(1, 6):
            if remat and stage > self.freeze_stages:
                x = checkpoint(self._stage, x, stage, use_reentrant=False)
            else:
                x = self._stage(x, stage)
            if stage == 4:
                conv4_3 = x
        return conv4_3, x


class BasicBlock(nn.Module):
    """ResNet v1 basic block: two 3x3 convs without bias, each followed by
    BN, and an identity or (when the shape changes) a 1x1 projection with
    BN on the residual path."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = TorchConv(in_features, features, kernel=3,
                               stride=stride, padding=1, use_bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = TorchConv(features, features, kernel=3, padding=1,
                               use_bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_features != features:
            self.downsample_conv = TorchConv(in_features, features, kernel=1,
                                             stride=stride, use_bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


# ResNet-34's basic blocks per stage and their channels.
_RESNET34_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


class ResNet34Trunk(nn.Module):
    """ResNet-34 features: (B, 3, 224, 224) -> (B, 512, 7, 7)."""

    def __init__(self):
        super().__init__()
        self.stem_conv = TorchConv(3, 64, kernel=7, stride=2, padding=3,
                                   use_bias=False)
        self.stem_bn = BatchNorm(64)
        self.block_names = []
        cin = 64
        for s, (n, f) in enumerate(_RESNET34_STAGES):
            for b in range(n):
                name = f"layer{s + 1}_block{b + 1}"
                stride = 2 if (s > 0 and b == 0) else 1
                self.add_module(name, BasicBlock(cin, f, stride))
                self.block_names.append(name)
                cin = f
        self.part = None         # the pool's partition (`set_partition`)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = max_pool(x, 3, 2, padding=1, part=self.part)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x

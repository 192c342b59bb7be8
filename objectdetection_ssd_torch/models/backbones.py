"""VGG-16 trunk (SSD300 flavor) — the port of
`objectdetection_ssd_tpu/models/backbones.py:VGG16Trunk` / `apply_vgg_stages`.

Geometry for 300x300 inputs (reference `Model.py:131-162`):
  conv1_1-2 + pool 2/2          -> (B,   64, 150, 150)
  conv2_1-2 + pool 2/2          -> (B,  128,  75,  75)
  conv3_1-3 + ceil pool 2/2     -> (B,  256,  38,  38)   (Model.py:137)
  conv4_1-3                     -> conv4_3 tap (B, 512, 38, 38)
  pool 2/2 + conv5_1-3 + pool 3/1/p1 + atrous fc6 (3x3, dilation 4,
  padding 4) + fc7 (1x1)        -> (B, 1024, 19, 19)    (Model.py:142-162)

Parameter names follow the JAX tree (``trunk/conv1_1/Conv_0/kernel`` ->
``trunk.conv1_1.weight``), see `models.convert.from_flax_params`.
Training features: ``freeze_stages`` and the filter-gradient route of the
named convs through kernel K2 (``dw_pallas_convs``).  The JAX trunk's remat
names are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_ssd_torch.models.layers import TorchConv, max_pool

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

    def _block(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        for i in range(n):
            x = F.relu(getattr(self, f"{name}_{i + 1}")(x))
        return x

    def _cut(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        return x.detach() if self.freeze_stages >= stage else x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._cut(self._block(x, "conv1", 2), 1)
        x = max_pool(x, 2, 2)                                   # 300 -> 150
        x = self._cut(self._block(x, "conv2", 2), 2)
        x = max_pool(x, 2, 2)                                   # 150 -> 75
        x = self._cut(self._block(x, "conv3", 3), 3)
        x = max_pool(x, 2, 2, ceil_mode=True)                   # 75 -> 38
        conv4_3 = self._cut(self._block(x, "conv4", 3), 4)
        x = max_pool(conv4_3, 2, 2)                             # 38 -> 19
        x = max_pool(self._block(x, "conv5", 3), 3, 1, padding=1)  # 19 -> 19
        x = F.relu(self.conv_fc6(x))
        x = F.relu(self.conv_fc7(x))
        return conv4_3, self._cut(x, 5)

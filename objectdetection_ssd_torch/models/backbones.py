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
Training-only features of the JAX trunk (``freeze_stages``, remat names, the
Pallas filter-gradient route) are not part of the serving path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_ssd_torch.models.layers import TorchConv, max_pool

# (stage name, conv count, output channels) of the plain 3x3/p1 conv blocks.
_VGG_BLOCKS = (("conv1", 2, 64), ("conv2", 2, 128), ("conv3", 3, 256),
               ("conv4", 3, 512), ("conv5", 3, 512))


class VGG16Trunk(nn.Module):
    """VGG-16 features through conv_fc7, returning the two SSD taps:
    (conv4_3 (B, 512, 38, 38) before the L2Norm, fc7 (B, 1024, 19, 19))."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, n, features in _VGG_BLOCKS:
            for i in range(n):
                self.add_module(f"{name}_{i + 1}",
                                TorchConv(cin, features, kernel=3, padding=1))
                cin = features
        self.conv_fc6 = TorchConv(512, 1024, kernel=3, padding=4, dilation=4)
        self.conv_fc7 = TorchConv(1024, 1024, kernel=1)

    def _block(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        for i in range(n):
            x = F.relu(getattr(self, f"{name}_{i + 1}")(x))
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = max_pool(self._block(x, "conv1", 2), 2, 2)          # 300 -> 150
        x = max_pool(self._block(x, "conv2", 2), 2, 2)          # 150 -> 75
        x = max_pool(self._block(x, "conv3", 3), 2, 2,
                     ceil_mode=True)                            # 75 -> 38
        conv4_3 = self._block(x, "conv4", 3)
        x = max_pool(conv4_3, 2, 2)                             # 38 -> 19
        x = max_pool(self._block(x, "conv5", 3), 3, 1, padding=1)  # 19 -> 19
        x = F.relu(self.conv_fc6(x))
        x = F.relu(self.conv_fc7(x))
        return conv4_3, x

"""SSD300 (VGG-16) — the port of `objectdetection_ssd_tpu/models/ssd.py`.

Input NHWC (B, 300, 300, 3), uint8 or already-normalized float, like the JAX
model; output ``(loc (B, 8732, 4), conf (B, 8732, 21))`` in the compute
dtype.  Inside, the network runs NCHW: the NHWC input permuted to NCHW is a
``channels_last`` tensor, which is the memory format cuDNN prefers on the
card.

Structure (reference `Model.py:128-235`): VGG taps conv4_3 (L2-normalized,
learnable rescale init 20) and fc7; extra pyramid seq8 (1x1 -> 256, 3x3/s2/p1
-> 512, 10x10), seq9 (1x1 -> 128, 3x3/s2/p1 -> 256, 5x5), seq10 and seq11
(1x1 -> 128, 3x3 VALID -> 256: 3x3, then 1x1); per-tap 3x3 loc/conf heads
with k = [4, 6, 6, 6, 4, 4] anchors per cell, flattened (row, col,
anchor)-major and concatenated in tap order -> 8732 rows aligned with
`ops.priors.ssd300_priors`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_ssd_torch.config import (IMAGENET_MEAN, IMAGENET_STD,
                                              ModelConfig,
                                              NUM_CLASSES_WITH_BG)
from objectdetection_ssd_torch.device import DeviceLike, resolve_device
from objectdetection_ssd_torch.models.backbones import VGG16Trunk
from objectdetection_ssd_torch.models.layers import (L2Norm, TorchConv,
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


def prepare_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 RGB NHWC -> ImageNet-normalized NCHW activations in ``dtype``.

    uint8 is normalized in f32 as ``(x * (1/255) - mean) / std`` (a multiply
    by the reciprocal, as `models/ssd.py:58-62` writes it) before the cast;
    float inputs are taken as already normalized.  The permute gives an NCHW
    view with ``channels_last`` strides, without a copy.
    """
    if x.dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                           device=x.device)
        x = (x.float() * (1.0 / 255.0) - mean) / std
    return x.to(dtype).permute(0, 3, 1, 2)


class SSD300(nn.Module):
    """VGG-16 SSD300.  (B, 300, 300, 3) -> ((B, 8732, 4), (B, 8732, C))."""

    def __init__(self, num_classes: int = NUM_CLASSES_WITH_BG,
                 l2_norm_scale_init: float = 20.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.trunk = VGG16Trunk()
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
        self.reset_parameters(generator)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """Flax-style init from ``generator``, in module order."""
        for m in self.modules():
            if isinstance(m, TorchConv):
                m.reset_parameters(generator)
        self.l2norm_4_3.reset_parameters()

    @property
    def dtype(self) -> torch.dtype:
        return self.l2norm_4_3.scale.dtype

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = prepare_input(images, self.dtype)
        conv4_3, x = self.trunk(x)
        return ssd300_post_trunk(self, conv4_3, x)


def ssd300_post_trunk(model: SSD300, conv4_3: torch.Tensor, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything after the VGG trunk: L2Norm, extra pyramid, heads
    (`models/ssd.py:65-108`)."""
    taps: List[torch.Tensor] = [model.l2norm_4_3(conv4_3), x]
    for name, *_ in _EXTRAS:
        x = F.relu(getattr(model, f"{name}_1")(x))
        x = F.relu(getattr(model, f"{name}_2")(x))
        taps.append(x)
    locs, confs = [], []
    for i, tap in enumerate(taps):
        locs.append(flatten_head(getattr(model, f"loc_head_{i}")(tap), 4))
        confs.append(flatten_head(getattr(model, f"conf_head_{i}")(tap),
                                  model.num_classes))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def build_model(config: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> SSD300:
    """Model registry keyed on ``config.backbone``: the model in eval mode
    on ``device`` (default ``cuda``), in the compute dtype, ``channels_last``,
    with weights drawn from ``generator``."""
    dev = resolve_device(device)
    if config.backbone == "resnet34":
        raise NotImplementedError(
            "the ResNet-34 family is not ported to PyTorch yet")
    if config.backbone != "vgg16":
        raise ValueError(f"unknown backbone: {config.backbone!r}")
    if config.compute_dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {config.compute_dtype!r}")
    model = SSD300(num_classes=config.num_classes,
                   l2_norm_scale_init=config.l2_norm_scale_init,
                   generator=generator)
    return model.to(device=dev, dtype=_DTYPES[config.compute_dtype],
                    memory_format=torch.channels_last).eval()

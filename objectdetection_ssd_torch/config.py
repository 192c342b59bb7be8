"""Typed configuration for the PyTorch port.

A copy of the constants and the dataclass fields of
`objectdetection_ssd_tpu/config.py` that the serving path reads.  The port
keeps its own copy because it must not import the JAX package (whose
``__init__`` imports JAX).  Fields that only steer the TPU compiler
(``scoped_vmem_limit_kib``) or a JAX loop form (``nms_unrolled``,
``approx_recall_target``) are left out: they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# PASCAL VOC class vocabulary: 20 foreground classes, background sentinel at
# index 20 (reference `Util.py:26-27`, `Losses.py:171`).
VOC_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
NUM_CLASSES = len(VOC_CLASSES)          # 20 foreground
BACKGROUND_CLASS = NUM_CLASSES          # 20
NUM_CLASSES_WITH_BG = NUM_CLASSES + 1   # 21 logits

ID_TO_CLASS = dict(enumerate(VOC_CLASSES + ("bg",)))

# ImageNet normalization used by the pretrained VGG backbone
# (reference `Dataset.py:12`).
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """SSD300 prior (anchor) grid spec (reference `Util.py:105-137`)."""

    feature_map_sizes: Sequence[int] = (38, 19, 10, 5, 3, 1)
    scales: Sequence[float] = (0.1, 0.2, 0.375, 0.55, 0.725, 0.9)
    # Aspect ratios per map; ratio 1.0 additionally emits the extra
    # sqrt(s_k * s_{k+1}) box (reference `Util.py:129-134`).
    aspect_ratios: Sequence[Sequence[float]] = (
        (1.0, 2.0, 0.5),
        (1.0, 2.0, 3.0, 0.5, 0.333),
        (1.0, 2.0, 3.0, 0.5, 0.333),
        (1.0, 2.0, 3.0, 0.5, 0.333),
        (1.0, 2.0, 0.5),
        (1.0, 2.0, 0.5),
    )

    @property
    def boxes_per_cell(self) -> Tuple[int, ...]:
        return tuple(len(r) + 1 for r in self.aspect_ratios)

    @property
    def num_priors(self) -> int:
        return sum(
            g * g * k
            for g, k in zip(self.feature_map_sizes, self.boxes_per_cell)
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SSD model selection.  Only ``backbone="vgg16"`` is ported so far;
    ``"resnet34"`` raises in `models.ssd.build_model`."""

    backbone: str = "vgg16"            # "vgg16" | "resnet34"
    image_size: int = 300              # square input (reference 300x300)
    num_classes: int = NUM_CLASSES_WITH_BG
    # conv4_3 L2-norm rescale initial value (reference `Model.py:133`).
    l2_norm_scale_init: float = 20.0
    # Compute dtype of the conv stack ("float32" or "bfloat16").  The
    # parameters are held in this dtype on the device, which rounds them
    # once exactly as flax's ``dtype=`` casts them at every use.
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Detection post-processing (reference `Losses.py:11`)."""

    score_threshold: float = 0.2
    nms_iou_threshold: float = 0.45
    top_k: int = 200                   # global cap across classes
    # Fixed-shape per-class candidate slots: the NMS works on the top-K
    # scores >= threshold per class.  The NMS kernel takes K <= 256.
    per_class_top_k: int = 64
    # Selects the two-stage candidate path (anchor prefilter, then a
    # per-class top-k over the M kept anchors) and, without a prefilter, a
    # bf16 score ranking; False selects the exact single-stage f32 path.
    # The JAX package runs `lax.approx_max_k` here on the TPU.  The port
    # ranks with an exact, stable top-k in both stages, which is also what
    # JAX's own CPU lowering of `approx_max_k` computes, so the two
    # packages agree on the CPU index for index.
    use_approx_top_k: bool = True
    # Anchors kept by the first stage (0 disables the prefilter).
    anchor_prefilter: int = 128
    # "hard" = the reference's binary greedy suppression.  The soft-NMS
    # methods ("soft_gaussian", "soft_linear") and flip TTA are not ported
    # yet: `infer.postprocess` and `infer.detector` raise
    # NotImplementedError for them.
    nms_method: str = "hard"
    soft_nms_sigma: float = 0.5
    tta_flip: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    """What a `infer.detector.Detector` reads."""

    priors: PriorConfig = dataclasses.field(default_factory=PriorConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    postprocess: PostprocessConfig = dataclasses.field(
        default_factory=PostprocessConfig)

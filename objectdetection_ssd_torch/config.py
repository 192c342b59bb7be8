"""Typed configuration for the PyTorch port.

A copy of the constants and the dataclass fields of
`objectdetection_ssd_tpu/config.py` that the ported modules read.  The port
keeps its own copy because it must not import the JAX package (whose
``__init__`` imports JAX).  Fields that only steer the TPU compiler
(``scoped_vmem_limit_kib``, ``compilation_cache_dir``) or a JAX loop form
(``nms_unrolled``, ``approx_recall_target``) are left out: they have no
counterpart here.  Nor has ``donate_state``: PyTorch's step updates the
state in place already.  The doctor has no config section: its settings
are ``cli doctor``'s flags.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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

CLASS_TO_ID = {name: i for i, name in enumerate(VOC_CLASSES)}
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
    """SSD model family selection: ``"vgg16"`` (SSD300, 300 px, 8732
    priors) or ``"resnet34"`` (`models.ssd.SSDResNet34`, 224 px, 189
    priors)."""

    backbone: str = "vgg16"            # "vgg16" | "resnet34"
    image_size: int = 300              # square input (reference 300x300)
    num_classes: int = NUM_CLASSES_WITH_BG
    # conv4_3 L2-norm rescale initial value (reference `Model.py:133`).
    l2_norm_scale_init: float = 20.0
    # ResNet-34 variant: freeze the trunk (reference `Model.py:81-86` runs
    # it under torch.no_grad()): its BatchNorms keep their running
    # statistics in train mode and its parameters get no update.
    freeze_backbone: bool = True
    # VGG-16 variant: freeze the first N conv stages (1=conv1 .. 5=whole
    # trunk incl. fc6/fc7): a detach at the stage boundary, and the frozen
    # parameters get neither an update nor weight decay.
    freeze_stages: int = 0
    dropout_rate: float = 0.4          # reference `Model.py:13`
    # Compute dtype of the conv stack ("float32" or "bfloat16").  Every conv
    # casts its weight and bias, and the L2Norm its scale, to the compute
    # dtype at use, as flax's ``dtype=`` does.  The serving model holds its
    # parameters in this dtype (the casts are then no-ops); the train model
    # holds them in f32.
    compute_dtype: str = "float32"
    # VGG trunk convs (e.g. "conv1_2") whose filter gradient runs on the
    # hand-written CUDA kernel K2 (`ops/dw_cuda.py`) during training; the
    # JAX package routes the same names through its Pallas kernel.  Only
    # 3x3/stride-1/pad-1 convs take the route.  Default () = cuDNN always.
    dw_pallas_convs: Sequence[str] = ()


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Multibox loss knobs (reference `Losses.py:136-199`)."""

    match_iou_threshold: float = 0.5   # bg below this (`Losses.py:171`)
    neg_pos_ratio: int = 3             # hard negatives (`Losses.py:189`)
    # The reference calls its loc loss `smooth_l1` but instantiates plain
    # nn.L1Loss (`Losses.py:147`).  L1 for parity; huber is opt-in.
    loc_loss: str = "l1"               # "l1" | "huber"
    # Encode variance conventions as the reference writes them: /10 for
    # centers, *5 for sizes (`Util.py:86-102`).
    center_variance_inv: float = 10.0
    size_variance_inv: float = 5.0
    # Hard-negative mining needs only the SUM of each image's top
    # 3*N_pos negative CE values (`Losses.py:188-195`): rank the top
    # `hnm_topk` candidates with a partial top-k, and take the exact full
    # sort whenever any image needs more than `hnm_topk` negatives.  Both
    # branches sum the same multiset.  0 = always the full sort.
    hnm_topk: int = 1024


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
    # "hard" = the reference's binary greedy suppression (kernel K1 on the
    # card); "soft_gaussian" / "soft_linear" = Soft-NMS (Bodla et al.
    # 2017, `infer.postprocess.soft_nms_scores`): overlapping candidates
    # keep a decayed score instead of being dropped.
    nms_method: str = "hard"
    soft_nms_sigma: float = 0.5        # gaussian decay width
    # Flip TTA: also run the horizontal mirror of each image and merge the
    # two views (`infer.detector.forward_for_postprocess`).
    tta_flip: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """SGD setup (reference `train.py:53-57`)."""

    lr: float = 1e-4
    bias_lr_multiplier: float = 2.0    # 2x lr for biases (`train.py:54`)
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # StepLR(step_size=7, gamma=0.1), stepped for real on an epoch clock
    # (the reference constructs it and never steps it: parity mode turns
    # it off).
    lr_decay_epochs: int = 7
    lr_decay_gamma: float = 0.1
    use_lr_schedule: bool = True
    # Linear lr warmup over the first N updates (0 = off).
    warmup_steps: int = 0
    # Average the gradients of N micro-batches into one SGD update
    # (`optax.MultiSteps` in the JAX package); parameters, momentum, the
    # schedule's count and the EMA move only when a window closes.  1 = off.
    grad_accum_steps: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """VOC data pipeline (reference `DataLists.py`, `Dataset.py`, `train.py`)."""

    voc_root: str = "VOCdevkit"
    batch_size: int = 20               # reference `train.py:29`
    num_workers: int = 2               # reference `train.py:29`
    max_boxes: int = 64                # pad ragged GT to this many per image
    keep_difficult: bool = False       # reference `Dataset.py:29-31`
    val_fraction: float = 0.1          # reference `train.py:14`
    split_seed: int = 10               # reference `train.py:13`
    # The reference samples the val split WITH replacement (`train.py:14`);
    # True reproduces it exactly, False takes a clean permutation split.
    parity_split: bool = False
    # A missing VOC year's list file is a hard error unless this opts in
    # (see data/voc.py:voc_file_lists).
    allow_partial_voc: bool = False
    augment: bool = True
    # Augment in the native C++ pipeline (native/src/voc_native.cpp) when
    # built: same transform semantics as the numpy path, its own
    # deterministic random stream.
    use_native_augment: bool = True
    # Dtype of the image batches shipped to the device: "uint8" sends raw
    # 0-255 pixels and the model normalizes on the device; "float32" ships
    # host-normalized images.
    transfer_dtype: str = "uint8"
    # Packed decoded-image cache path prefix (`--image-cache`,
    # data/cache.py): the train loader decodes every image once into
    # `<prefix>.bin/.idx.npz`; eval appends `.{split}` / `.val`.
    image_cache: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 1000             # reference `train.py:59`
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_epochs: int = 1   # reference saves per epoch
    max_checkpoints_to_keep: int = 3
    log_every_steps: int = 20          # reference `train_function.py:99`
    # TensorBoard event files (tensorboardX), written by the primary.
    tensorboard_dir: Optional[str] = None
    seed: int = 10
    # The mesh of a multi-process run (`parallel/mesh.py`), one process per
    # card: None = every process on 'data' (DDP); ("data", "fsdp") axes
    # shard the parameters over 'fsdp' (FSDP2); ("data", "model") the conv
    # channels (tensor parallelism); ("data", "spatial") the image rows.
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("data",)
    # A second input-pipeline stage on its own thread that copies each
    # batch to the card (pinned memory, a side stream), so the copy of
    # batch N+1 overlaps the step of batch N.  Same numbers either way.
    device_prefetch: bool = False
    # Gradient-checkpoint the VGG trunk at its stage boundaries
    # (`torch.utils.checkpoint`): only the pool outputs and the SSD taps are
    # kept for the backward, the stage interiors are recomputed.  The
    # ResNet-34 family accepts it and runs unchanged, as in JAX.
    remat: bool = False
    # Exponential moving average of the weights, e <- d*e + (1-d)*p per
    # optimizer update; 0.0 = off (the reference has none).
    ema_decay: float = 0.0
    # Pipeline parallelism (`parallel/pipeline.py`, `train --pp N`): the
    # model cut into N stages, one per device; 0 or 1 = off.
    pp_stages: int = 0
    # Microbatches streamed per step under --pp; gradients are MEANed over
    # them (`--grad-accum` semantics; 1 = the monolithic step).
    pp_microbatches: int = 1
    # Data-parallel ways WITHIN each pipeline stage (`--pp N --pp-dp D`,
    # N x D devices): each microbatch's rows split over the stage's D
    # replicas, their gradients summed onto the stage's lead device.
    pp_dp: int = 1


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Post-training int8 quantization for serving, and quantization-aware
    training (`infer/quant.py`).  Checkpoints stay f32: the same weights
    drive the float and the int8 model."""

    int8: bool = False
    # Images drawn from the train split (eval) or the input images (detect)
    # for the activation-range calibration; ranges only widen with more.
    calib_images: int = 64
    # Keep the loc/conf heads in float (the usual PTQ recipe); True
    # quantizes them too.
    quantize_heads: bool = False
    # Each chained conv's epilogue emits int8 in the next conv's activation
    # scale (`infer/quant.py:chain_scales`); bit-equal to the unchained
    # graph, so on by default.
    chain_requant: bool = True
    # Ignore the checkpoint directory's saved quant_scales.json and
    # calibrate afresh (the escape from its fingerprint binding).
    recalibrate: bool = False
    # `train --qat`: calibrate on the current weights, then train through
    # the straight-through fake-quant convs.
    qat: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    priors: PriorConfig = dataclasses.field(default_factory=PriorConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    postprocess: PostprocessConfig = dataclasses.field(
        default_factory=PostprocessConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

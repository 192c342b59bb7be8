"""objectdetection_ssd_torch — the PyTorch/CUDA port of
`objectdetection_ssd_tpu`, for NVIDIA Hopper (H100).

It imports no JAX and nothing of the JAX package; the JAX package stays the
reference that the tests hold this one against, and
`tests/test_torch_api_surface.py` holds its public names to the JAX
package's.  It serves and trains SSD300-VGG16 and the ResNet-34 SSD (bf16
or int8, with hand-written CUDA kernels for greedy NMS, the routed convs'
filter gradient and the int8 conv), evaluates VOC mAP, exports a serving
artifact, and trains under data, FSDP, tensor, spatial and pipeline
parallelism, all through the `train` / `eval` / `detect` / `export` /
`doctor` CLI.

Quick start (on a CUDA card):
    from objectdetection_ssd_torch import Config, build_model, ssd300_priors
    from objectdetection_ssd_torch.infer.detector import Detector
    det = Detector(Config(), state_dict)          # device defaults to cuda
    dets = det.detect_batch(uint8_images_nhwc)

    python -m objectdetection_ssd_torch.cli train --voc-root VOCdevkit

The package-level names are the JAX package's, imported on first use: the
Loader's spawn workers import `data.pipeline`, `native` and `cli`, which
run this file and must not import torch.
"""

import importlib

_EXPORTS = {
    "objectdetection_ssd_torch.config": (
        "BACKGROUND_CLASS", "CLASS_TO_ID", "ID_TO_CLASS", "NUM_CLASSES",
        "NUM_CLASSES_WITH_BG", "VOC_CLASSES", "Config", "DataConfig",
        "LossConfig", "ModelConfig", "OptimConfig", "PostprocessConfig",
        "PriorConfig", "QuantConfig", "TrainConfig"),
    "objectdetection_ssd_torch.infer.postprocess": (
        "Detections", "postprocess", "scale_detections"),
    "objectdetection_ssd_torch.losses.multibox": ("multibox_loss",),
    "objectdetection_ssd_torch.models.ssd": (
        "SSD300", "SSDResNet34", "build_model"),
    "objectdetection_ssd_torch.ops.boxes": (
        "cxcywh_to_xyxy", "decode", "encode", "pairwise_iou",
        "xyxy_to_cxcywh"),
    "objectdetection_ssd_torch.ops.priors": (
        "priors_for_model", "resnet34_priors", "ssd300_priors",
        "zoom_ratio_priors"),
}
_SOURCE = {name: module for module, names in _EXPORTS.items()
           for name in names}

__version__ = "0.3.0"
__all__ = sorted(_SOURCE) + ["__version__"]


def __getattr__(name: str):
    module = _SOURCE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

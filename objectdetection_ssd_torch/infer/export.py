"""The serving artifact: the whole inference program, exported with
`torch.export` — the port of `objectdetection_ssd_tpu/infer/export.py`.

`export_detector` traces the `Detector`'s forward (flip TTA included) and
`postprocess` into one `ExportedProgram`, with the weights, the int8
weights of the quantized convs and the priors baked in, and writes it
with `torch.export.save`.  `ExportedDetector` loads it with
`torch.export.load` and runs it with no model code: what it imports is
the two kernel modules, whose custom ops (``ssd::nms_keep``, K1;
``ssd::int8_conv``, K3) the program calls, so the artifact launches the
same kernels as the eager `Detector` on the card and runs their plain
versions on the CPU.

Artifact layout (a directory):
  program.pt2  -- the `torch.export.save` archive
  meta.json    -- the JAX package's format-1.3 keys, less its TPU-only
                  ``scoped_vmem_limit_kib`` (ignored when present)
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import torch
from torch.export.passes import move_to_device_pass

# The custom ops the program calls must be registered before it loads.
from objectdetection_ssd_torch.infer import nms_cuda  # noqa: F401
from objectdetection_ssd_torch.ops import int8_conv  # noqa: F401
from objectdetection_ssd_torch.config import Config, VOC_CLASSES
from objectdetection_ssd_torch.device import DeviceLike, resolve_device
from objectdetection_ssd_torch.infer.postprocess import Detections

PROGRAM = "program.pt2"
META = "meta.json"
# The JAX package's artifact, which this loader cannot run.
JAX_PROGRAM = "program.jaxexport"
# The JAX package's format (`infer/export.py:48`): loaders refuse another
# major version.
FORMAT_VERSION = "1.3"


class _Serving(torch.nn.Module):
    """(B, S, S, 3) images -> (boxes, scores, classes, valid): the
    `Detector.detect_batch` program of ``detector``."""

    def __init__(self, detector):
        super().__init__()
        self.model = detector.model
        self.pp_config = detector.pp_config
        self.register_buffer("priors", detector.priors)
        self.register_buffer("mirror_perm", detector.mirror_perm)

    def forward(self, images: torch.Tensor):
        from objectdetection_ssd_torch.infer.detector import (
            forward_for_postprocess)
        from objectdetection_ssd_torch.infer.postprocess import postprocess
        loc, conf, priors = forward_for_postprocess(
            self.model, images, self.priors, self.pp_config,
            self.mirror_perm)
        return tuple(postprocess(loc, conf, priors, self.pp_config))


def export_detector(config: Config, state_dict: Mapping[str, torch.Tensor],
                    out_dir: str, batch_size: int = 8,
                    input_dtype: Optional[str] = None,
                    quant: Optional[Mapping[str, Any]] = None,
                    device: DeviceLike = None) -> str:
    """Export (model forward + postprocess) with the weights baked in, at a
    fixed ``(batch_size, S, S, 3)`` input, to ``out_dir``; returns it.

    ``input_dtype``: "uint8" (default, from `DataConfig.transfer_dtype`)
    takes raw 0-255 pixels and normalizes inside the program; "float32"
    takes host-normalized images.  ``quant``: an int8 scale tree
    (`infer.quant.act_scales`, chained or not): the convs it names run on
    K3 with their int8 weights baked in.  ``device`` (default ``cuda``):
    the device the program is exported for; `ExportedDetector` can move it
    to another."""
    from objectdetection_ssd_torch.infer.detector import Detector
    from objectdetection_ssd_torch.infer.quant import _leaves
    from objectdetection_ssd_torch.models.layers import TorchConv
    input_dtype = input_dtype or config.data.transfer_dtype
    if input_dtype not in ("uint8", "float32"):
        raise ValueError(f"input_dtype must be uint8 or float32, got "
                         f"{input_dtype!r}")
    det = Detector(config, state_dict, device=device, quant=quant)
    # The int8 weights exist before tracing (`TorchConv.int8_weight`).
    for m in det.model.modules():
        if isinstance(m, TorchConv) and m.quant is not None:
            m.int8_weight()
    size = config.model.image_size
    example = torch.zeros((batch_size, size, size, 3),
                          dtype=getattr(torch, input_dtype),
                          device=det.device)
    with torch.no_grad():
        program = torch.export.export(_Serving(det), (example,))
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump({
            "format_version": FORMAT_VERSION,
            "input_dtype": input_dtype,
            "batch_size": batch_size,
            "image_size": size,
            "top_k": det.pp_config.top_k,
            "classes": list(VOC_CLASSES),
            "backbone": config.model.backbone,
            "platforms": [det.device.type],
            # Scale leaves, as the JAX package counts them.
            "quantized_convs": (0 if quant is None
                                else len(list(_leaves(quant)))),
            "tta_flip": bool(det.pp_config.tta_flip),
        }, f, indent=2)
    return out_dir


def load_program(artifact_dir: str,
                 device: torch.device) -> torch.export.ExportedProgram:
    """The artifact's program, loaded and moved to ``device`` (a card's
    artifact on the CPU runs the kernels' plain versions)."""
    path = os.path.join(artifact_dir, PROGRAM)
    if not os.path.exists(path):
        jax_art = os.path.exists(os.path.join(artifact_dir, JAX_PROGRAM))
        raise ValueError(
            f"{artifact_dir!r} holds no {PROGRAM}"
            + (f" (its {JAX_PROGRAM} is a JAX artifact: serve it with "
               "objectdetection_ssd_tpu.infer.export.ExportedDetector, or "
               "re-export with objectdetection_ssd_torch.cli export)"
               if jax_art else ""))
    return move_to_device_pass(torch.export.load(path), str(device))


def read_meta(artifact_dir: str) -> dict:
    with open(os.path.join(artifact_dir, META)) as f:
        meta = json.load(f)
    check_format_version(meta)
    return meta


class ExportedDetector:
    """Load and run an exported artifact: no model code needed.

    ``device``: ``cuda`` by default (raises without a card); ``"cpu"``
    runs the program, a card's artifact included, on the CPU."""

    def __init__(self, artifact_dir: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.meta = read_meta(artifact_dir)
        self.program = load_program(artifact_dir, self.device)
        self._call = self.program.module()

    @torch.inference_mode()
    def __call__(self, images) -> Detections:
        """(B, S, S, 3) images -> Detections on this detector's device.

        The images' dtype is ``meta["input_dtype"]`` (a mismatch raises).
        The program is fixed at the exported batch size: a smaller batch is
        padded by repeating its last image, a larger one runs in chunks of
        that size, and the rows of the padding are dropped."""
        b = self.meta["batch_size"]
        images = torch.as_tensor(images)
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        outs = []
        for start in range(0, n, b):
            chunk = images[start:start + b]
            if chunk.shape[0] < b:
                pad = chunk[-1:].expand(b - chunk.shape[0], *chunk.shape[1:])
                chunk = torch.cat([chunk, pad])
            outs.append(self._call(chunk.to(self.device, non_blocking=True)))
        return Detections(*(torch.cat(parts)[:n] if len(outs) > 1
                            else parts[0][:n] for parts in zip(*outs)))


def check_format_version(meta: dict) -> None:
    """Refuse an artifact whose major format version differs from ours.
    An artifact without ``format_version`` counts as major 1, as in the
    JAX package."""
    found = str(meta.get("format_version", "1.0"))
    if found.split(".")[0] != FORMAT_VERSION.split(".")[0]:
        raise ValueError(
            f"artifact format_version {found} is incompatible with this "
            f"loader (supports major {FORMAT_VERSION.split('.')[0]}); "
            "re-export the artifact or upgrade the serving host")

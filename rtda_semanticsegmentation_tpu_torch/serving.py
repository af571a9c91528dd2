"""Serving: the end-to-end function and its exported artifacts (port of the
JAX ``serving.py``).

:func:`make_serving_fn` serves eagerly. :func:`export_serving` traces the
same :class:`ServingModule` with ``torch.export`` (uint8 frames -> ImageNet
normalize -> forward -> argmax -> uint8 trainId masks, the weights held in
the program), with a symbolic batch or a pinned one. The int8 convs (K3)
and the ``fused_conv3`` convs (K4) are the ops ``rtda_torch::int8_conv``
and ``rtda_torch::conv3x3``, so the graph holds one opaque node per kernel
call whichever device traced it, and the loaded program launches the
kernels on a card.

Artifact layout (a directory)::

    <dir>/model.pt2    torch.export.save of the ExportedProgram
    <dir>/meta.json    model / shape / precision metadata

:func:`load_artifact` returns ``(fn, meta)`` with ``fn(images_u8) ->
trainId masks``; it needs torch and the kernels' op registration, no model
code. ``cli/predict.py --artifact`` serves one directly. The program runs
eagerly, op by op, as the eager path does (no AOT compile).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch
import torch.nn as nn

from .obs.spans import Unit, span
from .ops.augment import normalize_u8

ARTIFACT_GRAPH = "model.pt2"
ARTIFACT_META = "meta.json"
_FORMAT_VERSION = 1


class ServingModule(nn.Module):
    """uint8 (B, H, W, 3) frames -> logits or uint8 trainId masks: what
    :func:`make_serving_fn` runs and :func:`export_serving` traces."""

    def __init__(self, model: nn.Module, augment_cfg, dtype: torch.dtype):
        super().__init__()
        self.model, self.augment_cfg, self.dtype = model, augment_cfg, dtype

    def logits(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = normalize_u8(images_u8, self.augment_cfg).to(self.dtype)
        # NHWC -> NCHW view: channels_last memory, which the convs and the
        # int8 and K4 kernels' NHWC operands all read without a copy
        return self.model(x.permute(0, 3, 1, 2))

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(images_u8), dim=1).to(torch.uint8)


def serving_module(model_cfg, augment_cfg, variables, precision: str = "bf16", *, device="cuda",
                   fused_conv3: bool = False) -> ServingModule:
    """The eval :class:`ServingModule` of ``precision`` with ``variables``
    loaded and the kernels' operands folded (see :func:`make_serving_fn`)."""
    from .models.factory import build_model, load_variables
    from .models.layers import fold_kernel_operands
    from .models.quantize import freeze, quantized_model

    if fused_conv3 and precision != "bf16":
        raise ValueError(f"fused_conv3 serves bf16 only (K4 rounds its operands to bf16), got {precision!r}")
    if precision == "int8":
        if not any(k.endswith(".in_absmax") for k in variables):
            raise ValueError(
                "int8 serving needs calibrated variables — run "
                "models.quantize.calibrate() first"
            )
        if not any(k.endswith(".a") for k in variables):
            variables = freeze(model_cfg, variables)
        model = quantized_model(model_cfg, frozen=True, device=device)
        dtype = torch.bfloat16
    elif precision in ("bf16", "f32"):
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        model = build_model(
            dataclasses.replace(model_cfg, compute_dtype=str(dtype).split(".")[1], quant="none"),
            device, fused_conv3=fused_conv3,
        )
    else:
        raise ValueError(f"unknown precision {precision!r}")
    load_variables(model, variables)
    fold_kernel_operands(model)
    module = ServingModule(model, augment_cfg, dtype).eval()
    module.requires_grad_(False)
    return module


def make_serving_fn(model_cfg, augment_cfg, variables, precision: str = "bf16", *, device="cuda",
                    fused_conv3: bool = False):
    """``images_u8 (B, H, W, 3) -> trainId masks (B, H, W) uint8`` on ``device``.

    ``precision``: ``bf16`` | ``f32`` (the float forward in that compute
    dtype) or ``int8`` (the PTQ path on kernel K3, for every model:
    ``variables`` must carry the quantization statistics from
    ``models.quantize.calibrate``; they are frozen here when ``freeze`` has
    not run). ``variables`` is the
    model's state_dict; the weights are loaded once, here. ``fused_conv3``
    (``bf16`` only) runs the 3x3 / stride-1 ConvBNs on K4, their BatchNorm
    folded once, here.
    """
    module = serving_module(model_cfg, augment_cfg, variables, precision, device=device, fused_conv3=fused_conv3)

    @torch.inference_mode()
    def logits(images_u8):
        return module.logits(torch.as_tensor(images_u8, device=device))

    serve = _served(module, device)
    serve.logits = logits  # (B, classes, H, W), for checks of the forward
    return serve


def _served(program, device):
    """``program`` behind the serving call's spans (``obs/spans.py``):
    ``serve.request`` holds ``serve.copy_in`` (the frames to ``device``)
    and ``serve.forward`` (``program``: normalize, forward, argmax,
    uint8). The spans stay outside ``program``, so an exported graph holds
    none."""
    unit = Unit("serve.request")

    @torch.inference_mode()
    def serve(images_u8):
        with unit(device):
            with span("serve.copy_in"):
                x = torch.as_tensor(images_u8, device=device)
            with span("serve.forward"):
                return program(x)

    return serve


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return device


def export_serving(model_cfg, augment_cfg, variables, height: int, width: int, batch: Optional[int] = None,
                   precision: str = "bf16", *, fused_conv3: bool = False, device="cuda"):
    """Export the serving module; returns ``(ExportedProgram, meta)``.

    ``batch=None`` exports a symbolic batch dimension (one artifact, any
    batch size); an int pins it. The graph is traced on ``device``
    (``load_artifact`` can move it to another). The int8 path freezes the
    calibrated variables and raises without calibration, as
    :func:`make_serving_fn` does.
    """
    from .models.layers import check_kernel_operands

    if batch is not None and batch <= 0:
        raise ValueError(f"batch must be positive or None, got {batch}")
    device = _device(device)
    module = serving_module(model_cfg, augment_cfg, variables, precision, device=device, fused_conv3=fused_conv3)
    check_kernel_operands(module)
    sample = torch.zeros((2 if batch is None else batch, height, width, 3), dtype=torch.uint8, device=device)
    dynamic = {"images_u8": {0: torch.export.Dim("batch", min=1)}} if batch is None else None
    with torch.no_grad():
        exported = torch.export.export(module, (sample,), dynamic_shapes=dynamic)
    meta = {
        "format_version": _FORMAT_VERSION,
        "model": model_cfg.name,
        "context_path": model_cfg.context_path,
        "num_classes": model_cfg.num_classes,
        "precision": precision,
        "quant_clip": model_cfg.quant_clip if precision == "int8" else None,
        "height": height,
        "width": width,
        "batch": batch,  # null => symbolic
        "platforms": [device.type],
        "fused_conv3": fused_conv3,
        "input": "uint8 NHWC RGB images, any size pre-resized to (height, width)",
        "output": "uint8 NHW trainId masks (argmax over classes)",
        "torch_version": torch.__version__,
    }
    return exported, meta


def save_artifact(path: str, exported, meta: dict) -> None:
    """Write ``<path>/model.pt2`` + ``<path>/meta.json``."""
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, ARTIFACT_GRAPH))
    with open(os.path.join(path, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def load_artifact(path: str, device="cuda"):
    """Load an exported artifact; returns ``(fn, meta)``.

    ``fn(images_u8)`` takes a numpy or torch uint8 (B, H, W, 3) array — B
    free if the artifact was exported with a symbolic batch — and returns
    the uint8 trainId masks on ``device``. A program traced on another
    device is moved there (``move_to_device_pass``). ``device="cuda"``
    without a card raises.
    """
    from torch.export.passes import move_to_device_pass

    from .kernels import conv3x3, int8_conv  # noqa: F401  (register the kernels' ops)

    graph = os.path.join(path, ARTIFACT_GRAPH)
    meta_path = os.path.join(path, ARTIFACT_META)
    if not os.path.isfile(graph):
        raise FileNotFoundError(f"no serving artifact at {path!r} ({graph} missing)")
    device = _device(device)
    meta = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    exported = torch.export.load(graph)
    if meta.get("platforms", [device.type]) != [device.type]:
        exported = move_to_device_pass(exported, device)
    return _served(exported.module(), device), meta

"""The end-to-end serving function (port of the JAX ``serving.py::
make_serving_fn``; AOT export and artifact loading are not ported yet)."""

from __future__ import annotations

import dataclasses

import torch

from .models.factory import build_model, load_variables
from .models.layers import fold_kernel_operands
from .models.quantize import freeze, quantized_model
from .ops.augment import normalize_u8


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

    @torch.inference_mode()
    def logits(images_u8):
        x = normalize_u8(torch.as_tensor(images_u8, device=device), augment_cfg).to(dtype)
        # NHWC -> NCHW view: channels_last memory, which the convs and the
        # int8 and K4 kernels' NHWC operands all read without a copy
        return model(x.permute(0, 3, 1, 2))

    @torch.inference_mode()
    def serve(images_u8):
        return torch.argmax(logits(images_u8), dim=1).to(torch.uint8)

    serve.logits = logits  # (B, classes, H, W), for checks of the forward
    return serve

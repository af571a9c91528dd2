"""int8 PTQ calibration and the frozen quantized model (serving path).

Port of the JAX ``models/quantize.py``:

    variables = calibrate(cfg.model, variables, calib_batches, device=dev)
    variables = freeze(cfg.model, variables)
    model = quantized_model(cfg.model, frozen=True, device=dev)
    load_variables(model, variables)

``freeze`` runs no forward: the frozen constants depend only on the
parameters and the calibrated statistics. Besides the JAX package's
``wq`` / ``sw`` / ``c`` it folds each quantized conv's BatchNorm into the
int8 kernel's epilogue, ``z = acc * a + b`` with ``a = sw * bn_scale`` and
``b = c * bn_scale + bn_shift``, once.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from ..config import ModelConfig
from ..ops.quant import freeze_weights
from .convert import QUANT_STATS
from .factory import build_model, load_variables
from .layers import fold_batch_norm


def calibrate(model_cfg: ModelConfig, variables: dict, batches: Iterable, device="cpu") -> dict:
    """Run calibration forwards; returns ``variables`` + the quant stats.

    ``batches`` yields normalized float images (B, H, W, 3), NHWC as in the
    JAX package. Stats already in ``variables`` are merged into (max for the
    clip statistic, running mean for ``in_mean``)."""
    if model_cfg.quant not in ("none", "calib", "int8"):
        raise ValueError(f"unknown quant mode {model_cfg.quant!r}")
    model = build_model(dataclasses.replace(model_cfg, quant="calib"), device)
    load_variables(model, variables)
    n = 0
    with torch.no_grad():
        for images in batches:
            model(torch.as_tensor(images, device=device).permute(0, 3, 1, 2))
            n += 1
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    stats = {k: v for k, v in model.state_dict().items() if k.rsplit(".", 1)[-1] in QUANT_STATS}
    return {**variables, **stats}


def freeze(model_cfg: ModelConfig, variables: dict) -> dict:
    """Precompute the int8 serving constants of every calibrated conv.

    ``wq`` / ``sw`` / ``c`` already present (say, bridged from the JAX
    package's ``freeze``) are kept; the epilogue ``a`` / ``b`` are always
    recomputed from them and the conv's BatchNorm."""
    convs = [k[: -len(".in_absmax")] for k in variables if k.endswith(".in_absmax")]
    if not convs:
        raise ValueError("freeze() needs calibrated variables (quant_stats)")
    out = dict(variables)
    with torch.no_grad():
        for conv in convs:
            if f"{conv}.wq" not in out:
                kernel = out[f"{conv}.weight"].permute(2, 3, 1, 0)  # OIHW -> HWIO
                wq, sw, c = freeze_weights(kernel, out[f"{conv}.in_absmax"], out[f"{conv}.in_mean"])
                out.update({f"{conv}.wq": wq.contiguous(), f"{conv}.sw": sw, f"{conv}.c": c})
            bn = conv.rsplit(".", 1)[0] + ".bn"
            scale, shift = fold_batch_norm(
                out[f"{bn}.weight"], out[f"{bn}.bias"],
                out[f"{bn}.running_mean"], out[f"{bn}.running_var"],
            )
            out[f"{conv}.a"] = out[f"{conv}.sw"] * scale
            out[f"{conv}.b"] = out[f"{conv}.c"] * scale + shift
    return out


def quantized_model(model_cfg: ModelConfig, frozen: bool = True, device="cpu"):
    """The generator with its quantized convs on the int8 kernel; load the
    :func:`freeze` output into it with ``factory.load_variables``."""
    if not frozen:
        raise NotImplementedError("the non-frozen int8 mode is not ported yet; use frozen=True")
    return build_model(dataclasses.replace(model_cfg, quant="int8_frozen"), device)

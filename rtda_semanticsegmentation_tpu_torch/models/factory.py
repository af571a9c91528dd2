"""Model construction, seeded initialization and weight loading.

Port of the JAX ``models/factory.py`` for BiSeNet with the ResNet-18
context path. A model's "variables" in the port are its ``state_dict``;
``models/convert.py`` maps them to and from the JAX package's flat keys.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from ..config import ModelConfig
from .bisenet import BiSeNet
from .convert import QUANT_FROZEN, QUANT_STATS
from .layers import Conv, QuantPolicy


def build_model(cfg: ModelConfig, device="cpu") -> BiSeNet:
    """The generator named by ``cfg.name``, with uninitialized parameters.

    ``cfg.quant``: ``none``, ``calib`` or ``int8_frozen`` (set by
    ``models/quantize.py``)."""
    if cfg.name != "bisenet":
        raise NotImplementedError(f"model {cfg.name!r} is not ported yet (only bisenet)")
    if cfg.quant not in ("none", "calib", "int8_frozen"):
        raise NotImplementedError(
            f"quant mode {cfg.quant!r} is not ported (none, calib, int8_frozen)"
        )
    quant = QuantPolicy(cfg.quant, cfg.quant_min_ch, cfg.quant_clip, tuple(cfg.quant_skip))
    model = BiSeNet(cfg.num_classes, cfg.context_path,
                    dtype=getattr(torch, cfg.compute_dtype), quant=quant)
    return model.to(device).eval()


@torch.no_grad()
def init_model(model: torch.nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill every conv kernel with Kaiming-normal draws (fan mode per conv,
    as the JAX initializers: fan-out in the ResNet, fan-in elsewhere) from
    ``generator`` (a CPU generator, so a seed gives the same weights on any
    device), conv biases with zeros; BatchNorm starts at identity. Returns
    the model's variables (its ``state_dict``)."""
    for module in model.modules():
        if isinstance(module, Conv):
            o, i, kh, kw = module.weight.shape
            fan = (i if module.init == "fan_in" else o) * kh * kw
            w = torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / fan)
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.zero_()
    return model.state_dict()


def _is_quant(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in QUANT_STATS + QUANT_FROZEN


def load_variables(model: torch.nn.Module, variables: Mapping[str, torch.Tensor]) -> None:
    """Load ``variables`` into ``model`` as a JAX ``apply`` would read them.

    Every parameter, BatchNorm statistic and frozen int8 constant the model
    has must be given, with its shape. Quantization statistics the model
    lacks are ignored (a float model ignores the quant collections) and
    those it has but ``variables`` lacks keep their zero init (calibration
    starts from zeros)."""
    own = model.state_dict()
    unknown = [k for k in variables if k not in own and not _is_quant(k)]
    if unknown:
        raise KeyError(f"variables not in the model: {unknown[:5]}")
    missing = [
        k for k in own
        if k not in variables and k.rsplit(".", 1)[-1] not in QUANT_STATS
    ]
    if missing:
        hint = " (int8 serving needs freeze())" if any(_is_quant(k) for k in missing) else ""
        raise KeyError(f"model variables missing{hint}: {missing[:5]}")
    subset = {}
    for k, v in variables.items():
        if k in own:
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch for {k}: model {tuple(own[k].shape)} vs {tuple(v.shape)}")
            subset[k] = v
    model.load_state_dict(subset, strict=False)


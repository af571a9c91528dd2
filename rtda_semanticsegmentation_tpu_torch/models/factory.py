"""Model construction, seeded initialization and weight loading.

Port of the JAX ``models/factory.py``: BiSeNet (ResNet-18 or ResNet-101
context path), DeepLabV2 and the FC-Discriminator; and SegFormer (MiT
encoder, all-MLP head), which the JAX package lacks. A model's "variables" in
the port are its ``state_dict``; ``models/convert.py`` maps them to and from
the JAX package's flat keys. :func:`build_model`, :func:`build_discriminator`
and :func:`load_variables` each run in a ``setup.build`` span
(``obs/spans.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from ..config import ModelConfig
from ..obs.spans import setup_span
from .bisenet import BiSeNet
from .convert import QUANT_FROZEN, QUANT_STATS
from .deeplabv2 import DeepLabV2
from .discriminator import FCDiscriminator
from .layers import Conv, LayerNorm, Linear, QuantPolicy
from .segformer import SegFormer

MODELS = ("bisenet", "deeplabv2", "segformer")


def build_model(cfg: ModelConfig, device="cuda", train: bool = False,
                fused_conv3: bool = False) -> torch.nn.Module:
    """The generator named by ``cfg.name``, with uninitialized parameters,
    on ``device``.

    ``cfg.quant``: ``none``, ``calib``, ``int8`` or ``int8_frozen`` (set by
    ``models/quantize.py``). ``train`` builds the train tree (with the aux
    supervision heads) in train mode; otherwise the eval tree in eval
    mode. ``fused_conv3`` (bf16 eval, ``quant='none'``) runs the 3x3 /
    stride-1 ConvBNs on K4; it is an argument and not a ``ModelConfig``
    field, as ``fused_conv1`` is one of :func:`build_discriminator`, because
    the JAX package has no such field. Load weights with
    :func:`load_variables`, then fold them into K4's operands with
    ``layers.fold_kernel_operands``. ``cfg.fast_input`` builds the same
    model: the JAX package's phase-conv stems compute the plain stems'
    function."""
    with setup_span("setup.build"):
        return _build_model(cfg, device, train, fused_conv3)


def _build_model(cfg: ModelConfig, device, train: bool, fused_conv3: bool) -> torch.nn.Module:
    if cfg.name not in MODELS:
        raise ValueError(f"unknown model {cfg.name!r}; options: {', '.join(MODELS)}")
    if cfg.quant not in ("none", "calib", "int8", "int8_frozen"):
        raise ValueError(f"unknown quant mode {cfg.quant!r} (none, calib, int8, int8_frozen)")
    if cfg.name == "segformer" and (cfg.quant != "none" or fused_conv3):
        raise ValueError("segformer runs in float only: int8 (K3) and fused_conv3 (K4) are ResNet ConvBN paths "
                         f"(got quant={cfg.quant!r}, fused_conv3={fused_conv3})")
    quant = QuantPolicy(cfg.quant, cfg.quant_min_ch, cfg.quant_clip, tuple(cfg.quant_skip))
    if train and cfg.quant != "none":
        raise ValueError("training runs quant='none'")
    if train and fused_conv3:
        raise ValueError("fused_conv3 is an eval path: K4 has no backward")
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.name == "deeplabv2":
        model = DeepLabV2(cfg.num_classes, dtype=dtype, quant=quant, fused_conv3=fused_conv3)
    elif cfg.name == "segformer":
        model = SegFormer(cfg.num_classes, embed_dims=cfg.mit_embed_dims, depths=cfg.mit_depths,
                          num_heads=cfg.mit_num_heads, sr_ratios=cfg.mit_sr_ratios, mlp_ratio=cfg.mit_mlp_ratio,
                          decoder_dim=cfg.decoder_dim, dtype=dtype)
    else:
        model = BiSeNet(cfg.num_classes, cfg.context_path, dtype=dtype, quant=quant,
                        aux_heads=train, fused_conv3=fused_conv3)
    return model.to(device).train(train)


@torch.no_grad()
def init_model(model: torch.nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill every conv kernel from ``generator`` (a CPU generator, so a seed
    gives the same weights on any device) as the JAX initializers draw it:
    Kaiming normal, fan-out in the ResNet and fan-in elsewhere, or N(0, std)
    where the conv's ``init`` is a float (DeepLabV2's ASPP, 0.01); conv
    biases with zeros; BatchNorm starts at identity. SegFormer's as
    published: ``Linear`` weights N(0, 0.02) and zero biases, LayerNorms at
    1 and 0, convs Kaiming fan-out (over the groups). Returns the model's
    variables (its ``state_dict``)."""
    for module in model.modules():
        if isinstance(module, Conv):
            o, i, kh, kw = module.weight.shape
            if isinstance(module.init, float):
                std = module.init
            else:
                fan = i if module.init == "fan_in" else o // module.groups
                std = math.sqrt(2.0 / (fan * kh * kw))
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * std)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, Linear):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * module.init)
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model.state_dict()


def build_discriminator(cfg: ModelConfig, device="cuda", fused_conv1: bool = False) -> FCDiscriminator:
    """The FC-Discriminator for ``cfg`` (``num_classes`` in, ``disc_ndf``
    wide, computing in ``compute_dtype``) on ``device``, with uninitialized
    parameters. ``fused_conv1`` is the JAX module's field of that name: the
    first conv on the 4x4/s2 kernels K5a-c."""
    with setup_span("setup.build"):
        return FCDiscriminator(cfg.num_classes, cfg.disc_ndf, dtype=getattr(torch, cfg.compute_dtype),
                               fused_conv1=fused_conv1).to(device)


@torch.no_grad()
def init_discriminator(model: torch.nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill every kernel with N(0, 0.02) draws from ``generator`` (a CPU
    generator) and every bias with zeros, the JAX package's
    ``normal_init(0.02)``. Returns the model's state_dict."""
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        else:
            p.zero_()
    return model.state_dict()


# BiSeNet's aux supervision heads: in the train tree only
AUX_HEADS = ("supervision1", "supervision2")


def eval_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A train model's variables without the aux heads, as an eval model
    (``build_model(..., train=False)``) takes them."""
    return {k: v for k, v in state.items() if k.split(".", 1)[0] not in AUX_HEADS}


def _is_quant(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in QUANT_STATS + QUANT_FROZEN


def load_variables(model: torch.nn.Module, variables: Mapping[str, torch.Tensor]) -> None:
    """Load ``variables`` into ``model`` as a JAX ``apply`` would read them.

    Every parameter, BatchNorm statistic and frozen int8 constant the model
    has must be given, with its shape. Quantization statistics the model
    lacks are ignored (a float model ignores the quant collections) and
    those it has but ``variables`` lacks keep their zero init (calibration
    starts from zeros)."""
    with setup_span("setup.build"):
        _load_variables(model, variables)


def _load_variables(model: torch.nn.Module, variables: Mapping[str, torch.Tensor]) -> None:
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


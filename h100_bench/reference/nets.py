"""The reference's networks as functions of a dict of tensors, found by the
configuration's model name.

:func:`param_shapes` lists every tensor a generator holds, by the port's
``state_dict`` name, from the architecture alone; :func:`generator` runs
it on such a dict. Both are lookups of the module :func:`arch` finds,
``reference/archs/<model["name"]>.py``, which gives:

- ``param_shapes(model, train)``: ``[(name, shape), ...]``, the aux
  heads too when ``train``;
- ``generator(P, stats, train, x, model, momentum)``: logits (B, classes,
  H, W) of NCHW float ``x``; ``stats`` holds the running statistics, read
  in eval and moved by ``momentum`` in train;
- ``OPTIMIZER_SKIPS``: name prefixes of the leaves the generator's
  optimizer leaves out (heads the step's loss does not reach);
- ``init_rule(name, shape)``: None where the tensor is drawn from the
  seed, else the value it starts at (``lib/weights.py``);
  :func:`default_init` is the rule of convolutional networks.

A new architecture is a new file there. This module keeps what several
share: the ResNet trunk (He et al., arXiv:1512.03385; plain or dilated as
DeepLabV2's), conv + BatchNorm blocks, and the FC-Discriminator (Tsai et
al., CVPR 2018, arXiv:1802.10349).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100_bench.lib import spec

from .ops import batch_norm

conv = F.conv2d

Shapes = List[Tuple[str, Tuple[int, ...]]]
_DEPTHS = {18: (2, 2, 2, 2), 101: (3, 4, 23, 3)}
_WIDTHS = (64, 128, 256, 512)


def arch(model: dict):
    """The module ``reference/archs/<model["name"]>.py``; a missing file
    raises FileNotFoundError naming it."""
    return spec.arch(model["name"])


def param_shapes(model: dict, train: bool = False) -> Shapes:
    """Every tensor of the generator ``model`` (the configuration file's
    ``model`` group), with its aux heads when ``train``."""
    return arch(model).param_shapes(model, train)


def generator(model: dict, P: Dict[str, torch.Tensor], x: torch.Tensor, train: bool, stats: dict,
              momentum: float = 0.9) -> torch.Tensor:
    """Logits (B, classes, H, W) of NCHW float ``x``. ``stats`` holds the
    running statistics: read in eval, moved by ``momentum`` in train."""
    return arch(model).generator(P, stats, train, x, model, momentum)


def default_init(name: str, shape: Tuple[int, ...]) -> Optional[float]:
    """Kernels (4-D) drawn; BatchNorm scales and running variances 1;
    biases, BatchNorm shifts and running means 0. Any other tensor has no
    rule here: its architecture states one."""
    if len(shape) == 4:
        return None
    if name.endswith(("bn.weight", "running_var")):
        return 1.0
    if name.endswith(("bias", "running_mean")):
        return 0.0
    raise ValueError(f"no init rule for {name} {shape}: its architecture's init_rule must state one")


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# --- shapes ------------------------------------------------------------------


def add_convbn(out: Shapes, name, cin, cout, k):
    out.append((f"{name}.conv.weight", (cout, cin, k, k)))
    add_bn(out, f"{name}.bn", cout)


def add_bn(out: Shapes, name, c):
    for t in ("weight", "bias", "running_mean", "running_var"):
        out.append((f"{name}.{t}", (c,)))


def add_conv(out: Shapes, name, cin, cout, k, bias=True):
    out.append((f"{name}.weight", (cout, cin, k, k)))
    if bias:
        out.append((f"{name}.bias", (cout,)))


def _stages(deeplab: bool):
    """(stride, dilation) of the four stages: output stride 32, or 8 with
    dilated stages 3 and 4."""
    return ((1, 1), (2, 1), (1, 2), (1, 4)) if deeplab else ((1, 1), (2, 1), (2, 1), (2, 1))


def _blocks(depth: int, deeplab: bool):
    """(name, cin, filters, stride, dilation, projection) of every block."""
    cin = 64
    for s, (num, (stride, dil)) in enumerate(zip(_DEPTHS[depth], _stages(deeplab))):
        f = _WIDTHS[s]
        cout = f if depth == 18 else 4 * f
        for i in range(num):
            st = stride if i == 0 else 1
            proj = st != 1 or cin != cout or (deeplab and i == 0 and dil > 1)
            yield f"layer{s + 1}_{i}", cin, f, st, dil, proj
            cin = cout


def resnet_shapes(out: Shapes, prefix, depth, deeplab):
    add_convbn(out, f"{prefix}.stem", 3, 64, 7)
    for name, cin, f, _, _, proj in _blocks(depth, deeplab):
        p = f"{prefix}.{name}"
        if depth == 18:
            add_convbn(out, f"{p}.conv1", cin, f, 3)
            add_convbn(out, f"{p}.conv2", f, f, 3)
            if proj:
                add_convbn(out, f"{p}.downsample", cin, f, 1)
        else:
            add_convbn(out, f"{p}.conv1", cin, f, 1)
            add_convbn(out, f"{p}.conv2", f, f, 3)
            add_convbn(out, f"{p}.conv3", f, 4 * f, 1)
            if proj:
                add_convbn(out, f"{p}.downsample", cin, 4 * f, 1)


def discriminator_shapes(model: dict) -> Shapes:
    ndf, k = model["disc_ndf"], model["num_classes"]
    widths = (k, ndf, 2 * ndf, 4 * ndf, 8 * ndf)
    out: Shapes = []
    for i in range(4):
        add_conv(out, f"conv{i + 1}", widths[i], widths[i + 1], 4)
    add_conv(out, "classifier", 8 * ndf, 1, 4)
    return out


# --- forward passes ----------------------------------------------------------


def cbr(P, stats, train, name, x, stride, padding, dilation=1, relu=True, momentum=0.9):
    """Conv (no bias), BatchNorm and, with ``relu``, ReLU."""
    y = conv(x, P[f"{name}.conv.weight"], None, stride, padding, dilation)
    y = batch_norm(y, P, f"{name}.bn", train, stats, momentum)
    return F.relu(y) if relu else y


def resnet(P, stats, train, prefix, x, depth, deeplab, momentum=0.9):
    """The trunk; returns the stage-3 and stage-4 features."""
    block = functools.partial(cbr, P, stats, train, momentum=momentum)
    x = block(f"{prefix}.stem", x, 2, 3)
    x = F.max_pool2d(x, 3, 2, 1, ceil_mode=deeplab)
    feats = {}
    for name, _, _, st, dil, proj in _blocks(depth, deeplab):
        p = f"{prefix}.{name}"
        if depth == 18:
            y = block(f"{p}.conv1", x, st, 1)
            y = block(f"{p}.conv2", y, 1, 1, relu=False)
        else:
            s1, s2 = (st, 1) if deeplab else (1, st)
            y = block(f"{p}.conv1", x, s1, 0)
            y = block(f"{p}.conv2", y, s2, dil, dil)
            y = block(f"{p}.conv3", y, 1, 0, relu=False)
        res = block(f"{p}.downsample", x, st, 0, relu=False) if proj else x
        x = F.relu(y + res)
        feats[name.split("_")[0]] = x
    return feats["layer3"], feats["layer4"]


def discriminator(P: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Five 4x4 / stride-2 convs with LeakyReLU(0.2) between them."""
    for i in range(4):
        x = F.leaky_relu(conv(x, P[f"conv{i + 1}.weight"], P[f"conv{i + 1}.bias"], 2, 1), 0.2)
    return conv(x, P["classifier.weight"], P["classifier.bias"], 2, 1)

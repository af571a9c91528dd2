"""BiSeNet (Yu et al., ECCV 2018, arXiv:1808.00897), DeepLabV2 (Chen et al.,
arXiv:1606.00915) and the FC-Discriminator (Tsai et al., CVPR 2018,
arXiv:1802.10349) as functions of a dict of tensors.

:func:`param_shapes` lists every tensor a model holds, by the port's
``state_dict`` name, from the architecture alone; :func:`generator` and
:func:`discriminator` run the models on such a dict. Departures from the
papers, all shared with the system under test: BiSeNet's ``final_conv``
runs at 1/8 before the x8 upsample (a 1x1 conv and a bilinear resize
commute); DeepLabV2's trunk is the caffe-style dilated ResNet-101 (stride
on the first 1x1 conv, a projection on the first block of each dilated
stage, a ceil-mode stem pool) with ASPP branches summed.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .ops import batch_norm, gap, upsample

conv = F.conv2d

Shapes = List[Tuple[str, Tuple[int, ...]]]
_DEPTHS = {18: (2, 2, 2, 2), 101: (3, 4, 23, 3)}
_WIDTHS = (64, 128, 256, 512)
ASPP_DILATIONS = (6, 12, 18, 24)


def _stages(deeplab: bool):
    """(stride, dilation) of the four stages: output stride 32, or 8 with
    dilated stages 3 and 4."""
    return ((1, 1), (2, 1), (1, 2), (1, 4)) if deeplab else ((1, 1), (2, 1), (2, 1), (2, 1))


def _convbn(out: Shapes, name, cin, cout, k):
    out.append((f"{name}.conv.weight", (cout, cin, k, k)))
    for t in ("weight", "bias", "running_mean", "running_var"):
        out.append((f"{name}.bn.{t}", (cout,)))


def _conv(out: Shapes, name, cin, cout, k, bias=True):
    out.append((f"{name}.weight", (cout, cin, k, k)))
    if bias:
        out.append((f"{name}.bias", (cout,)))


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


def _resnet_shapes(out: Shapes, prefix, depth, deeplab):
    _convbn(out, f"{prefix}.stem", 3, 64, 7)
    for name, cin, f, _, _, proj in _blocks(depth, deeplab):
        p = f"{prefix}.{name}"
        if depth == 18:
            _convbn(out, f"{p}.conv1", cin, f, 3)
            _convbn(out, f"{p}.conv2", f, f, 3)
            if proj:
                _convbn(out, f"{p}.downsample", cin, f, 1)
        else:
            _convbn(out, f"{p}.conv1", cin, f, 1)
            _convbn(out, f"{p}.conv2", f, f, 3)
            _convbn(out, f"{p}.conv3", f, 4 * f, 1)
            if proj:
                _convbn(out, f"{p}.downsample", cin, 4 * f, 1)


def _depth(model: dict) -> int:
    return {"resnet18": 18, "resnet101": 101}[model["context_path"]] if model["name"] == "bisenet" else 101


def param_shapes(model: dict, train: bool = False) -> Shapes:
    """Every tensor of the generator ``model`` (the configuration file's
    ``model`` group): BiSeNet with its aux heads when ``train``, or
    DeepLabV2."""
    out: Shapes = []
    k = model["num_classes"]
    if model["name"] == "deeplabv2":
        _resnet_shapes(out, "resnet", 101, True)
        for i in range(len(ASPP_DILATIONS)):
            _conv(out, f"aspp.branch{i}", 2048, k, 3)
        return out
    depth = _depth(model)
    for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256))):
        _convbn(out, f"spatial_path.convblock{i + 1}", cin, cout, 3)
    _resnet_shapes(out, "context_path.resnet", depth, False)
    c4 = 512 if depth == 18 else 2048
    c3 = c4 // 2
    for name, c in (("arm1", c3), ("arm2", c4)):
        _conv(out, f"{name}.conv", c, c, 1)
        for t in ("weight", "bias", "running_mean", "running_var"):
            out.append((f"{name}.bn.{t}", (c,)))
    _convbn(out, "ffm.convblock", 256 + c3 + c4, k, 3)
    _conv(out, "ffm.conv1", k, k, 1)
    _conv(out, "ffm.conv2", k, k, 1)
    _conv(out, "final_conv", k, k, 1)
    if train:
        _conv(out, "supervision1", c3, k, 1)
        _conv(out, "supervision2", c4, k, 1)
    return out


def discriminator_shapes(model: dict) -> Shapes:
    ndf, k = model["disc_ndf"], model["num_classes"]
    widths = (k, ndf, 2 * ndf, 4 * ndf, 8 * ndf)
    out: Shapes = []
    for i in range(4):
        _conv(out, f"conv{i + 1}", widths[i], widths[i + 1], 4)
    _conv(out, "classifier", 8 * ndf, 1, 4)
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# --- forward passes ----------------------------------------------------------


def _cbr(P, stats, train, name, x, stride, padding, dilation=1, relu=True, momentum=0.9):
    y = conv(x, P[f"{name}.conv.weight"], None, stride, padding, dilation)
    y = batch_norm(y, P, f"{name}.bn", train, stats, momentum)
    return F.relu(y) if relu else y


def resnet(P, stats, train, prefix, x, depth, deeplab, momentum=0.9):
    """The trunk; returns the stage-3 and stage-4 features."""
    cbr = functools.partial(_cbr, P, stats, train, momentum=momentum)
    x = cbr(f"{prefix}.stem", x, 2, 3)
    x = F.max_pool2d(x, 3, 2, 1, ceil_mode=deeplab)
    feats = {}
    for name, _, _, st, dil, proj in _blocks(depth, deeplab):
        p = f"{prefix}.{name}"
        if depth == 18:
            y = cbr(f"{p}.conv1", x, st, 1)
            y = cbr(f"{p}.conv2", y, 1, 1, relu=False)
        else:
            s1, s2 = (st, 1) if deeplab else (1, st)
            y = cbr(f"{p}.conv1", x, s1, 0)
            y = cbr(f"{p}.conv2", y, s2, dil, dil)
            y = cbr(f"{p}.conv3", y, 1, 0, relu=False)
        res = cbr(f"{p}.downsample", x, st, 0, relu=False) if proj else x
        x = F.relu(y + res)
        feats[name.split("_")[0]] = x
    return feats["layer3"], feats["layer4"]


def _bisenet(P, stats, train, x, depth, momentum):
    h, w = x.shape[2:]
    cbr = functools.partial(_cbr, P, stats, train, momentum=momentum)
    sx = x
    for i in range(3):
        sx = cbr(f"spatial_path.convblock{i + 1}", sx, 2, 1)
    c3, c4 = resnet(P, stats, train, "context_path.resnet", x, depth, False, momentum)
    tail = gap(c4)

    def arm(name, f):
        g = conv(gap(f), P[f"{name}.conv.weight"], P[f"{name}.conv.bias"])
        g = batch_norm(g, P, f"{name}.bn", train, stats, momentum)
        return f * torch.sigmoid(g)

    cx1, cx2 = arm("arm1", c3), arm("arm2", c4) * tail
    size = sx.shape[2:]
    feat = cbr("ffm.convblock", torch.cat([sx, upsample(cx1, size), upsample(cx2, size)], 1), 1, 1)
    g = F.relu(conv(gap(feat), P["ffm.conv1.weight"], P["ffm.conv1.bias"]))
    g = torch.sigmoid(conv(g, P["ffm.conv2.weight"], P["ffm.conv2.bias"]))
    feat = feat * g + feat
    return upsample(conv(feat, P["final_conv.weight"], P["final_conv.bias"]), (h, w))


def _deeplabv2(P, stats, train, x, momentum):
    h, w = x.shape[2:]
    _, c4 = resnet(P, stats, train, "resnet", x, 101, True, momentum)
    out = None
    for i, d in enumerate(ASPP_DILATIONS):
        y = conv(c4, P[f"aspp.branch{i}.weight"], P[f"aspp.branch{i}.bias"], 1, d, d)
        out = y if out is None else out + y
    return upsample(out, (h, w))


def generator(model: dict, P: Dict[str, torch.Tensor], x: torch.Tensor, train: bool, stats: dict,
              momentum: float = 0.9) -> torch.Tensor:
    """Logits (B, classes, H, W) of NCHW float ``x``. ``stats`` holds the
    running statistics: read in eval, moved by ``momentum`` in train."""
    if model["name"] == "deeplabv2":
        return _deeplabv2(P, stats, train, x, momentum)
    return _bisenet(P, stats, train, x, _depth(model), momentum)


def discriminator(P: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Five 4x4 / stride-2 convs with LeakyReLU(0.2) between them."""
    for i in range(4):
        x = F.leaky_relu(conv(x, P[f"conv{i + 1}.weight"], P[f"conv{i + 1}.bias"], 2, 1), 0.2)
    return conv(x, P["classifier.weight"], P["classifier.bias"], 2, 1)

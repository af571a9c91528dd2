"""BiSeNet (Yu et al., ECCV 2018, arXiv:1808.00897) with a ResNet-18 or
ResNet-101 context path (``model["context_path"]``).

A departure from the paper, shared with the system under test:
``final_conv`` runs at 1/8 before the x8 upsample (a 1x1 conv and a
bilinear resize commute). The aux heads ``supervision1`` and
``supervision2`` exist in train but no loss of the benchmark's step reads
them, so the optimizer leaves them out.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from h100_bench.reference.nets import (Shapes, add_bn, add_conv, add_convbn, cbr, conv, default_init, resnet,
                                       resnet_shapes)
from h100_bench.reference.ops import batch_norm, gap, upsample

OPTIMIZER_SKIPS = ("supervision1.", "supervision2.")
init_rule = default_init


def _depth(model: dict) -> int:
    return {"resnet18": 18, "resnet101": 101}[model["context_path"]]


def param_shapes(model: dict, train: bool = False) -> Shapes:
    out: Shapes = []
    k = model["num_classes"]
    depth = _depth(model)
    for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256))):
        add_convbn(out, f"spatial_path.convblock{i + 1}", cin, cout, 3)
    resnet_shapes(out, "context_path.resnet", depth, False)
    c4 = 512 if depth == 18 else 2048
    c3 = c4 // 2
    for name, c in (("arm1", c3), ("arm2", c4)):
        add_conv(out, f"{name}.conv", c, c, 1)
        add_bn(out, f"{name}.bn", c)
    add_convbn(out, "ffm.convblock", 256 + c3 + c4, k, 3)
    add_conv(out, "ffm.conv1", k, k, 1)
    add_conv(out, "ffm.conv2", k, k, 1)
    add_conv(out, "final_conv", k, k, 1)
    if train:
        add_conv(out, "supervision1", c3, k, 1)
        add_conv(out, "supervision2", c4, k, 1)
    return out


def generator(P, stats, train, x, model, momentum=0.9):
    h, w = x.shape[2:]
    block = functools.partial(cbr, P, stats, train, momentum=momentum)
    sx = x
    for i in range(3):
        sx = block(f"spatial_path.convblock{i + 1}", sx, 2, 1)
    c3, c4 = resnet(P, stats, train, "context_path.resnet", x, _depth(model), False, momentum)
    tail = gap(c4)

    def arm(name, f):
        g = conv(gap(f), P[f"{name}.conv.weight"], P[f"{name}.conv.bias"])
        g = batch_norm(g, P, f"{name}.bn", train, stats, momentum)
        return f * torch.sigmoid(g)

    cx1, cx2 = arm("arm1", c3), arm("arm2", c4) * tail
    size = sx.shape[2:]
    feat = block("ffm.convblock", torch.cat([sx, upsample(cx1, size), upsample(cx2, size)], 1), 1, 1)
    g = F.relu(conv(gap(feat), P["ffm.conv1.weight"], P["ffm.conv1.bias"]))
    g = torch.sigmoid(conv(g, P["ffm.conv2.weight"], P["ffm.conv2.bias"]))
    feat = feat * g + feat
    return upsample(conv(feat, P["final_conv.weight"], P["final_conv.bias"]), (h, w))

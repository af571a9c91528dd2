"""DeepLabV2 (Chen et al., arXiv:1606.00915): a dilated ResNet-101 at
output stride 8 and ASPP at rates 6, 12, 18 and 24, its branches summed.

The trunk is the caffe-style one the system under test builds (stride on
the first 1x1 conv, a projection on the first block of each dilated
stage, a ceil-mode stem pool). It has no aux heads; which of its
BatchNorm affines train is the configuration's ``freeze_bn``.
"""

from __future__ import annotations

from h100_bench.reference.nets import Shapes, add_conv, conv, default_init, resnet, resnet_shapes
from h100_bench.reference.ops import upsample

ASPP_DILATIONS = (6, 12, 18, 24)
OPTIMIZER_SKIPS = ()
init_rule = default_init


def param_shapes(model: dict, train: bool = False) -> Shapes:
    out: Shapes = []
    resnet_shapes(out, "resnet", 101, True)
    for i in range(len(ASPP_DILATIONS)):
        add_conv(out, f"aspp.branch{i}", 2048, model["num_classes"], 3)
    return out


def generator(P, stats, train, x, model, momentum=0.9):
    h, w = x.shape[2:]
    _, c4 = resnet(P, stats, train, "resnet", x, 101, True, momentum)
    out = None
    for i, d in enumerate(ASPP_DILATIONS):
        y = conv(c4, P[f"aspp.branch{i}.weight"], P[f"aspp.branch{i}.bias"], 1, d, d)
        out = y if out is None else out + y
    return upsample(out, (h, w))

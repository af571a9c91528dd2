"""DeepLabV2 (port of the JAX ``models/deeplabv2.py``).

The dilated caffe-style ResNet-101 of ``models/resnet.py`` (output stride 8,
ceil-mode stem pool) and an ASPP head: four parallel biased 3x3 convs at
dilations 6, 12, 18 and 24 on the stage-4 feature, summed in the compute
dtype, then a bilinear resize of the logits to the input size. The head's
kernels are drawn from N(0, 0.01), its biases start at zero. Module names
are the flax ones (``resnet``, ``aspp``, ``branch0`` ..). ``fused_conv3``
runs the trunk's 3x3 convs (dilated ones included) on K4; ``quant`` makes
the trunk's wide ConvBNs int8 (K3, dilated ones included), as the JAX
model passes its ``quant*`` fields to ``ResNetFeatures``. The ASPP
branches stay float ``F.conv2d`` either way (the JAX ASPP is ``nn.Conv``).
DeepLabV2's frozen BatchNorm affines are the optimizer's business
(``train/optim.py::build_generator_tx(freeze_bn=True)``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv, QuantPolicy, resize_bilinear
from .resnet import ResNetFeatures


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: the sum of parallel dilated 3x3 convs."""

    def __init__(self, in_ch, num_classes=19, dilations=(6, 12, 18, 24), *, dtype=torch.float32):
        super().__init__()
        for i, d in enumerate(dilations):
            setattr(self, f"branch{i}", Conv(in_ch, num_classes, 3, 1, d, dilation=d, bias=True,
                                             dtype=dtype, init=0.01))

    def forward(self, x):
        out = None
        for branch in self.children():
            y = branch(x)
            out = y if out is None else out + y
        return out


class DeepLabV2(nn.Module):
    """``forward(x)`` takes NCHW float input and returns NCHW logits at the
    input size; ``upsample=False`` (eval only) returns the 1/8 logits. In
    train mode it returns ``(logits, None, None)``, BiSeNet's signature;
    ``aux`` is that signature's too, and the model has no aux heads."""

    def __init__(self, num_classes=19, *, dtype=torch.float32, quant=QuantPolicy(), fused_conv3=False):
        super().__init__()
        self.resnet = ResNetFeatures(101, output_stride=8, deeplab_style=True, dtype=dtype, quant=quant,
                                     path="resnet", fused_conv3=fused_conv3)
        self.aspp = ASPP(self.resnet.channels[1], num_classes, dtype=dtype)

    def forward(self, x, upsample: bool = True, aux: bool = False):
        h, w = x.shape[2], x.shape[3]
        _, c4 = self.resnet(x)
        logits = self.aspp(c4)
        if not self.training and not upsample:
            return logits
        logits = resize_bilinear(logits, (h, w))
        return (logits, None, None) if self.training else logits

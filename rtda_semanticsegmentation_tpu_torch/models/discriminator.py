"""FC-Discriminator for output-space adversarial adaptation (port of the JAX
``models/discriminator.py``).

Five 4x4 / stride-2 / pad-1 convs, num_classes -> ndf -> 2 ndf -> 4 ndf ->
8 ndf -> 1, with LeakyReLU(0.2) between them. Input: a softmax probability
map (B, num_classes, H, W); output: a patch logit map (B, 1, H/32, W/32).
Parameters are f32 and the convs compute in ``dtype``. Module names
(``conv1`` .. ``conv4``, ``classifier``) mirror the flax tree, so
``models/convert.py`` maps the weights.

``fused_conv1`` routes the first conv (19 input channels at full
resolution) through the 4x4/s2 kernels K5a-c (``kernels/conv4x4.py``), as
the JAX package's ``fused_conv1`` routes it through its Pallas kernels.
The default stays False, as in the JAX package, which chose it from its
own TPU measurements; a D built either way has the same parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.conv4x4 import fused_conv4x4s2p1
from .layers import Conv


class _Conv4x4s2(nn.Module):
    """The first conv: 4x4/s2/p1 with its bias added after the conv, in the
    output dtype. With ``fused`` and an even H and W (the JAX shape gate) it
    runs the fused kernels, whose operands round to bf16 and whose sums are
    f32; otherwise ``F.conv2d`` in ``dtype``."""

    def __init__(self, in_ch, out_ch, *, dtype=torch.float32, fused=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 4, 4))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.dtype, self.fused = dtype, fused

    def forward(self, x):
        x = x.to(self.dtype)
        if self.fused and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            y = fused_conv4x4s2p1(x.contiguous(), self.weight, self.dtype)
        else:
            y = F.conv2d(x, self.weight.to(self.dtype), None, 2, 1)
        return y + self.bias.to(y.dtype).view(1, -1, 1, 1)


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes=19, ndf=64, *, dtype=torch.float32, fused_conv1=False):
        super().__init__()
        widths = (ndf, ndf * 2, ndf * 4, ndf * 8)
        self.conv1 = _Conv4x4s2(num_classes, ndf, dtype=dtype, fused=fused_conv1)
        for i in range(1, 4):
            setattr(self, f"conv{i + 1}", Conv(widths[i - 1], widths[i], 4, 2, 1, dtype=dtype))
        self.classifier = Conv(widths[3], 1, 4, 2, 1, dtype=dtype)

    def forward(self, x):
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"conv{i + 1}")(x), 0.2)
        return self.classifier(x)

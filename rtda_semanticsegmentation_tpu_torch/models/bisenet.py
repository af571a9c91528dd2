"""BiSeNet eval forward (port of the JAX ``models/bisenet.py``).

Spatial path (3x stride-2 ConvBN, 3->64->128->256 at 1/8), ResNet-18
context path, two attention refinement modules, the feature fusion module
and the 1x1 ``final_conv``, which runs at 1/8 before the x8 bilinear
upsample (a 1x1 conv and a bilinear resize commute exactly). The aux heads
exist only in training and are absent here, as in the JAX eval tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, ConvBN, FoldableBatchNorm, QuantPolicy, global_avg_pool, resize_bilinear
from .resnet import ContextPath


class SpatialPath(nn.Module):
    def __init__(self, *, dtype=torch.float32, quant=QuantPolicy(), path="spatial_path"):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256))):
            setattr(self, f"convblock{i + 1}",
                    ConvBN(cin, cout, dtype=dtype, quant=quant, path=f"{path}/convblock{i + 1}"))

    def forward(self, x):
        return self.convblock3(self.convblock2(self.convblock1(x)))


class AttentionRefinementModule(nn.Module):
    """Channel attention: sigmoid(BN(conv1x1(GAP(x)))) * x, gate math in f32."""

    def __init__(self, features, *, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(features, features, 1, dtype=dtype)
        self.bn = FoldableBatchNorm(features)

    def forward(self, x):
        g = self.conv(global_avg_pool(x, keepdims=True))
        g = self.bn(g.to(torch.promote_types(g.dtype, torch.float32)))
        return x * torch.sigmoid(g).to(self.dtype)


class FeatureFusionModule(nn.Module):
    """Fuse spatial + context features with an SE-style residual gate."""

    def __init__(self, in_ch, num_classes, *, dtype=torch.float32, quant=QuantPolicy(), path="ffm"):
        super().__init__()
        self.dtype = dtype
        self.convblock = ConvBN(in_ch, num_classes, 3, 1, 1, dtype=dtype, quant=quant,
                                path=f"{path}/convblock")
        self.conv1 = Conv(num_classes, num_classes, 1, dtype=dtype)
        self.conv2 = Conv(num_classes, num_classes, 1, dtype=dtype)

    def forward(self, sx, cx):
        feature = self.convblock(torch.cat([sx, cx], dim=1))
        g = F.relu(self.conv1(global_avg_pool(feature, keepdims=True)))
        g = torch.sigmoid(self.conv2(g)).to(self.dtype)
        return feature * g + feature


class BiSeNet(nn.Module):
    """``forward(x)`` takes NCHW float input and returns NCHW logits."""

    def __init__(self, num_classes=19, context_path="resnet18", *, dtype=torch.float32,
                 quant=QuantPolicy()):
        super().__init__()
        if context_path != "resnet18":
            raise NotImplementedError(
                f"context path {context_path!r} is not ported yet (only resnet18)"
            )
        self.spatial_path = SpatialPath(dtype=dtype, quant=quant)
        self.context_path = ContextPath(18, dtype=dtype, quant=quant)
        self.arm1 = AttentionRefinementModule(256, dtype=dtype)
        self.arm2 = AttentionRefinementModule(512, dtype=dtype)
        self.ffm = FeatureFusionModule(256 + 256 + 512, num_classes, dtype=dtype, quant=quant)
        self.final_conv = Conv(num_classes, num_classes, 1, dtype=dtype)

    def forward(self, x, upsample: bool = True):
        h, w = x.shape[2], x.shape[3]
        sx = self.spatial_path(x)
        cx1, cx2, tail = self.context_path(x)
        cx1 = self.arm1(cx1)
        cx2 = self.arm2(cx2) * tail.to(cx2.dtype)
        target = (sx.shape[2], sx.shape[3])
        cx = torch.cat([resize_bilinear(cx1, target), resize_bilinear(cx2, target)], dim=1)
        result = self.final_conv(self.ffm(sx, cx))
        if not upsample:
            return result
        return resize_bilinear(result, (h, w))

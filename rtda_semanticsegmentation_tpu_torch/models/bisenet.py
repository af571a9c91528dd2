"""BiSeNet (port of the JAX ``models/bisenet.py``).

Spatial path (3x stride-2 ConvBN, 3->64->128->256 at 1/8), ResNet-18 or
ResNet-101 context path, two attention refinement modules (as wide as the
context features: 256/512 or 1024/2048), the feature fusion module
and the 1x1 ``final_conv``, which runs at 1/8 before the x8 bilinear
upsample (a 1x1 conv and a bilinear resize commute exactly). The aux
supervision heads (``supervision1``/``supervision2``, 1x1 convs on the two
refined context features) exist only in a model built for training, as in
the JAX train tree. ``fused_conv3`` runs the context path's 3x3 / stride-1
ConvBNs and the FFM's ``convblock`` on K4 (``models/layers.py::ConvBN``).
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

    def __init__(self, in_ch, num_classes, *, dtype=torch.float32, quant=QuantPolicy(), path="ffm",
                 fused_conv3=False):
        super().__init__()
        self.dtype = dtype
        self.convblock = ConvBN(in_ch, num_classes, 3, 1, 1, dtype=dtype, quant=quant,
                                path=f"{path}/convblock", fused_conv3=fused_conv3)
        self.conv1 = Conv(num_classes, num_classes, 1, dtype=dtype)
        self.conv2 = Conv(num_classes, num_classes, 1, dtype=dtype)

    def forward(self, sx, cx):
        feature = self.convblock(torch.cat([sx, cx], dim=1))
        g = F.relu(self.conv1(global_avg_pool(feature, keepdims=True)))
        g = torch.sigmoid(self.conv2(g)).to(self.dtype)
        return feature * g + feature


class BiSeNet(nn.Module):
    """``forward(x)`` takes NCHW float input and returns NCHW logits in eval
    mode, ``(logits, sup1, sup2)`` in train mode (``self.training``)."""

    def __init__(self, num_classes=19, context_path="resnet18", *, dtype=torch.float32,
                 quant=QuantPolicy(), aux_heads=False, fused_conv3=False):
        super().__init__()
        depths = {"resnet18": 18, "resnet101": 101}
        if context_path not in depths:
            raise ValueError(f"unknown context path {context_path!r}; options: resnet18, resnet101")
        self.spatial_path = SpatialPath(dtype=dtype, quant=quant)
        self.context_path = ContextPath(depths[context_path], dtype=dtype, quant=quant,
                                        fused_conv3=fused_conv3)
        c3, c4 = self.context_path.resnet.channels
        self.arm1 = AttentionRefinementModule(c3, dtype=dtype)
        self.arm2 = AttentionRefinementModule(c4, dtype=dtype)
        self.ffm = FeatureFusionModule(256 + c3 + c4, num_classes, dtype=dtype, quant=quant,
                                       fused_conv3=fused_conv3)
        self.final_conv = Conv(num_classes, num_classes, 1, dtype=dtype)
        if aux_heads:  # registered last: a seed draws the same weights as for eval
            self.supervision1 = Conv(c3, num_classes, 1, dtype=dtype)
            self.supervision2 = Conv(c4, num_classes, 1, dtype=dtype)

    def forward(self, x, upsample: bool = True, aux: bool = True):
        """``upsample=False`` (eval only) returns the 1/8 logits. In train
        mode the aux heads are computed, upsampled to the input size, only
        when ``aux`` is set (an aux loss weight of 0 needs none; the JAX
        package's compiler drops them); otherwise ``sup1``/``sup2`` are
        None."""
        h, w = x.shape[2], x.shape[3]
        sx = self.spatial_path(x)
        cx1, cx2, tail = self.context_path(x)
        cx1 = self.arm1(cx1)
        cx2 = self.arm2(cx2) * tail.to(cx2.dtype)
        target = (sx.shape[2], sx.shape[3])
        cx1, cx2 = resize_bilinear(cx1, target), resize_bilinear(cx2, target)
        sups = (None, None)
        if self.training and aux:
            sups = (resize_bilinear(self.supervision1(cx1), (h, w)),
                    resize_bilinear(self.supervision2(cx2), (h, w)))
        result = self.final_conv(self.ffm(sx, torch.cat([cx1, cx2], dim=1)))
        if not self.training and not upsample:
            return result
        result = resize_bilinear(result, (h, w))
        return (result, *sups) if self.training else result

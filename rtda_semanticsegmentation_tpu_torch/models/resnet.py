"""ResNet-18 context path (port of the JAX ``models/resnet.py``, depth 18).

torchvision BasicBlocks [2, 2, 2, 2] at output stride 32, returning the
stage-3 and stage-4 features; :class:`ContextPath` adds BiSeNet's
global-average tail. Module names are the flax ones (``resnet``, ``stem``,
``layer3_0``, ``conv1``, ``downsample``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBN, QuantPolicy, global_avg_pool, max_pool_torch

_STAGE_FILTERS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """Two 3x3 ConvBNs plus an identity or 1x1 projection residual."""

    def __init__(self, in_ch, filters, strides=1, *, dtype=torch.float32,
                 quant=QuantPolicy(), path=""):
        super().__init__()
        self.dtype = dtype
        q = dict(dtype=dtype, init="fan_out", quant=quant)
        self.conv1 = ConvBN(in_ch, filters, 3, strides, 1, path=f"{path}/conv1", **q)
        self.conv2 = ConvBN(filters, filters, 3, 1, 1, use_relu=False,
                            path=f"{path}/conv2", **q)
        self.downsample = None
        if strides != 1 or in_ch != filters:
            self.downsample = ConvBN(in_ch, filters, 1, strides, 0, use_relu=False,
                                     path=f"{path}/downsample", **q)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual).to(self.dtype)


class ResNetFeatures(nn.Module):
    """ResNet trunk (depth 18 only in this port) emitting (c3, c4)."""

    def __init__(self, depth=18, *, dtype=torch.float32, quant=QuantPolicy(), path="resnet"):
        super().__init__()
        if depth != 18:
            raise NotImplementedError(
                f"resnet depth {depth} is not ported yet (only 18; Bottleneck/R101 come later)"
            )
        self.stem = ConvBN(3, 64, 7, 2, 3, dtype=dtype, init="fan_out",
                           quant=quant, path=f"{path}/stem")
        in_ch = 64
        for stage, filters in enumerate(_STAGE_FILTERS):
            for i in range(2):
                name = f"layer{stage + 1}_{i}"
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, name, BasicBlock(in_ch, filters, stride, dtype=dtype,
                                               quant=quant, path=f"{path}/{name}"))
                in_ch = filters

    def forward(self, x):
        x = max_pool_torch(self.stem(x), 3, 2, 1)
        feats = []
        for stage in range(4):
            for i in range(2):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
            feats.append(x)
        return feats[2], feats[3]


class ContextPath(nn.Module):
    """ResNet features + global-average tail: (c3 @1/16, c4 @1/32, tail)."""

    def __init__(self, depth=18, *, dtype=torch.float32, quant=QuantPolicy(),
                 path="context_path"):
        super().__init__()
        self.resnet = ResNetFeatures(depth, dtype=dtype, quant=quant, path=f"{path}/resnet")

    def forward(self, x):
        c3, c4 = self.resnet(x)
        return c3, c4, global_avg_pool(c4, keepdims=True)

"""ResNet trunks (port of the JAX ``models/resnet.py``).

One implementation serves two consumers, as in the JAX package:

- BiSeNet's context path: torchvision ResNet-18 (BasicBlocks [2, 2, 2, 2])
  or ResNet-101 (Bottlenecks [3, 4, 23, 3], stride on the 3x3 conv) at
  output stride 32, returning the stage-3 and stage-4 features;
  :class:`ContextPath` adds the global-average tail;
- DeepLabV2's dilated ResNet-101 (``deeplab_style``): stride on the first
  1x1 conv, layer3 at stride 1 dilation 2 and layer4 at stride 1 dilation 4
  (output stride 8), a projection shortcut on the first block of each
  dilated stage, and a ceil-mode stem pool.

Module names are the flax ones (``resnet``, ``stem``, ``layer3_0``,
``conv1``, ``downsample``). ``fused_conv3`` reaches every ConvBN; the 3x3 /
stride-1 ones run on K4 (``models/layers.py::ConvBN``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBN, QuantPolicy, global_avg_pool, max_pool_torch

_STAGE_FILTERS = (64, 128, 256, 512)
_DEPTHS = {18: (2, 2, 2, 2), 101: (3, 4, 23, 3)}


class BasicBlock(nn.Module):
    """Two 3x3 ConvBNs plus an identity or 1x1 projection residual."""

    expansion = 1

    def __init__(self, in_ch, filters, strides=1, *, dtype=torch.float32,
                 quant=QuantPolicy(), path="", fused_conv3=False):
        super().__init__()
        self.dtype = dtype
        q = dict(dtype=dtype, init="fan_out", quant=quant, fused_conv3=fused_conv3)
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


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (dilated) -> 1x1 (x4 expand) plus a residual.

    ``stride_on_first`` puts the stride on the first 1x1 conv (caffe /
    DeepLab) instead of the 3x3 (torchvision v1.5); ``force_downsample``
    gives the block a projection shortcut even where the shapes match (the
    first block of DeepLab's dilated stages)."""

    expansion = 4

    def __init__(self, in_ch, filters, strides=1, *, dilation=1, stride_on_first=False,
                 force_downsample=False, dtype=torch.float32, quant=QuantPolicy(), path="",
                 fused_conv3=False):
        super().__init__()
        self.dtype = dtype
        q = dict(dtype=dtype, init="fan_out", quant=quant, fused_conv3=fused_conv3)
        s1, s2 = (strides, 1) if stride_on_first else (1, strides)
        out_ch = filters * 4
        d = dilation
        self.conv1 = ConvBN(in_ch, filters, 1, s1, 0, path=f"{path}/conv1", **q)
        self.conv2 = ConvBN(filters, filters, 3, s2, d, dilation=d, path=f"{path}/conv2", **q)
        self.conv3 = ConvBN(filters, out_ch, 1, 1, 0, use_relu=False, path=f"{path}/conv3", **q)
        self.downsample = None
        if strides != 1 or in_ch != out_ch or force_downsample:
            self.downsample = ConvBN(in_ch, out_ch, 1, strides, 0, use_relu=False,
                                     path=f"{path}/downsample", **q)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual).to(self.dtype)


class ResNetFeatures(nn.Module):
    """ResNet trunk emitting (c3, c4), the stage-3 and stage-4 features.

    ``depth`` 18 (BasicBlock) or 101 (Bottleneck); ``output_stride`` 32
    (torchvision strides) or 8 (layer3 stride 1 dilation 2, layer4 stride 1
    dilation 4, Bottleneck only); ``deeplab_style`` as in the module
    docstring. ``channels`` is the widths of (c3, c4)."""

    def __init__(self, depth=18, *, output_stride=32, deeplab_style=False, dtype=torch.float32,
                 quant=QuantPolicy(), path="resnet", fused_conv3=False):
        super().__init__()
        if depth not in _DEPTHS:
            raise ValueError(f"unsupported resnet depth {depth} (18 or 101)")
        if depth == 18 and output_stride != 32:
            raise ValueError(f"output_stride={output_stride} needs dilated stages, "
                             "which only the Bottleneck (depth>=50) blocks implement")
        stage_cfg = {32: ((1, 1), (2, 1), (2, 1), (2, 1)), 8: ((1, 1), (2, 1), (1, 2), (1, 4))}
        if output_stride not in stage_cfg:
            raise ValueError(f"unsupported output_stride {output_stride} (32 or 8)")
        self.deeplab_style = deeplab_style
        self.blocks = _DEPTHS[depth]
        self.stem = ConvBN(3, 64, 7, 2, 3, dtype=dtype, init="fan_out",
                           quant=quant, path=f"{path}/stem")
        in_ch = 64
        for stage, (num, (stride, dilation)) in enumerate(zip(self.blocks, stage_cfg[output_stride])):
            filters = _STAGE_FILTERS[stage]
            for i in range(num):
                name = f"layer{stage + 1}_{i}"
                kw = dict(dtype=dtype, quant=quant, path=f"{path}/{name}", fused_conv3=fused_conv3)
                strides = stride if i == 0 else 1
                if depth == 18:
                    block = BasicBlock(in_ch, filters, strides, **kw)
                else:
                    block = Bottleneck(in_ch, filters, strides, dilation=dilation,
                                       stride_on_first=deeplab_style,
                                       force_downsample=deeplab_style and i == 0 and dilation > 1, **kw)
                setattr(self, name, block)
                in_ch = filters * block.expansion
        self.channels = (in_ch // 2, in_ch)

    def forward(self, x):
        x = max_pool_torch(self.stem(x), 3, 2, 1, ceil_mode=self.deeplab_style)
        feats = []
        for stage, num in enumerate(self.blocks):
            for i in range(num):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
            feats.append(x)
        return feats[2], feats[3]


class ContextPath(nn.Module):
    """ResNet features + global-average tail: (c3 @1/16, c4 @1/32, tail)."""

    def __init__(self, depth=18, *, dtype=torch.float32, quant=QuantPolicy(),
                 path="context_path", fused_conv3=False):
        super().__init__()
        self.resnet = ResNetFeatures(depth, dtype=dtype, quant=quant, path=f"{path}/resnet",
                                     fused_conv3=fused_conv3)

    def forward(self, x):
        c3, c4 = self.resnet(x)
        return c3, c4, global_avg_pool(c4, keepdims=True)

"""Shared NCHW building blocks, eval form (port of the JAX ``models/layers.py``).

Conventions, as in the JAX package: parameters are f32 and convs compute in
the model's compute dtype; BatchNorm statistics fold into a per-channel
scale/shift in f32 that is applied in the activation dtype. Activations are
NCHW tensors, kept in ``channels_last`` memory on the GPU by the serving
path, so the int8 kernel's NHWC view of them is free.

Module and tensor names mirror the flax tree (``conv``, ``bn``, ``scale`` ->
``weight``, ``mean`` -> ``running_mean`` ...), see ``models/convert.py``.
Parameters are created empty; ``models/factory.py::init_model`` fills them
from an explicit generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import calib_clip_channels, int8_conv_unsigned


@dataclass(frozen=True)
class QuantPolicy:
    """Which convs run int8 and how (``ModelConfig.quant*``)."""

    mode: str = "none"  # none | calib | int8_frozen
    min_ch: int = 128
    clip: float = 1.0
    skip: Tuple[str, ...] = ()

    def applies(self, path: str, in_ch: int) -> bool:
        return (
            self.mode != "none"
            and in_ch >= self.min_ch
            and not any(pat in path for pat in self.skip)
        )


class Conv(nn.Module):
    """``flax.linen.Conv`` counterpart: f32 params, compute in ``dtype``.

    ``init`` names the Kaiming-normal fan mode the factory draws the
    kernel with (``fan_in`` or ``fan_out``); biases start at zero."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 bias=True, dtype=torch.float32, init="fan_in"):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride, self.padding, self.dtype, self.init = stride, padding, dtype, init

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class QuantConv(Conv):
    """Bias-free conv on the int8 serving path (JAX ``QuantConv``).

    - ``calib``: records the per-input-channel clip statistic (max-merged)
      and the running mean of the input into ``in_absmax`` / ``in_mean`` /
      ``calib_batches``, then runs the compute-dtype conv.
    - ``int8_frozen``: quantizes the input on the unsigned grid and runs the
      s8 kernel against the frozen constants. ``wq`` / ``sw`` / ``c`` are the
      JAX package's ``quant_frozen`` tensors; ``a`` / ``b`` fold the
      following BatchNorm into the kernel's epilogue
      (``models/quantize.py::freeze``), and the epilogue also applies the
      ConvBN's ReLU, so the kernel's output is the whole ConvBN's.
    """

    def __init__(self, in_ch, out_ch, kernel_size, stride, padding, *,
                 mode, relu, dtype=torch.float32, init="fan_in", clip=1.0):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         bias=False, dtype=dtype, init=init)
        if mode not in ("calib", "int8_frozen"):
            raise ValueError(f"unknown QuantConv mode {mode!r}")
        self.mode, self.relu, self.clip = mode, relu, clip
        self.register_buffer("in_absmax", torch.zeros(in_ch))
        self.register_buffer("in_mean", torch.zeros(in_ch))
        self.register_buffer("calib_batches", torch.zeros(()))
        if mode == "int8_frozen":
            k = kernel_size
            self.register_buffer("wq", torch.zeros(k, k, in_ch, out_ch, dtype=torch.int8))
            self.register_buffer("sw", torch.ones(out_ch))
            self.register_buffer("c", torch.zeros(out_ch))
            self.register_buffer("a", torch.ones(out_ch))
            self.register_buffer("b", torch.zeros(out_ch))

    @torch.no_grad()
    def _record(self, x_nhwc):
        self.in_absmax.copy_(
            torch.maximum(self.in_absmax, calib_clip_channels(x_nhwc, self.clip))
        )
        bmean = x_nhwc.float().mean(dim=(0, 1, 2))
        n = self.calib_batches
        self.in_mean.copy_((self.in_mean * n + bmean) / (n + 1.0))
        self.calib_batches.add_(1.0)

    def forward(self, x):
        x_nhwc = x.permute(0, 2, 3, 1)
        if self.mode == "calib":
            self._record(x_nhwc)
            return super().forward(x)
        y = int8_conv_unsigned(
            x_nhwc, self.wq, self.a, self.b, self.in_absmax,
            stride=self.stride, padding=self.padding, relu=self.relu,
            out_dtype=self.dtype,
        )
        return y.permute(0, 3, 1, 2)


def fold_batch_norm(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as a per-channel f32 ``(scale, shift)`` pair."""
    inv = scale * torch.rsqrt(var + eps)
    return inv, bias - mean * inv


class FoldableBatchNorm(nn.Module):
    """Eval-form BatchNorm: running statistics and affine fold into a
    per-channel scale/shift in f32, applied in the input dtype."""

    def __init__(self, ch, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        inv, shift = fold_batch_norm(
            self.weight, self.bias, self.running_mean, self.running_var, self.eps
        )
        return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm -> optional ReLU, cast to ``dtype``.

    The conv is a :class:`QuantConv` when ``quant`` selects this conv by its
    flax path (``path``, e.g. ``context_path/resnet/layer3_0/conv1``) and
    input width, as ``layers.py::ConvBN`` decides it."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=2, padding=1, *,
                 use_relu=True, dtype=torch.float32, init="fan_in",
                 quant: QuantPolicy = QuantPolicy(), path: str = ""):
        super().__init__()
        self.use_relu, self.dtype = use_relu, dtype
        if quant.applies(path, in_ch):
            self.conv = QuantConv(in_ch, out_ch, kernel_size, stride, padding,
                                  mode=quant.mode, relu=use_relu, dtype=dtype,
                                  init=init, clip=quant.clip)
        else:
            self.conv = Conv(in_ch, out_ch, kernel_size, stride, padding,
                             bias=False, dtype=dtype, init=init)
        self.bn = FoldableBatchNorm(out_ch)

    def forward(self, x):
        if getattr(self.conv, "mode", None) == "int8_frozen":
            return self.conv(x)  # BN and ReLU run in the kernel's epilogue
        x = self.bn(self.conv(x))
        if self.use_relu:
            x = F.relu(x)
        return x.to(self.dtype)


def max_pool_torch(x, window: int, strides: int, padding: int, ceil_mode: bool = False):
    """Max pool with torch semantics (the JAX package emulates exactly this,
    including the rule that drops a ceil-mode window starting in the pad)."""
    return F.max_pool2d(x, window, strides, padding, ceil_mode=ceil_mode)


def global_avg_pool(x, keepdims: bool = True):
    """Mean over H, W in at least f32, cast back to the input dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc).mean(dim=(2, 3), keepdim=keepdims).to(x.dtype)


def resize_bilinear(x, size: Tuple[int, int]):
    """Bilinear resize with half-pixel centres, in the input dtype.

    Equals ``jax.image.resize(..., "bilinear")`` only when upsampling (JAX
    antialiases a downsample), which every call site does; a downsample
    raises."""
    if size[0] < x.shape[2] or size[1] < x.shape[3]:
        raise ValueError(f"resize_bilinear only upsamples: {tuple(x.shape[2:])} -> {tuple(size)}")
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)

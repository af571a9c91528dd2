"""Shared NCHW building blocks (port of the JAX ``models/layers.py``).

Conventions, as in the JAX package: parameters are f32 and convs compute in
the model's compute dtype; BatchNorm (running statistics in eval, batch
statistics in train) becomes a per-channel scale/shift computed in f32 and
applied in the activation dtype. Activations are
NCHW tensors, kept in ``channels_last`` memory on the GPU by the serving
path, so the int8 kernel's NHWC view of them is free.

Module and tensor names mirror the flax tree (``conv``, ``bn``, ``scale`` ->
``weight``, ``mean`` -> ``running_mean`` ...), see ``models/convert.py``.
Parameters are created empty; ``models/factory.py::init_model`` fills them
from an explicit generator.

``fused_conv3`` (bf16 eval only) runs every 3x3 / stride-1 ConvBN with
padding = dilation on the hand-written K4 (``kernels/conv3x3.py``), its
BatchNorm folded into the kernel's scale / shift and its ReLU fused; the
folded constants are non-persistent buffers that
:func:`fold_kernel_operands` fills once the weights are loaded. It also
fills each frozen ``QuantConv``'s copy of its weights in the layout K3
reads (K-major, with their column sums).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import conv3x3 as _k4
from ..kernels.int8_conv import kmajor_weights
from ..ops.quant import calib_clip_channels, fold_bn_epilogue, freeze_weights, int8_conv_unsigned


@dataclass(frozen=True)
class QuantPolicy:
    """Which convs run int8 and how (``ModelConfig.quant*``)."""

    mode: str = "none"  # none | calib | int8 | int8_frozen
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

    ``init`` says how the factory draws the kernel: ``fan_in`` or
    ``fan_out`` (Kaiming normal with that fan mode), or a float, the
    standard deviation of a zero-mean normal; biases start at zero."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, *, dilation=1,
                 bias=True, dtype=torch.float32, init="fan_in"):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype, self.init = dtype, init

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, self.dilation)


class QuantConv(Conv):
    """Bias-free conv on the int8 serving path (JAX ``QuantConv``).

    - ``calib``: records the per-input-channel clip statistic (max-merged)
      and the running mean of the input into ``in_absmax`` / ``in_mean`` /
      ``calib_batches``, then runs the compute-dtype conv.
    - ``int8``: on each forward, computes the frozen constants from the f32
      weight, the calibrated statistics and the following BatchNorm (``bn``,
      passed by the ConvBN) as :func:`models.quantize.freeze` does, in the
      same expressions, then runs the s8 kernel as ``int8_frozen`` does: the
      two modes give the same bits. K3's K-major weights are made per call.
    - ``int8_frozen``: quantizes the input on the unsigned grid and runs the
      s8 kernel against the frozen constants. ``wq`` / ``sw`` / ``c`` are the
      JAX package's ``quant_frozen`` tensors; ``a`` / ``b`` fold the
      following BatchNorm into the kernel's epilogue
      (``models/quantize.py::freeze``), and the epilogue also applies the
      ConvBN's ReLU, so the kernel's output is the whole ConvBN's.
      ``k3_weight`` / ``k3_colsum`` (non-persistent, :meth:`fold`) are
      ``wq`` in the layout K3 reads; without them each call makes its own.
      A forward after ``wq`` was written or replaced since the fold raises
      instead of serving the old weights (eagerly; a trace cannot read the
      storage, so ``serving.export_serving`` runs :meth:`check_fold` first).

    Every mode runs the conv at its ``dilation``.
    """

    def __init__(self, in_ch, out_ch, kernel_size, stride, padding, *,
                 mode, relu, dilation=1, dtype=torch.float32, init="fan_in", clip=1.0):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, dilation=dilation,
                         bias=False, dtype=dtype, init=init)
        if mode not in ("calib", "int8", "int8_frozen"):
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
            self.register_buffer("k3_weight", None, persistent=False)
            self.register_buffer("k3_colsum", None, persistent=False)
            self._k3_source = None  # wq's (storage, version) at the fold

    def _wq_state(self):
        return self.wq.data_ptr(), self.wq._version

    @torch.no_grad()
    def fold(self) -> None:
        """Fill K3's weight operands from the loaded ``wq``."""
        self.k3_weight, self.k3_colsum = kmajor_weights(self.wq)
        self._k3_source = self._wq_state()

    def check_fold(self) -> None:
        """Raise if ``wq`` was written or replaced since :meth:`fold`."""
        if self.k3_weight is not None and self._wq_state() != self._k3_source:
            raise RuntimeError("wq changed after layers.fold_kernel_operands(model); call it again")

    @torch.no_grad()
    def _record(self, x_nhwc):
        self.in_absmax.copy_(
            torch.maximum(self.in_absmax, calib_clip_channels(x_nhwc, self.clip))
        )
        bmean = x_nhwc.float().mean(dim=(0, 1, 2))
        n = self.calib_batches
        self.in_mean.copy_((self.in_mean * n + bmean) / (n + 1.0))
        self.calib_batches.add_(1.0)

    def forward(self, x, bn=None):
        x_nhwc = x.permute(0, 2, 3, 1)
        if self.mode == "calib":
            self._record(x_nhwc)
            return super().forward(x)
        kmajor = None
        if self.mode == "int8":
            if bn is None:
                raise ValueError("the int8 mode folds the following BatchNorm: call it through its ConvBN")
            wq, sw, c = freeze_weights(self.weight.permute(2, 3, 1, 0), self.in_absmax, self.in_mean)
            wq = wq.contiguous()
            scale, shift = fold_batch_norm(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            a, b = fold_bn_epilogue(sw, c, scale, shift)
        else:
            # a trace (torch.export) has no storage to read: export_serving
            # checks the fold eagerly before it traces
            if not torch.compiler.is_compiling():
                self.check_fold()
            wq, a, b = self.wq, self.a, self.b
            if self.k3_weight is not None:
                kmajor = (self.k3_weight, self.k3_colsum)
        y = int8_conv_unsigned(
            x_nhwc, wq, a, b, self.in_absmax,
            stride=self.stride, padding=self.padding, dilation=self.dilation, relu=self.relu,
            out_dtype=self.dtype, kmajor=kmajor,
        )
        return y.permute(0, 3, 1, 2)


def fold_batch_norm(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as a per-channel f32 ``(scale, shift)`` pair."""
    inv = scale * torch.rsqrt(var + eps)
    return inv, bias - mean * inv


class FoldableBatchNorm(nn.Module):
    """BatchNorm applied as a per-channel ``x * mul + add`` in the input
    dtype, with ``mul`` and ``add`` computed in at least f32.

    - Eval: from the running statistics and the affine parameters.
    - Train (``self.training``), as the JAX ``FoldableBatchNorm`` and not as
      ``nn.BatchNorm2d`` (which rounds bf16 and computes the variance
      differently): batch ``mean = E[x]`` and ``var = E[x^2] - mean^2``
      over (N, H, W) in at least f32; the running statistics move with
      flax momentum 0.9 (torch 0.1) and track the unbiased variance,
      ``var * n / (n - 1)``. A gate BN over (B, C, 1, 1) reduces over the
      batch only (n = B). Inside :func:`running_stats_held` the running
      statistics stay as they are.
    """

    def __init__(self, ch, eps=1e-5, momentum=0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if not self.training:
            mul, add = fold_batch_norm(
                self.weight, self.bias, self.running_mean, self.running_var, self.eps
            )
        else:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
            n = x.numel() // x.shape[1]
            if self.update_running_stats:
                self._update_running_stats(mean, var, n)
            mul = self.weight * torch.rsqrt(var + self.eps)
            add = self.bias - mean * mul
        return x * mul.to(x.dtype).view(1, -1, 1, 1) + add.to(x.dtype).view(1, -1, 1, 1)

    @torch.no_grad()
    def _update_running_stats(self, mean, var, n: int) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var * (n / max(n - 1, 1)))


@contextlib.contextmanager
def running_stats_held(model: nn.Module):
    """Train-mode BatchNorms of ``model`` that leave their running statistics
    as they are: the recompute of a checkpointed forward (``train.remat``)
    must not move them a second time."""
    bns = [m for m in model.modules() if isinstance(m, FoldableBatchNorm)]
    for m in bns:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_running_stats = True


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm -> optional ReLU, cast to ``dtype``.

    The conv is a :class:`QuantConv` when ``quant`` selects this conv by its
    flax path (``path``, e.g. ``context_path/resnet/layer3_0/conv1``) and
    input width, as ``layers.py::ConvBN`` decides it.

    With ``fused_conv3`` a 3x3 / stride-1 conv with padding = dilation runs
    on K4 with the BatchNorm and ReLU in its epilogue (``self.fused``); any
    other conv of the model stays on ``F.conv2d``. The option needs bf16
    compute (K4 rounds its operands to bf16), no quantization, and eval
    mode."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=2, padding=1, *,
                 dilation=1, use_relu=True, dtype=torch.float32, init="fan_in",
                 quant: QuantPolicy = QuantPolicy(), path: str = "", fused_conv3=False):
        super().__init__()
        self.use_relu, self.dtype = use_relu, dtype
        if fused_conv3 and dtype != torch.bfloat16:
            raise ValueError(f"fused_conv3 needs bf16 compute (K4 rounds its operands to bf16), got {dtype}")
        if fused_conv3 and quant.mode != "none":
            raise ValueError("fused_conv3 and int8 quantization exclude each other")
        if quant.applies(path, in_ch):
            self.conv = QuantConv(in_ch, out_ch, kernel_size, stride, padding,
                                  mode=quant.mode, relu=use_relu, dilation=dilation, dtype=dtype,
                                  init=init, clip=quant.clip)
        else:
            self.conv = Conv(in_ch, out_ch, kernel_size, stride, padding, dilation=dilation,
                             bias=False, dtype=dtype, init=init)
        self.bn = FoldableBatchNorm(out_ch)
        self.fused = fused_conv3 and kernel_size == 3 and stride == 1 and padding == dilation
        if self.fused:
            # K4's operands: bf16 HWIO weights with CO padded to a multiple
            # of 8, and the folded BatchNorm (fold())
            self.register_buffer("k4_weight", None, persistent=False)
            self.register_buffer("k4_scale", None, persistent=False)
            self.register_buffer("k4_shift", None, persistent=False)

    @torch.no_grad()
    def fold(self) -> None:
        """Fill K4's operands from the current weights and BatchNorm."""
        bn = self.bn
        scale, shift = fold_batch_norm(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        w = self.conv.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
        self.k4_weight = F.pad(w, (0, -w.shape[3] % 8)).to(torch.bfloat16).contiguous()
        self.k4_scale, self.k4_shift = scale.float().contiguous(), shift.float().contiguous()

    def forward(self, x):
        if self.fused:
            if self.training:
                raise RuntimeError("fused_conv3 is an eval path: K4 has no backward")
            if self.k4_weight is None:
                raise RuntimeError("call layers.fold_kernel_operands(model) after loading the weights")
            co = self.k4_scale.shape[0]
            y = _k4.conv3x3(x.permute(0, 2, 3, 1), self.k4_weight[..., :co], self.k4_scale,
                            self.k4_shift, relu=self.use_relu, dilation=self.conv.dilation,
                            out_dtype=self.dtype)
            return y.permute(0, 3, 1, 2)
        mode = getattr(self.conv, "mode", None)
        if mode == "int8_frozen":
            return self.conv(x)  # BN and ReLU run in the kernel's epilogue
        if mode == "int8":
            return self.conv(x, self.bn)
        x = self.bn(self.conv(x))
        if self.use_relu:
            x = F.relu(x)
        return x.to(self.dtype)


def fold_kernel_operands(model: nn.Module) -> None:
    """Fold the BatchNorm of every K4 ConvBN of ``model`` into its kernel
    operands and lay out every frozen QuantConv's weights for K3; call it
    once the weights are loaded (``serving.py`` does)."""
    for m in model.modules():
        if (isinstance(m, ConvBN) and m.fused) or (isinstance(m, QuantConv) and m.mode == "int8_frozen"):
            m.fold()


def check_kernel_operands(model: nn.Module) -> None:
    """Raise if a frozen QuantConv's ``wq`` changed since
    :func:`fold_kernel_operands`; the check a forward makes, run eagerly
    before a trace."""
    for m in model.modules():
        if isinstance(m, QuantConv) and m.mode == "int8_frozen":
            m.check_fold()


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

"""int8 post-training quantization primitives for the serving path.

Port of ``rtda_semanticsegmentation_tpu/ops/quant.py`` (its module docstring
describes the scheme): per-input-channel activation scales on the unsigned
grid (zero point at code -127), folded exactly into a per-output-channel
quantized kernel, with the ``127 * sum(wq)`` zero-point term and the
weight-rounding bias correction precomputed by :func:`freeze_weights`.

Layouts follow the JAX package: activations are channels-last (NHWC) and
kernels HWIO, so the tests hold both packages to the same arrays. The model
(NCHW, ``channels_last`` memory) permutes to NHWC for free.
"""

from __future__ import annotations

from typing import Tuple

import torch

# called through its module, so a caller can swap in the plain version
from ..kernels import int8_conv as _k3
from ..kernels.int8_conv import pad_zero_code  # noqa: F401  (the zero-code pad)

_EPS = 1e-12


def weight_scales(kernel: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scale of an HWIO kernel, (co,) f32."""
    absmax = kernel.float().abs().amax(dim=(0, 1, 2))
    return torch.clamp_min(absmax, _EPS) / 127.0


def quantize_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s8 HWIO kernel, per-output-channel scale (co,) f32)."""
    sw = weight_scales(kernel)
    q = torch.round(kernel.float() / sw)
    return torch.clamp(q, -127, 127).to(torch.int8), sw


def calib_clip_channels(
    x: torch.Tensor, q: float, max_samples: int = 1 << 20
) -> torch.Tensor:
    """Per-input-channel calibration clip statistic of NHWC ``x``: (ci,) f32.

    ``q >= 1`` is the exact per-channel max|x|. ``q < 1`` is the per-channel
    q-quantile (linear interpolation, as ``jnp.quantile``) over every
    ``step``-th pixel of the (P, C) view, the same pixels the JAX package
    samples."""
    c = x.shape[-1]
    a = x.float().abs().reshape(-1, c)
    if q >= 1.0:
        return a.amax(dim=0)
    step = max(1, a.shape[0] // max(1, max_samples // c))
    return torch.quantile(a[::step], q, dim=0)


def act_scale(absmax: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Activation scale(s) from the calibrated clip statistic."""
    denom = 254.0 if unsigned else 127.0
    return torch.clamp_min(absmax.float(), _EPS) / denom


def freeze_weights(
    kernel: torch.Tensor, in_absmax: torch.Tensor, in_mean: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unsigned-path serving constants ``(wq s8 HWIO, sw (co,), c (co,))``
    such that the conv is ``conv_s8(xq, wq) * sw + c``: the channel fold, the
    weight quantization, the ``127 * sum(wq)`` zero-point term and the
    weight-rounding bias correction, computed once."""
    sx = act_scale(in_absmax, unsigned=True)
    folded = kernel.float() * (sx if sx.dim() == 0 else sx.view(1, 1, -1, 1))
    wq, sw = quantize_weight(folded)
    w_err = folded - wq.float() * sw
    r_mean = torch.broadcast_to(in_mean.float() / sx, (kernel.shape[2],))
    bias_corr = torch.einsum("hwio,i->o", w_err, r_mean)
    zp = 127.0 * wq.float().sum(dim=(0, 1, 2))
    return wq, sw, zp * sw + bias_corr


def quantize_act_unsigned(x: torch.Tensor, in_absmax: torch.Tensor) -> torch.Tensor:
    """Values (channels last) -> s8 codes on the unsigned grid,
    ``clip(round(x / s) - 127, -127, 127)`` with ``s = max|x| / 254``."""
    sx = act_scale(in_absmax, unsigned=True)
    q = torch.round(x.float() / sx) - 127.0
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_conv_unsigned(
    x: torch.Tensor,
    wq: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    in_absmax: torch.Tensor,
    *,
    stride: int,
    padding: int,
    relu: bool,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Unsigned int8 conv of NHWC ``x``: quantize the input, then the s8
    conv kernel (zero-code pad) with the epilogue ``acc * a + b`` and an
    optional ReLU. The serving path's ``QuantConv`` passes constants with
    the following BatchNorm folded in."""
    xq = quantize_act_unsigned(x, in_absmax).contiguous()
    return _k3.int8_conv(xq, wq, a, b, stride=stride, padding=padding, relu=relu,
                         out_dtype=out_dtype)


def int8_conv_frozen(
    x: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    c: torch.Tensor,
    in_absmax: torch.Tensor,
    strides,
    padding,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Unsigned int8 conv of NHWC ``x`` against :func:`freeze_weights`
    constants: :func:`int8_conv_unsigned` with the epilogue ``acc * sw + c``
    and no ReLU, taking the JAX package's stride and padding tuples."""
    (s0, s1), ((p0, p1), (p2, p3)) = strides, padding
    if s0 != s1 or len({p0, p1, p2, p3}) != 1:
        raise ValueError(f"int8 conv needs symmetric strides and padding, got {strides}, {padding}")
    return int8_conv_unsigned(x, wq, sw, c, in_absmax, stride=s0, padding=p0, relu=False,
                              out_dtype=out_dtype)

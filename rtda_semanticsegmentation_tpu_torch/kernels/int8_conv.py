"""s8 NHWC convolution with the int8 serving epilogue fused (CUDA kernel K3).

Counterpart of ``rtda_semanticsegmentation_tpu/ops/pallas_conv_int8.py::
int8_conv3x3s1p1``, generalised from 3x3/s1/p1 to the kernel shapes, strides
and dilations the quantized convs of BiSeNet (R18 and R101) and DeepLabV2
use (3x3/s1/p1, 3x3/s2/p1, 1x1 at stride 1 or 2, and DeepLabV2's 3x3 at
dilation 2 and 4 with padding = dilation):

    acc = conv(pad(xq, -127), wq, d)    s8 x s8 -> s32, zero-code padding
    z   = acc * a + b                   per output channel, f32
    z   = max(z, 0)                     if relu
    out = z in out_dtype, or clip(round(z * inv_out), 0, 254) - 127 as s8

:func:`int8_conv` takes the JAX package's layouts: NHWC s8 codes and HWIO s8
weights. A ``channels_last`` NCHW tensor permuted to NHWC is already
contiguous, so the model's permute costs nothing. On a CPU tensor it runs
:func:`int8_conv_plain`; on a CUDA tensor it launches the kernel in
``csrc/int8_conv.cu`` (built on first use, see :mod:`.build`) or raises.

The kernel's s8 tensor cores read the weights K-major only: it takes the
(CO, KH*KW, C) copy and the column sums that :func:`kmajor_weights` makes,
once per model (``QuantConv.fold``) or, from the HWIO ``wq``, for each call.
Its TMA loads zero-fill the border, and the epilogue restores the -127 pad
exactly (:func:`zero_code_border_correction`). TMA also needs C a multiple
of 16 and a 16-byte aligned ``xq``; :func:`launch_plan` says when the wrapper
first copies ``xq`` with channels of code 0 appended (zero weights face them).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .build import load_library

SOURCE = "csrc/int8_conv.cu"

# Launches of the CUDA kernel in this process; the plain version never counts.
launches = 0
# Operand copies the wrapper made before a launch: a padded xq (launch_plan)
# or the K-major weights of a call that was not given them.
copies = 0

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}
_S8 = 2
_lib = None


def out_size(n: int, k: int, stride: int, padding: int, dilation: int) -> int:
    """Output length of a conv along one axis of length ``n``."""
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def _check(xq, wq, a, b, inv_out, stride, padding, dilation, relu, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv needs s8 codes and weights, got {xq.dtype}, {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"xq must be NHWC and wq HWIO, got {tuple(xq.shape)}, {tuple(wq.shape)}")
    kh, kw, ci, co = wq.shape
    if xq.shape[3] != ci:
        raise ValueError(f"xq has {xq.shape[3]} channels, wq expects {ci}")
    for name, v in (("a", a), ("b", b), ("inv_out", inv_out)):
        if v is None:
            continue
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError(f"{name} must be f32 of shape ({co},), got {v.dtype} {tuple(v.shape)}")
    if inv_out is not None and not relu:
        raise ValueError("requantized (s8) output requires relu=True")
    if inv_out is None and out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if stride < 1 or padding < 0 or dilation < 1:
        raise ValueError(f"bad stride/padding/dilation {stride}/{padding}/{dilation}")
    _, h, w, _ = xq.shape
    ho, wo = out_size(h, kh, stride, padding, dilation), out_size(w, kw, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for input {h}x{w}, kernel {kh}x{kw}")
    return ho, wo


def pad_zero_code(xq: torch.Tensor, padding: int) -> torch.Tensor:
    """Spatially pad NHWC s8 codes with the unsigned grid's zero code (-127).
    A zero pad would add ``127 * w`` to every edge pixel."""
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding), value=-127)
    return xq


def kmajor_weights(wq: torch.Tensor) -> tuple:
    """The kernel's weight operands from HWIO s8 ``wq`` (KH, KW, C, CO):
    ``wk`` (CO, KH*KW, C16) s8, the weights K-major with C zero-padded to a
    multiple of 16, and ``colsum`` (KH*KW, CO) s32, the column sums
    ``S[tap, co] = sum_c wq[kh, kw, c, co]`` of the border correction."""
    kh, kw, c, co = wq.shape
    wk = torch.zeros((co, kh * kw, -(-c // 16) * 16), device=wq.device, dtype=torch.int8)
    wk[..., :c] = wq.permute(3, 0, 1, 2).reshape(co, kh * kw, c)
    colsum = wq.to(torch.int32).sum(dim=2, dtype=torch.int32).reshape(kh * kw, co)
    return wk, colsum


def zero_code_border_correction(colsum: torch.Tensor, h: int, w: int, kh: int, kw: int,
                                stride: int, padding: int, dilation: int = 1) -> torch.Tensor:
    """What the -127 pad adds to the s32 accumulator of a zero-padded conv,
    (HO, WO, CO) int64: ``-127 * sum of colsum[tap]`` over the taps whose
    input pixel ``(oh*stride - padding + kh*dilation, ow*stride - padding +
    kw*dilation)`` lies outside the h x w image. The kernel's epilogue adds
    the same sum."""
    ho, wo = out_size(h, kh, stride, padding, dilation), out_size(w, kw, stride, padding, dilation)
    ih = torch.arange(ho).view(1, ho) * stride - padding + dilation * torch.arange(kh).view(kh, 1)  # (KH, HO)
    iw = torch.arange(wo).view(1, wo) * stride - padding + dilation * torch.arange(kw).view(kw, 1)  # (KW, WO)
    row_out = (ih < 0) | (ih >= h)
    col_out = (iw < 0) | (iw >= w)
    outside = row_out.view(kh, 1, ho, 1) | col_out.view(1, kw, 1, wo)  # (KH, KW, HO, WO)
    sums = colsum.to(device="cpu", dtype=torch.int64).view(kh, kw, -1)
    return -127 * torch.einsum("abhw,abc->hwc", outside.to(torch.int64), sums)


def launch_plan(c: int, co: int, x_aligned: bool = True) -> tuple:
    """``(n_tile, copy_x)`` of a launch: the N tile is 24 for CO <= 24 (the
    FFM's 19), else 128; ``xq`` is copied unless C is a multiple of 16 and
    its base 16-byte aligned."""
    return (24 if co <= 24 else 128), c % 16 != 0 or not x_aligned


def int8_conv_plain(
    xq: torch.Tensor,
    wq: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    inv_out: Optional[torch.Tensor] = None,
    *,
    stride: int,
    padding: int,
    dilation: int = 1,
    relu: bool,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device.

    The s32 accumulator is computed exactly: a float64 conv on the codes
    pre-padded with -127, rounded to the nearest integer. Every partial sum
    is an integer far below 2**53, so whatever algorithm the backend picks
    the rounding recovers the exact sum. The epilogue rounds each f32
    operation separately, as the kernel does.
    """
    _check(xq, wq, a, b, inv_out, stride, padding, dilation, relu, out_dtype)
    x = pad_zero_code(xq, padding).permute(0, 3, 1, 2).to(torch.float64).contiguous()
    w = wq.permute(3, 2, 0, 1).to(torch.float64).contiguous()
    acc = torch.round(F.conv2d(x, w, stride=stride, dilation=dilation))
    z = acc.to(torch.float32) * a.view(1, -1, 1, 1)
    z = z + b.view(1, -1, 1, 1)
    if relu:
        z = torch.clamp_min(z, 0.0)
    if inv_out is not None:
        q = torch.round(z * inv_out.view(1, -1, 1, 1))
        out = (torch.clamp(q, 0.0, 254.0) - 127.0).to(torch.int8)
    else:
        out = z.to(out_dtype)
    return out.permute(0, 2, 3, 1).contiguous()


def int8_conv(
    xq: torch.Tensor,
    wq: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    inv_out: Optional[torch.Tensor] = None,
    *,
    stride: int,
    padding: int,
    dilation: int = 1,
    relu: bool,
    out_dtype: torch.dtype = torch.bfloat16,
    kmajor: Optional[tuple] = None,
) -> torch.Tensor:
    """(B,H,W,C) s8 codes * (KH,KW,C,CO) s8 -> (B,HO,WO,CO) ``out_dtype``,
    or s8 codes on the next conv's unsigned grid when ``inv_out`` is given
    (which requires ``relu``). ``kmajor`` is :func:`kmajor_weights` of
    ``wq``, made once by the caller; without it each call makes its own."""
    if xq.device.type == "cpu":
        return int8_conv_plain(
            xq, wq, a, b, inv_out,
            stride=stride, padding=padding, dilation=dilation, relu=relu, out_dtype=out_dtype,
        )
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on CPU or CUDA tensors, got {xq.device}")
    ho, wo = _check(xq, wq, a, b, inv_out, stride, padding, dilation, relu, out_dtype)
    tensors = [xq, wq, a, b] + ([inv_out] if inv_out is not None else [])
    for t in tensors:
        if t.device != xq.device:
            raise ValueError(f"all operands must be on {xq.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("int8_conv needs contiguous NHWC / HWIO operands")
    bsz, h, w, c = xq.shape
    if bsz * ho * wo >= 2**31:
        raise ValueError("too many output pixels for the kernel's 32-bit pixel index")
    kh, kw, _, co = wq.shape
    # the im2col map's traversal stride is at most 8 and its box corners,
    # -padding and padding - (k - 1) * dilation, are 8-bit
    if (kh != kw or kh * kw > 32 or stride > 8 or padding > 127 or dilation > 128
            or padding - (kh - 1) * dilation < -128):
        raise ValueError(f"int8_conv takes square kernels of up to 32 taps, stride <= 8, padding <= 127, "
                         f"dilation <= 128 and padding - (k - 1) * dilation >= -128, got {kh}x{kw}, "
                         f"stride {stride}, padding {padding}, dilation {dilation}")
    c16 = -(-c // 16) * 16
    n_tile, copy_x = launch_plan(c, co, xq.data_ptr() % 16 == 0)
    global copies
    if kmajor is None:
        kmajor = kmajor_weights(wq)
        copies += 1
    wk, colsum = kmajor
    if (tuple(wk.shape) != (co, kh * kw, c16) or wk.dtype != torch.int8 or tuple(colsum.shape) != (kh * kw, co)
            or colsum.dtype != torch.int32 or not wk.is_contiguous() or not colsum.is_contiguous()
            or wk.device != xq.device or colsum.device != xq.device or wk.data_ptr() % 16):
        raise ValueError("kmajor must be kmajor_weights(wq) on the same device")
    if copy_x:
        padded = torch.zeros((bsz, h, w, c16), device=xq.device, dtype=torch.int8)
        padded[..., :c] = xq
        xq = padded
        copies += 1
    kind = _S8 if inv_out is not None else _OUT_KIND[out_dtype]
    out = torch.empty(
        (bsz, ho, wo, co), device=xq.device,
        dtype=torch.int8 if inv_out is not None else out_dtype,
    )
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_conv_launch(
            xq.data_ptr(), wk.data_ptr(), colsum.data_ptr(), a.data_ptr(), b.data_ptr(),
            inv_out.data_ptr() if inv_out is not None else None, out.data_ptr(),
            bsz, h, w, c16, ho, wo, co, kh, kw, stride, padding, dilation, int(relu), kind, n_tile,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.int8_conv_launch.argtypes = [p] * 7 + [i] * 15 + [p]
        lib.int8_conv_launch.restype = i
        _lib = lib
    return _lib

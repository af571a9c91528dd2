"""s8 NHWC convolution with the int8 serving epilogue fused (CUDA kernel K3).

Counterpart of ``rtda_semanticsegmentation_tpu/ops/pallas_conv_int8.py::
int8_conv3x3s1p1``, generalised from 3x3/s1/p1 to the stride and kernel
shapes BiSeNet-R18's quantized convs use (3x3/s1/p1, 3x3/s2/p1, 1x1/s2/p0):

    acc = conv(pad(xq, -127), wq)       s8 x s8 -> s32, zero-code padding
    z   = acc * a + b                   per output channel, f32
    z   = max(z, 0)                     if relu
    out = z in out_dtype, or clip(round(z * inv_out), 0, 254) - 127 as s8

:func:`int8_conv` takes the JAX package's layouts: NHWC s8 codes and HWIO s8
weights. A ``channels_last`` NCHW tensor permuted to NHWC is already
contiguous, so the model's permute costs nothing. On a CPU tensor it runs
:func:`int8_conv_plain`; on a CUDA tensor it launches the kernel in
``csrc/int8_conv.cu`` (built on first use, see :mod:`.build`) or raises.
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

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}
_S8 = 2
_lib = None


def _check(xq, wq, a, b, inv_out, stride, padding, relu, out_dtype):
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
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride/padding {stride}/{padding}")
    _, h, w, _ = xq.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for input {h}x{w}, kernel {kh}x{kw}")
    return ho, wo


def pad_zero_code(xq: torch.Tensor, padding: int) -> torch.Tensor:
    """Spatially pad NHWC s8 codes with the unsigned grid's zero code (-127).
    A zero pad would add ``127 * w`` to every edge pixel."""
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding), value=-127)
    return xq


def int8_conv_plain(
    xq: torch.Tensor,
    wq: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    inv_out: Optional[torch.Tensor] = None,
    *,
    stride: int,
    padding: int,
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
    _check(xq, wq, a, b, inv_out, stride, padding, relu, out_dtype)
    x = pad_zero_code(xq, padding).permute(0, 3, 1, 2).to(torch.float64).contiguous()
    w = wq.permute(3, 2, 0, 1).to(torch.float64).contiguous()
    acc = torch.round(F.conv2d(x, w, stride=stride))
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
    relu: bool,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B,H,W,C) s8 codes * (KH,KW,C,CO) s8 -> (B,HO,WO,CO) ``out_dtype``,
    or s8 codes on the next conv's unsigned grid when ``inv_out`` is given
    (which requires ``relu``)."""
    if xq.device.type == "cpu":
        return int8_conv_plain(
            xq, wq, a, b, inv_out,
            stride=stride, padding=padding, relu=relu, out_dtype=out_dtype,
        )
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on CPU or CUDA tensors, got {xq.device}")
    ho, wo = _check(xq, wq, a, b, inv_out, stride, padding, relu, out_dtype)
    tensors = [xq, wq, a, b] + ([inv_out] if inv_out is not None else [])
    for t in tensors:
        if t.device != xq.device:
            raise ValueError(f"all operands must be on {xq.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("int8_conv needs contiguous NHWC / HWIO operands")
    if xq.data_ptr() % 4:
        raise ValueError("xq must be 4-byte aligned")
    bsz, h, w, c = xq.shape
    if bsz * ho * wo >= 2**31:
        raise ValueError("too many output pixels for the kernel's 32-bit pixel index")
    kh, kw, _, co = wq.shape
    kind = _S8 if inv_out is not None else _OUT_KIND[out_dtype]
    out = torch.empty(
        (bsz, ho, wo, co), device=xq.device,
        dtype=torch.int8 if inv_out is not None else out_dtype,
    )
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_conv_launch(
            xq.data_ptr(), wq.data_ptr(), a.data_ptr(), b.data_ptr(),
            inv_out.data_ptr() if inv_out is not None else None, out.data_ptr(),
            bsz, h, w, c, ho, wo, co, kh, kw, stride, padding, int(relu), kind,
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
        lib.int8_conv_launch.argtypes = [p, p, p, p, p, p] + [i] * 13 + [p]
        lib.int8_conv_launch.restype = i
        _lib = lib
    return _lib

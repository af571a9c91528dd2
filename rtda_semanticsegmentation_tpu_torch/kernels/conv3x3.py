"""3x3 / stride-1 convolution with padding = dilation as a CUDA kernel (K4).

Counterpart of ``rtda_semanticsegmentation_tpu/ops/pallas_conv3.py::
conv3x3s1p1``, generalised to any H and W and to a dilation ``d`` with
padding ``d`` (``d = 1`` is the TPU kernel's function)::

    acc = sum over the 9 taps of bf16(x)[i + (dy-1) d, j + (dx-1) d] @ bf16(w)[dy, dx]
    out = acc * scale + shift            per output channel, f32 (if scale)
    out = max(out, 0)                    if relu
    out in out_dtype                     bf16 or f32

Zero padding; the operands are rounded to bf16 and the products add in f32,
so the result is not an f32 conv even when ``x`` and ``w`` are f32.

:func:`conv3x3` takes the JAX package's layouts: ``x`` (B, H, W, C) NHWC and
``w`` (3, 3, C, CO) HWIO. A ``channels_last`` NCHW activation permuted to
NHWC is already contiguous, so the model's permute costs nothing. ``w`` needs
unit stride in CO; its rows may be padded (a ``[..., :CO]`` view of a wider
buffer), which lets the port keep its weights bf16 with CO padded to a
multiple of 8. On a CPU tensor it runs :func:`conv3x3_plain`; on a CUDA
tensor it launches the kernel in ``csrc/conv3x3.cu`` (built on first use, see
:mod:`.build`) or raises. The TPU tiling argument (``block_rows``) has no
counterpart.

The kernel reads its operands with TMA, which needs bf16 operands with
16-byte aligned bases and row strides. :func:`launch_plan` decides, from the
shapes and dtypes, the N tile and whether the wrapper first makes a bf16
copy of ``x`` with C padded to a multiple of 8 (zeros) or of ``w`` with its
rows padded to a multiple of 8; the model's operands need neither.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .build import load_library

SOURCE = "csrc/conv3x3.cu"

# Launches of the CUDA kernel in this process; the plain version never counts.
launches = 0
# Operand copies the wrapper made before a launch (launch_plan).
copies = 0

_DTYPES = (torch.bfloat16, torch.float32)
_lib = None


def _check(x, w, scale, shift, dilation, out_dtype):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (B, H, W, C) and w (3, 3, C, CO), got {tuple(x.shape)}, {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be bf16 or f32, got {t.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    co = w.shape[3]
    if scale is None and shift is not None:
        raise ValueError("shift needs scale")
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (co,)):
            raise ValueError(f"{name} must be f32 of shape ({co},), got {v.dtype} {tuple(v.shape)}")
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"dilation must be a positive int, got {dilation!r}")


def conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    dilation: int = 1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device: an f32 conv
    (dilation and padding ``dilation``) of the bf16-rounded operands, then
    the epilogue in f32 and one cast. On a card the caller turns TF32 off
    (``torch.backends.cudnn.allow_tf32``), or the conv is not f32."""
    _check(x, w, scale, shift, dilation, out_dtype)
    xb = x.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).to(torch.float32).permute(3, 2, 0, 1)
    z = F.conv2d(xb, wb, padding=dilation, dilation=dilation)
    if scale is not None:
        z = z * scale.view(1, -1, 1, 1)
        if shift is not None:
            z = z + shift.view(1, -1, 1, 1)
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(out_dtype).permute(0, 2, 3, 1)


def _weight_row_stride(w: torch.Tensor) -> int:
    """The stride between w's (dy, dx, c) rows; raises unless CO has unit
    stride and the rows are packed one after another."""
    _, _, c, co = w.shape
    ldw = w.stride(2)
    if (w.stride(3) != 1 and co > 1) or ldw < co or w.stride(1) != c * ldw or w.stride(0) != 3 * c * ldw:
        raise ValueError(f"w must be HWIO with unit stride in CO and packed rows, got strides {w.stride()}")
    return ldw


def launch_plan(c: int, co: int, ldw: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
                x_aligned: bool = True, w_aligned: bool = True) -> tuple:
    """``(n_tile, copy_x, copy_w)`` of a launch: the N tile is 24 for CO <=
    24 (the FFM's 19), 64 for CO <= 64, else 128; ``x`` is copied unless it
    is bf16 with C a multiple of 8 on a 16-byte aligned base, ``w`` unless
    it is bf16 with a row stride ``ldw`` a multiple of 8 on an aligned base."""
    n_tile = 24 if co <= 24 else 64 if co <= 64 else 128
    copy_x = x_dtype != torch.bfloat16 or c % 8 != 0 or not x_aligned
    copy_w = w_dtype != torch.bfloat16 or ldw % 8 != 0 or not w_aligned
    return n_tile, copy_x, copy_w


def _padded_bf16(t: torch.Tensor, width: int) -> torch.Tensor:
    """A fresh bf16 copy of ``t`` with its last dimension zero-padded to
    ``width``."""
    out = torch.zeros(t.shape[:-1] + (width,), device=t.device, dtype=torch.bfloat16)
    out[..., : t.shape[-1]] = t
    return out


def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    dilation: int = 1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, H, W, C) x, (3, 3, C, CO) w -> (B, H, W, CO) ``out_dtype``, with
    the optional per-channel f32 ``scale`` / ``shift`` (a folded BatchNorm;
    ``shift`` defaults to zero) and ReLU fused."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, scale, shift, relu=relu, dilation=dilation, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on CPU or CUDA tensors, got {x.device}")
    _check(x, w, scale, shift, dilation, out_dtype)
    if scale is not None and shift is None:
        shift = torch.zeros_like(scale)
    for t in (w, scale, shift):
        if t is not None and t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")
    for t in (x, scale, shift):
        if t is not None and not t.is_contiguous():
            raise ValueError("conv3x3 needs a contiguous NHWC x and contiguous scale / shift")
    ldw = _weight_row_stride(w)
    bsz, h, wd, c = x.shape
    co = w.shape[3]
    n_tile, copy_x, copy_w = launch_plan(c, co, ldw, x.dtype, w.dtype,
                                         x.data_ptr() % 16 == 0, w.data_ptr() % 16 == 0)
    global copies
    if copy_x:
        x = _padded_bf16(x, -(-c // 8) * 8)
    if copy_w:
        ldw = -(-co // 8) * 8
        w = _padded_bf16(w, ldw)
    copies += int(copy_x) + int(copy_w)
    out = torch.empty((bsz, h, wd, co), device=x.device, dtype=out_dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_launch(
            x.data_ptr(), w.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            shift.data_ptr() if shift is not None else None,
            out.data_ptr(), bsz, h, wd, x.shape[3], c, co, ldw, dilation, int(relu),
            int(out_dtype == torch.bfloat16), n_tile,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conv3x3_launch.argtypes = [p] * 5 + [i] * 11 + [p]
        lib.conv3x3_launch.restype = i
        _lib = lib
    return _lib

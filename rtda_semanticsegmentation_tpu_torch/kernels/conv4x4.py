"""The FC-Discriminator's first conv, 4x4 / stride 2 / pad 1, as CUDA kernels.

Counterparts of ``rtda_semanticsegmentation_tpu/ops/pallas_conv.py``:
``conv4x4s2p1`` (K5a, forward), ``conv4x4s2p1_dw`` (K5b, weight gradient)
and ``conv4x4s2p1_dx`` (K5c, input gradient), and its custom VJP
``fused_conv4x4s2p1`` as :class:`Conv4x4s2p1`. The port's layouts are NCHW
(``x`` (B, C, H, W), H and W even) and OIHW (``w`` (CO, C, 4, 4) f32).

Rounding, as the TPU kernels round it: the operands of every product are
rounded to bf16 (x and w forward, x and dy for dW, dy and w for dx), even
when the model computes in f32; the products add in f32 and the result is
rounded once to the output dtype. So the fused conv is not an f32 conv.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel in ``csrc/conv4x4s2.cu`` (built on first use,
see :mod:`.build`) or raises. The TPU tiling arguments (``block_rows``,
``chunk``) have no counterpart.

K5a and K5b read x (and K5b dy) by TMA, as bf16 rows whose pitch is a
multiple of 16 bytes, and K5a writes y by TMA under the same rule; K5c reads
dy and writes dx so. :func:`launch_plan` says, from the shapes and dtypes,
how many tiles a launch has and which operand the wrapper first copies: an
f32 x or dy becomes a bf16 copy (the kernels round them to bf16 all the
same), a row width off the rule gets a copy with a padded pitch, and such a
y or dx is written padded and then copied out. ``copies`` counts them; the
flagship's maps (720x1280 and 512x1024, bf16) take none. The launches are
persistent, one block per SM (a block takes 207-217 KB of shared memory).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..obs.spans import count, module_counters
from .build import load_library

SOURCE = "csrc/conv4x4s2.cu"

# Launches of the CUDA kernels in this process, read as ``fwd_launches``,
# ``dw_launches`` and ``dx_launches`` (the plain versions never count), and
# the operand copies the wrappers made around a launch (launch_plan), read as
# ``copies``: counters ``conv4x4.*`` of ``obs/spans.py``.
__getattr__ = module_counters("conv4x4", ("fwd_launches", "dw_launches", "dx_launches", "copies"))

_MAX_C = 20
_MAX_CO = 64
_TILE_W = 64  # output columns of a K5a / K5b tile of two output rows (csrc/conv4x4s2.cu)
_DX_COLS, _DX_PAIRS = 128, 2  # a K5c tile: 2 pairs of input rows x 256 input columns (128 dy columns)
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_lib = None


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _check(x, w):
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"x must be (B, C, H, W) with H and W even, got {tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 4, 4):
        raise ValueError(f"w must be (CO, {x.shape[1]}, 4, 4), got {tuple(w.shape)}")


def conv4x4s2p1_plain(x, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K5a in plain PyTorch, on any device: an f32 conv of the bf16-rounded
    operands, cast to ``out_dtype``."""
    _check(x, w)
    return F.conv2d(_bf16(x), _bf16(w), stride=2, padding=1).to(out_dtype)


def conv4x4s2p1_dw_plain(x, dy) -> torch.Tensor:
    """K5b in plain PyTorch: the (CO, C, 4, 4) f32 weight gradient from the
    bf16-rounded input and output gradient."""
    w_shape = (dy.shape[1], x.shape[1], 4, 4)
    return torch.nn.grad.conv2d_weight(_bf16(x), w_shape, _bf16(dy), stride=2, padding=1)


def conv4x4s2p1_dx_plain(dy, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K5c in plain PyTorch: the (B, C, 2 Ho, 2 Wo) input gradient from the
    bf16-rounded output gradient and weights, cast to ``out_dtype``."""
    b, _, ho, wo = dy.shape
    x_shape = (b, w.shape[1], 2 * ho, 2 * wo)
    return torch.nn.grad.conv2d_input(x_shape, _bf16(w), _bf16(dy), stride=2, padding=1).to(out_dtype)


def _cuda_operands(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the 4x4/s2 conv kernels need contiguous operands")
        if t.numel() >= 2**31:
            raise ValueError("too many elements for the kernels' 32-bit indices")


def _kernel_shape(x_shape, co, *dtypes):
    b, c, h, wd = x_shape
    if c > _MAX_C or co > _MAX_CO:
        raise ValueError(f"the 4x4/s2 conv kernels take C <= {_MAX_C} and CO <= {_MAX_CO}, got {c}, {co}")
    for dt in dtypes:
        if dt not in _KERNEL_DTYPES:
            raise ValueError(f"the 4x4/s2 conv kernels take bf16 or f32, got {dt}")
    return b, c, h, wd


def _blocks(device, tiles: int, per_sm: int) -> int:
    """Persistent blocks: ``per_sm`` to an SM, no more than the tiles."""
    return max(1, min(tiles, per_sm * torch.cuda.get_device_properties(device).multi_processor_count))


def _pitch_ok(width: int, dtype) -> bool:
    """A row of ``width`` elements is a multiple of 16 bytes (TMA's rule)."""
    return width * (2 if dtype == torch.bfloat16 else 4) % 16 == 0


def launch_plan(kind: str, x_shape, x_dtype, other_dtype, x_aligned: bool = True,
                other_aligned: bool = True) -> tuple:
    """``(tiles, copy_x, copy_other)`` of a K5a (``kind`` "fwd", other = y's
    dtype), K5b ("dw", other = dy) or K5c ("dx", x = dx, other = dy) launch
    on x of shape (B, C, H, W). A K5a or K5b tile is two output rows by 64
    output columns, a K5c tile two pairs of input rows by 256 input columns.
    x is copied unless it is bf16 with W a multiple of 8 on a 16-byte aligned
    base; K5a's y is written padded and copied out unless its row of W/2 is
    a multiple of 16 bytes, and K5c's dx unless its row of W is; the dy of
    K5b and K5c is copied unless bf16 with W/2 a multiple of 8 on an aligned
    base."""
    if kind not in ("fwd", "dw", "dx"):
        raise ValueError(f"kind must be 'fwd', 'dw' or 'dx', got {kind!r}")
    b, _, h, wd = x_shape
    ho, wo = h // 2, wd // 2
    copy_dy = other_dtype != torch.bfloat16 or not _pitch_ok(wo, torch.bfloat16) or not other_aligned
    if kind == "dx":
        tiles = b * -(-(ho + 1) // _DX_PAIRS) * -(-wo // _DX_COLS)
        return tiles, not _pitch_ok(wd, x_dtype), copy_dy
    tiles = b * -(-ho // 2) * -(-wo // _TILE_W)
    copy_x = x_dtype != torch.bfloat16 or not _pitch_ok(wd, torch.bfloat16) or not x_aligned
    if kind == "fwd":
        return tiles, copy_x, not _pitch_ok(wo, other_dtype)
    return tiles, copy_x, copy_dy


def _pitched_bf16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 copy of the (..., W) tensor ``t`` in rows padded to a multiple
    of 8 elements, as a (..., W) view."""
    w = t.shape[-1]
    out = torch.empty(t.shape[:-1] + (-(-w // 8) * 8,), device=t.device, dtype=torch.bfloat16)
    out[..., :w] = t
    return out[..., :w]


def _is_bf16(dtype) -> int:
    return int(dtype == torch.bfloat16)


def conv4x4s2p1(x, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, C, H, W) x, (CO, C, 4, 4) f32 w -> (B, CO, H/2, W/2) ``out_dtype``."""
    if x.device.type == "cpu":
        return conv4x4s2p1_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv4x4s2p1 runs on CPU or CUDA tensors, got {x.device}")
    _check(x, w)
    if w.dtype != torch.float32:
        raise ValueError(f"w must be f32, got {w.dtype}")
    _cuda_operands(x, w)
    co = w.shape[0]
    b, c, h, wd = _kernel_shape(x.shape, co, x.dtype, out_dtype)
    tiles, copy_x, copy_y = launch_plan("fwd", x.shape, x.dtype, out_dtype, x.data_ptr() % 16 == 0)
    if copy_x:
        x = _pitched_bf16(x)
    ho, wo = h // 2, wd // 2
    y_rows = -(-wo // 8) * 8 if copy_y else wo
    y = torch.empty((b, co, ho, y_rows), device=x.device, dtype=out_dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv4x4s2_fwd_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, c, h, wd, co, x.stride(2), y_rows,
            _is_bf16(out_dtype), _blocks(x.device, tiles, 1), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv4x4s2p1 launch failed: CUDA error {err}")
    count("conv4x4.fwd_launches")
    count("conv4x4.copies", int(copy_x) + int(copy_y))
    return y[..., :wo].contiguous() if copy_y else y


def conv4x4s2p1_dw(x, dy) -> torch.Tensor:
    """(B, C, H, W) x, (B, CO, H/2, W/2) dy -> (CO, C, 4, 4) f32 weight
    gradient, summed in a fixed order (deterministic on one card)."""
    if x.device.type == "cpu":
        return conv4x4s2p1_dw_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv4x4s2p1_dw runs on CPU or CUDA tensors, got {x.device}")
    if x.dim() != 4 or dy.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2 or tuple(dy.shape) != (
            x.shape[0], dy.shape[1], x.shape[2] // 2, x.shape[3] // 2):
        raise ValueError(f"x (B, C, H, W) with H, W even and dy (B, CO, H/2, W/2), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    b, c, h, wd = x.shape
    co = dy.shape[1]
    _cuda_operands(x, dy)
    _kernel_shape(x.shape, co, x.dtype, dy.dtype)
    tiles, copy_x, copy_dy = launch_plan("dw", x.shape, x.dtype, dy.dtype, x.data_ptr() % 16 == 0,
                                         dy.data_ptr() % 16 == 0)
    if copy_x:
        x = _pitched_bf16(x)
    if copy_dy:
        dy = _pitched_bf16(dy)
    blocks = _blocks(x.device, tiles, 1)
    partial = torch.empty((blocks, c * 16 * _MAX_CO), device=x.device, dtype=torch.float32)
    dw = torch.empty((co, c, 4, 4), device=x.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv4x4s2_dw_launch(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, c, h, wd, co,
            x.stride(2), dy.stride(2), blocks, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv4x4s2p1_dw launch failed: CUDA error {err}")
    count("conv4x4.dw_launches")
    count("conv4x4.copies", int(copy_x) + int(copy_dy))
    return dw


def conv4x4s2p1_dx(dy, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, CO, Ho, Wo) dy, (CO, C, 4, 4) f32 w -> (B, C, 2 Ho, 2 Wo)
    ``out_dtype`` input gradient."""
    if dy.device.type == "cpu":
        return conv4x4s2p1_dx_plain(dy, w, out_dtype)
    if dy.device.type != "cuda":
        raise ValueError(f"conv4x4s2p1_dx runs on CPU or CUDA tensors, got {dy.device}")
    if dy.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (4, 4) or w.shape[0] != dy.shape[1]:
        raise ValueError(f"dy (B, CO, Ho, Wo) and w (CO, C, 4, 4), got {tuple(dy.shape)}, {tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise ValueError(f"w must be f32, got {w.dtype}")
    _cuda_operands(dy, w)
    b, co, ho, wo = dy.shape
    x_shape = (b, w.shape[1], 2 * ho, 2 * wo)
    _, c, h, wd = _kernel_shape(x_shape, co, dy.dtype, out_dtype)
    tiles, copy_dx, copy_dy = launch_plan("dx", x_shape, out_dtype, dy.dtype, other_aligned=dy.data_ptr() % 16 == 0)
    if copy_dy:
        dy = _pitched_bf16(dy)
    pitch = -(-wd // 8) * 8 if copy_dx else wd
    dx = torch.empty((b, c, h, pitch), device=dy.device, dtype=out_dtype)
    lib = _library()
    with torch.cuda.device(dy.device):
        err = lib.conv4x4s2_dx_launch(
            dy.data_ptr(), w.data_ptr(), dx.data_ptr(), b, c, h, wd, co, dy.stride(2), pitch,
            _is_bf16(out_dtype), _blocks(dy.device, tiles, 1), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv4x4s2p1_dx launch failed: CUDA error {err}")
    count("conv4x4.dx_launches")
    count("conv4x4.copies", int(copy_dx) + int(copy_dy))
    return dx[..., :wd].contiguous() if copy_dx else dx


class Conv4x4s2p1(torch.autograd.Function):
    """Differentiable fused 4x4/s2/p1 conv (the JAX package's
    ``fused_conv4x4s2p1``): K5a forward; the backward runs K5b only when
    ``w`` needs a gradient and K5c only when ``x`` does. The module-level
    wrappers are looked up at each call, so swapping them (for their plain
    versions) swaps what the Function runs."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return conv4x4s2p1(x, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv4x4s2p1_dx(dy, w, x.dtype) if ctx.needs_input_grad[0] else None
        dw = conv4x4s2p1_dw(x, dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def fused_conv4x4s2p1(x, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    return Conv4x4s2p1.apply(x, w, out_dtype)


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conv4x4s2_fwd_launch.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.conv4x4s2_fwd_launch.restype = i
        lib.conv4x4s2_dw_launch.argtypes = [p, p, p, p] + [i] * 8 + [p]
        lib.conv4x4s2_dw_launch.restype = i
        lib.conv4x4s2_dx_launch.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.conv4x4s2_dx_launch.restype = i
        _lib = lib
    return _lib

"""LayerNorm over the last axis as CUDA kernels, train and eval.

The function is ``models/layers.py::LayerNorm``'s: for each row of C
elements, with the f32 ``weight`` and ``bias`` rounded to the activation
dtype first::

    mean = E[x],  var = E[(x - mean)^2],  rstd = rsqrt(var + eps)      in f32
    y = (x - mean) * rstd * weight + bias                   in f32, rounded once

:func:`layer_norm` is what the layer calls. On a CPU tensor it runs
:func:`layer_norm_plain`, ``F.layer_norm`` on the rounded parameters, the
expression the layer has always run; on a CUDA tensor, :class:`LayerNormFn`,
an autograd Function whose forward (:func:`layer_norm_forward`) and
backward (:func:`layer_norm_backward`) are the kernels of
``csrc/layernorm.cu`` (built on first use, see :mod:`.build`): one launch
forward, which also writes each row's mean and rstd (f32, 8 bytes a row)
where a backward will follow; a row pass and a finishing pass backward. The
backward is the exact gradient through the row statistics in f32, ``dx``
rounded once, ``dweight`` and ``dbias`` f32 sums of ``dy * x^`` and ``dy``
added in a fixed order (:func:`layer_norm_grad_plain` is its plain
version): the same bits on every run. Autograd keeps ``x`` and the two
per-row statistics. There is no fallback: a CUDA tensor the kernels do not
take raises.

It replaces no TPU kernel (the JAX package has no SegFormer): PyTorch's
kernels ran SegFormer-B5's 161 norms a train step at about a tenth of their
byte bound, with a cast of each parameter to the activation dtype and of
each parameter gradient back around every call.

The kernels read dense rows of whole 16-byte vectors: a CUDA input or
gradient that is not contiguous is copied first (:func:`operand`, counted
in ``copies``); a width that is not a multiple of 8 (bf16) or 4 (f32)
raises. :func:`launch_plan` chooses, from the width, the row count and the
dtype, how a group of threads holds a row and how the backward's blocks
walk the rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..obs.spans import count, module_counters
from .build import launch, load_library, sm_count, stream_of

SOURCE = "csrc/layernorm.cu"

# Forward and backward calls of the kernels in this process (the plain
# version never counts), and the copies :func:`operand` made of an input or
# a gradient whose rows are not dense: counters ``layernorm.*`` of
# ``obs/spans.py``.
__getattr__ = module_counters("layernorm", ("fwd_calls", "bwd_calls", "copies"))

_DTYPES = (torch.bfloat16, torch.float32)
MAX_N = 5  # vectors of a row a thread holds, at most (csrc/layernorm.cu kMaxN)
LIGHT = 16  # elements a thread holds above which the backward's blocks are of 128 (its registers)
_THREADS = 256  # the forward's block, and the backward's where a thread holds at most LIGHT elements
_BWD_WIDE_THREADS = 128  # the backward's block where a thread holds more (its registers)
_BWD_PER_SM = 4  # the backward's blocks an SM is given, at most: fewer partial rows to finish
_lib = None


# -- the plain version ------------------------------------------------------

def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``F.layer_norm`` over the last axis with the f32 parameters rounded
    to ``x``'s dtype, differentiable by autograd."""
    return F.layer_norm(x, weight.shape, weight.to(x.dtype), bias.to(x.dtype), eps)


def row_stats_plain(x: torch.Tensor, eps: float, acc: torch.dtype = torch.float64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's mean and rstd as the kernels define them, in ``acc``."""
    xa = x.to(acc)
    mean = xa.mean(dim=-1)
    var = (xa - mean.unsqueeze(-1)).square().mean(dim=-1)
    return mean, torch.rsqrt(var + eps)


def layer_norm_grad_plain(dy, x, weight, mean, rstd, acc: torch.dtype = torch.float64
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' backward in plain PyTorch: ``(dx, dweight, dbias)``
    from the output gradient ``dy``, the input ``x`` and the forward's
    per-row ``mean`` and ``rstd``, computed in ``acc`` with the weight
    rounded to ``x``'s dtype; ``dx`` in ``acc`` (the caller rounds it), the
    parameters' gradients summed over every row::

        x^ = (x - mean) * rstd,  g = dy * weight
        dx = rstd * (g - mean(g) - x^ * mean(g * x^))
        dweight = sum dy * x^,  dbias = sum dy
    """
    c = x.shape[-1]
    xh = (x.to(acc) - mean.to(acc).unsqueeze(-1)) * rstd.to(acc).unsqueeze(-1)
    d = dy.to(acc)
    g = d * weight.to(x.dtype).to(acc)
    dx = rstd.to(acc).unsqueeze(-1) * (g - g.mean(dim=-1, keepdim=True) - xh * (g * xh).mean(dim=-1, keepdim=True))
    return dx, (d * xh).reshape(-1, c).sum(0), d.reshape(-1, c).sum(0)


# -- the kernels --------------------------------------------------------------

def takes(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` as it is: dense rows (contiguous) from
    a 16-byte boundary."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it (:func:`takes`): itself, or a
    contiguous copy (the allocator's blocks start on 512-byte boundaries),
    counted in ``copies``."""
    if takes(t):
        return t
    count("layernorm.copies")
    return t.clone(memory_format=torch.contiguous_format)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vectors(c: int, elem_bytes: int) -> Tuple[int, int, int]:
    """(v, lanes, n) for a row of ``c`` elements: ``v`` elements a 16-byte
    vector, the row a whole number of them, held by a group of ``lanes``
    threads (the largest power-of-two factor of its vectors, up to 32),
    ``n`` vectors a thread, at most MAX_N: ``lanes * n`` is exactly the
    row's vectors. Raises for a row the kernels do not take."""
    v = 16 // elem_bytes
    if c % v:
        raise ValueError(f"the LayerNorm kernels take rows of whole 16-byte vectors ({v} elements), got {c}")
    vectors = c // v
    lanes = min(32, vectors & -vectors)
    if vectors // lanes > MAX_N:
        raise ValueError(f"a row of {c} elements exceeds the LayerNorm kernels' grouping: {vectors} vectors "
                         f"of {v}, at most {MAX_N} for each of {lanes} lanes")
    return v, lanes, vectors // lanes


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, c: int, dtype: torch.dtype, sms: int = 132,
                per_sm: Optional[Tuple[int, int]] = None) -> dict:
    """A launch over ``rows`` rows of ``c`` elements of ``dtype`` (bf16 or
    f32), its operands on 16-byte boundaries (:func:`takes`). A row is
    held by a group of ``lanes`` threads, ``n`` vectors of ``v`` elements
    each (:func:`_vectors`). The forward runs ``threads`` a block,
    ``grid`` blocks striding over the rows a group a row; the backward's
    row pass ``bwd_threads`` a block (128 where a thread holds more than
    ``LIGHT`` elements, as at C = 320: its registers), ``blocks`` of them,
    each over ``rows_per_block`` rows (a multiple of its groups). Each grid
    is at most one wave on ``sms`` SMs of ``per_sm`` (the two kernels'
    occupancy, which :func:`plan_of` asks the card for; 4 blocks each
    where it is not given), the backward's at most ``_BWD_PER_SM`` blocks
    an SM. Raises for a dtype or a width the kernels do not take."""
    if dtype not in _DTYPES:
        raise ValueError(f"the LayerNorm kernels take bf16 or f32, got {dtype}")
    if rows < 1 or c < 1:
        raise ValueError(f"the LayerNorm kernels take no empty tensor: {rows} rows of {c}")
    v, lanes, n = _vectors(c, torch.finfo(dtype).bits // 8)
    fwd_per_sm, bwd_per_sm = per_sm or (4, 4)
    groups = _THREADS // lanes
    bwd_threads = _THREADS if n * v <= LIGHT else _BWD_WIDE_THREADS
    bwd_groups = bwd_threads // lanes
    blocks = max(1, min(sms * min(bwd_per_sm, _BWD_PER_SM), _cdiv(rows, bwd_groups)))
    rows_per_block = _cdiv(_cdiv(rows, blocks), bwd_groups) * bwd_groups
    return {"v": v, "lanes": lanes, "n": n, "threads": _THREADS, "grid": min(_cdiv(rows, groups), sms * fwd_per_sm),
            "bwd_threads": bwd_threads, "blocks": _cdiv(rows, rows_per_block), "rows_per_block": rows_per_block}


@functools.lru_cache(maxsize=None)
def _occupancy(f32: int, n: int, threads: int, bwd_threads: int) -> Tuple[int, int]:
    """Blocks of the forward and of the backward's row pass an SM holds at
    once (their registers and shared memory included)."""
    lib = _library()
    blocks = (lib.layernorm_occupancy(f32, n, 0, threads), lib.layernorm_occupancy(f32, n, 1, bwd_threads))
    if min(blocks) < 1:
        raise RuntimeError(f"a LayerNorm kernel fits no SM at {threads} / {bwd_threads} threads")
    return blocks


def plan_of(x: torch.Tensor) -> dict:
    """:func:`launch_plan` for a CUDA ``x``, its grids sized by the
    kernels' occupancy on ``x``'s card."""
    c = x.shape[-1]
    rows, sms = x.numel() // c, sm_count(x.device.index or 0)
    plan = launch_plan(rows, c, x.dtype, sms)
    per_sm = _occupancy(int(x.dtype == torch.float32), plan["n"], plan["threads"], plan["bwd_threads"])
    return launch_plan(rows, c, x.dtype, sms, per_sm)


def _check(x: torch.Tensor, *vectors) -> None:
    """Raises unless the kernels take the CUDA ``x`` as it is and its f32
    per-channel ``vectors`` (the device last, so that the checks run on a
    CPU tensor too)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the LayerNorm kernels take bf16 or f32, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"the LayerNorm kernels take no empty tensor, got {tuple(x.shape)}")
    if not takes(x):
        raise ValueError(f"the LayerNorm kernels take dense rows on a 16-byte boundary, got shape {tuple(x.shape)} "
                         f"strides {x.stride()} at {x.data_ptr() % 16} past one")
    for v in vectors:
        if v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous() or v.numel() != x.shape[-1]:
            raise ValueError(f"the LayerNorm kernels take contiguous f32 vectors of {x.shape[-1]} on {x.device}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    if x.device.type != "cuda":
        raise ValueError(f"the LayerNorm kernels run on CUDA tensors, got {x.device}")


def layer_norm_forward(x, weight, bias, eps: float, stats: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The forward on the card: ``(y, mean, rstd)``, the per-row f32
    statistics None without ``stats`` (no backward follows)."""
    _check(x, weight, bias)
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    plan = plan_of(x)
    launch(_library().layernorm_forward, x, x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
           None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(),
           int(x.dtype == torch.float32), rows, c, eps, plan["lanes"], plan["n"], plan["threads"], plan["grid"],
           stream_of(x))
    count("layernorm.fwd_calls")
    return y, mean, rstd


def layer_norm_backward(dy, x, weight, mean, rstd) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: ``(dx, dweight, dbias)``; ``dy`` copied
    first where its rows are not dense (counted)."""
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    _check(x, weight)
    dy = operand(dy)
    c = x.shape[-1]
    rows = x.numel() // c
    dx = torch.empty_like(x)
    plan = plan_of(x)
    partial = torch.empty((2, c, plan["blocks"]), dtype=torch.float32, device=x.device)
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    launch(_library().layernorm_backward, x, dy.data_ptr(), x.data_ptr(), dx.data_ptr(), weight.data_ptr(),
           mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
           int(x.dtype == torch.float32), rows, c, plan["lanes"], plan["n"], plan["bwd_threads"], plan["blocks"],
           plan["rows_per_block"], stream_of(x))
    count("layernorm.bwd_calls")
    return dx, dweight, dbias


class LayerNormFn(torch.autograd.Function):
    """LayerNorm on the kernels: keeps ``x``, ``weight`` and the forward's
    per-row mean and rstd for the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm_forward(x, weight, bias, eps, stats=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dweight, dbias = layer_norm_backward(dy, x, weight, mean, rstd)
        return dx if need[0] else None, dweight if need[1] else None, dbias if need[2] else None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 ``weight`` and ``bias``: the
    kernels on a CUDA tensor (copied first where :func:`operand` says), the
    plain version elsewhere."""
    if x.device.type != "cuda":
        return layer_norm_plain(x, weight, bias, eps)
    return LayerNormFn.apply(operand(x), weight, bias, eps)


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.layernorm_forward.argtypes = [p] * 6 + [i, q, i, f, i, i, i, i, p]
        lib.layernorm_forward.restype = i
        lib.layernorm_backward.argtypes = [p] * 9 + [i, q, i, i, i, i, i, q, p]
        lib.layernorm_backward.restype = i
        lib.layernorm_occupancy.argtypes = [i] * 4
        lib.layernorm_occupancy.restype = i
        _lib = lib
    return _lib

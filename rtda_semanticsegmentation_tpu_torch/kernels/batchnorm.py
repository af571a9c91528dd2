"""Train-mode BatchNorm, with its ConvBN's ReLU, as CUDA kernels.

The function is ``models/layers.py::FoldableBatchNorm``'s in train mode (the
JAX ``FoldableBatchNorm``'s), per channel over (N, H, W)::

    mean = E[x],  var = E[x^2] - mean^2                  in at least f32
    mul = weight * rsqrt(var + eps),  add = bias - mean * mul     in f32
    y = relu(x * round(mul) + round(add))    each operation rounded to x's dtype

with the running statistics moved by flax's momentum (0.9) toward the batch
mean and the unbiased variance, unless the call holds them (the remat
recompute, ``models/layers.py::running_stats_held``). Data parallel
(``mesh``, a ``parallel.MeshContext`` of more than one data index), the
statistics are the global batch's, as JAX's SPMD BatchNorm computes them:
``[Σx, Σx², n]`` summed over the data group, ``n`` the global count in the
unbiased factor too. The ranks of a model group hold the same rows and
every channel (a sharded conv gathers its output first), so they take no
part in the sum.

:func:`batch_norm_train` is what the layer calls. On a CPU tensor it runs
:func:`batch_norm_train_plain`, those expressions under autograd; on a CUDA
tensor, :class:`BatchNormReLU`, an autograd Function whose forward
(:func:`batch_norm_forward`) and backward (:func:`batch_norm_backward`) are
the kernels of ``csrc/batchnorm.cu`` (built on first use, see :mod:`.build`):
a pass of partial sums, a pass that finishes the per-channel numbers, and an
elementwise pass, each way. Data parallel, the ranks' sums (one
``all_reduce`` of ``2 C + 1`` f64 numbers) come between the first pass and
the other two. Given the same ``mul`` and ``add`` the forward gives the
plain version's bits; its statistics add in another order (f32 a thread,
f64 from there). The backward is the exact gradient through the batch
statistics in f32, rounded once (:func:`batch_norm_grad_plain` is its plain
version), where autograd of the plain version rounds at each of its bf16
steps. Autograd keeps ``x`` and the per-channel ``coef`` (mean, invstd,
mul, add); the ReLU's mask is recomputed from them.

It replaces no TPU kernel (the JAX package left BatchNorm to XLA's fusions):
PyTorch runs the plain version as about 20 launches forward and 25
backward a call through f32 copies of the activation, about 90 bytes an
element where 16 (bf16) do.

The kernels read (N, C, H, W) with the channels innermost: dense
``channels_last`` memory, or a (B, C, 1, 1) gate; a gradient may also be a
channel slice of a wider ``channels_last`` tensor (:func:`row_stride`). A
CUDA tensor in any other layout is copied (:func:`operand`, counted in
``copies``). :func:`launch_plan` chooses, from the shape and the dtype, the
vector width, the block's channel groups and rows, and the rows of a
block's chunk.
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

SOURCE = "csrc/batchnorm.cu"

# Forward and backward calls of the kernels in this process (the plain
# version never counts), and the copies :func:`operand` made of an input or
# a gradient the kernels do not take as it is: counters ``batchnorm.*`` of
# ``obs/spans.py``.
__getattr__ = module_counters("batchnorm", ("fwd_calls", "bwd_calls", "copies"))

SUMS, FINISH, MAP = 1, 2, 4  # the passes a launch runs (csrc/batchnorm.cu kSums, kFinish, kMap)
_DTYPES = (torch.bfloat16, torch.float32)
_THREADS = 256  # a block
_MAX_TX = 32  # channel groups a block spans, at most
_PER_THREAD = 8  # rows (vectors) a thread takes, at least
_UNROLL = 4  # rows (vectors) a thread loads at once (csrc/batchnorm.cu kUnroll)
_MAX_CHUNKS = 65535
_lib = None


# -- the plain version ------------------------------------------------------

def statistics(x: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """``(mean, var, n)`` per channel over (N, H, W), in at least f32:
    ``E[x]``, ``E[x^2] - E[x]^2`` and the count. Over ``mesh``'s data group
    where given: one autograd sum of ``[Σx, Σx², n]``, ``n`` then a device
    scalar."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = x.shape[1]
    if mesh is None:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, xf.square().mean(dim=(0, 2, 3)) - mean.square(), x.numel() // c
    local = torch.full((1,), float(x.numel() // c), dtype=xf.dtype, device=x.device)
    sums = mesh.sum(torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)), local]))
    n = sums[2 * c]
    mean = sums[:c] / n
    return mean, sums[c: 2 * c] / n - mean.square(), n


def scale_shift(weight, bias, mean, var, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm as a per-channel ``(mul, add)`` pair, in the statistics'
    dtype: ``mul = weight * rsqrt(var + eps)``, ``add = bias - mean * mul``."""
    mul = weight * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


def apply_scale_shift(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """``x * mul + add`` per channel in ``x``'s dtype, ``mul`` and ``add``
    rounded to it first."""
    return x * mul.to(x.dtype).view(1, -1, 1, 1) + add.to(x.dtype).view(1, -1, 1, 1)


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, n, momentum: float) -> None:
    """Move the running statistics toward the batch's, with flax's
    ``momentum`` and the unbiased variance ``var * n / (n - 1)``. ``n``: the
    count, an int or (data parallel) a device scalar."""
    unbiased = n / max(n - 1, 1) if isinstance(n, int) else n / (n - 1).clamp_min(1)
    running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1 - momentum) * var * unbiased)


def batch_norm_train_plain(x, weight, bias, running_mean, running_var, *, eps: float, momentum: float,
                           update: bool, relu: bool, mesh=None) -> torch.Tensor:
    """Train-mode BatchNorm (and ReLU) in plain PyTorch, differentiable by
    autograd: the module docstring's expressions."""
    mean, var, n = statistics(x, mesh)
    if update:
        update_running_stats(running_mean, running_var, mean, var, n, momentum)
    y = apply_scale_shift(x, *scale_shift(weight, bias, mean, var, eps))
    return F.relu(y) if relu else y


def coefficients_plain(x, weight, bias, eps: float, mesh=None) -> torch.Tensor:
    """(4, C): the batch's mean, invstd, mul and add as the plain version
    computes them in f32 (f64 for an f64 ``x``): what the kernels keep in
    ``coef``."""
    mean, var, _ = statistics(x, mesh)
    invstd = torch.rsqrt(var + eps)
    mul = weight.to(invstd.dtype) * invstd
    return torch.stack([mean, invstd, mul, bias.to(mul.dtype) - mean * mul])


def batch_norm_grad_plain(dy, x, weight, coef, *, relu: bool, mesh=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' backward in plain PyTorch: ``(dx, dweight, dbias)`` from
    the output gradient ``dy``, the input ``x`` and the forward's ``coef``,
    computed in f32 (f64 for f64 operands) and ``dx`` rounded once to
    ``x``'s dtype. ``g`` is ``dy`` where the forward's output (recomputed
    from ``x`` and ``coef``) is above 0 with ``relu``, else ``dy``::

        dbias = sum g,  dweight = invstd * sum g (x - mean)
        dx = g * mul + k (x - mean) + c0,  k = -weight invstd^3 sum g (x - mean) / n,
        c0 = -mul sum g / n

    Data parallel (``mesh``), ``k`` and ``c0`` take the sums and ``n`` of
    every rank (each rank's loss reaches every rank's ``x`` through the
    global statistics); ``dweight`` and ``dbias`` stay the rank's own, as
    autograd of :func:`batch_norm_train_plain` gives them (the step sums
    the parameters' gradients over the ranks later)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    mean, invstd, mul, add = (v.to(acc).view(1, -1, 1, 1) for v in coef)
    g = dy.to(acc)
    if relu:
        g = torch.where(apply_scale_shift(x, mul.flatten(), add.flatten()) > 0, g, torch.zeros_like(g))
    xc = x.to(acc) - mean
    n = x.numel() // x.shape[1]
    sg = g.sum(dim=(0, 2, 3), keepdim=True)
    sgx = (g * xc).sum(dim=(0, 2, 3), keepdim=True)
    dweight, dbias = (invstd * sgx).flatten(), sg.flatten()
    if mesh is not None:
        c = x.shape[1]
        total = mesh.sum_(torch.cat([dbias, sgx.flatten(), sg.new_full((1,), float(n))]))
        sg, sgx, n = total[:c].view_as(sg), total[c: 2 * c].view_as(sgx), total[2 * c]
    k = -weight.to(acc).view(1, -1, 1, 1) * invstd ** 3 * sgx / n
    dx = g * mul + k * xc - mul * sg / n
    return dx.to(x.dtype), dweight, dbias


# -- the kernels --------------------------------------------------------------

def takes(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` as it is: (N, C, H, W) dense with the
    channels innermost (``channels_last`` memory, a (B, C, 1, 1) gate)."""
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The elements between the rows (n, h, w) of a 4-D ``t`` whose channels
    are innermost and whose rows lie evenly, at least C apart: C for dense
    ``channels_last`` memory, more for a channel slice of a wider such
    tensor (the gradient of one part of a ``torch.cat``); None otherwise."""
    if t.dim() != 4:
        return None
    n, c, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    ld = sw if w > 1 else sh if h > 1 else sn if n > 1 else c
    if (c > 1 and sc != 1) or ld < c or (h > 1 and sh != w * ld) or (n > 1 and sn != h * w * ld):
        return None
    return ld


def operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: itself where :func:`takes` says so, else
    a copy in ``channels_last`` memory, counted in ``copies``."""
    if takes(t):
        return t
    count("batchnorm.copies")
    return t.contiguous(memory_format=torch.channels_last)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _chunking(rows: int, step: int, tiles: int, blocks: int) -> Tuple[int, int]:
    """(chunks, chunk_len): ``rows`` cut into chunks of a multiple of
    ``step`` x the unroll, at least 8 a thread, the chunks times ``tiles``
    at most ``blocks`` (one wave) where the rows allow."""
    chunks = max(1, min(blocks // tiles, -(-rows // (step * _PER_THREAD))))
    chunk_len = _round_up(-(-rows // chunks), step * _UNROLL)
    return -(-rows // chunk_len), chunk_len


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, c: int, elem_bytes: int, aligned: bool, sms: int,
                per_sm: Optional[Tuple[int, int]] = None) -> dict:
    """A launch over ``c`` channels of ``rows`` = N*H*W elements each, of
    ``elem_bytes`` (2 or 4); ``aligned``: the operands' bases (and rows)
    are 16-byte aligned. ``v``: elements a thread loads at once, 16 bytes
    where the rows keep them aligned; a block spans ``tx`` groups of ``v``
    channels (all of them, up to 32 groups) by ``ty`` rows, ``tiles``
    blocks across the channels. The partial sums' grid is ``chunks`` blocks
    of ``chunk_len`` rows down each tile, the elementwise pass's
    ``map_chunks`` of ``map_chunk_len``: each at least 8 rows a thread, and
    as many as one wave holds on ``sms`` SMs of ``per_sm`` (the two
    kernels' occupancy, which :func:`plan_of` asks the card for; 4 blocks
    each where it is not given)."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"the BatchNorm kernels take bf16 or f32 elements, got {elem_bytes} bytes")
    if rows < 1 or c < 1:
        raise ValueError(f"the BatchNorm kernels take no empty tensor: {rows} rows, {c} channels")
    vec = 16 // elem_bytes
    v = vec if aligned and c % vec == 0 else 1
    groups = c // v
    tx = min(groups, _MAX_TX)
    ty = _THREADS // tx
    tiles = -(-groups // tx)
    sums_per_sm, map_per_sm = per_sm or (4, 4)
    chunks, chunk_len = _chunking(rows, ty, tiles, sms * sums_per_sm)
    map_chunks, map_chunk_len = _chunking(rows, ty, tiles, sms * map_per_sm)
    if max(chunks, map_chunks) > _MAX_CHUNKS:
        raise ValueError(f"{max(chunks, map_chunks)} chunks exceed the grid's {_MAX_CHUNKS}")
    return {"v": v, "tx": tx, "ty": ty, "threads": tx * ty, "tiles": tiles, "chunks": chunks,
            "chunk_len": chunk_len, "map_chunks": map_chunks, "map_chunk_len": map_chunk_len}


@functools.lru_cache(maxsize=None)
def _occupancy(f32: int, v: int, grad: int, threads: int) -> Tuple[int, int]:
    """Blocks an SM holds at once of the partial-sums and the elementwise
    kernel (their registers and shared memory included)."""
    lib = _library()
    blocks = tuple(lib.batchnorm_occupancy(f32, v, grad, kernel, threads) for kernel in (0, 1))
    if min(blocks) < 1:
        raise RuntimeError(f"a BatchNorm kernel fits no SM at {threads} threads")
    return blocks


def _check(x: torch.Tensor, *vectors) -> None:
    """Raises unless the kernels take the CUDA ``x`` as it is and its
    per-channel f32 ``vectors`` (the device last, so that the checks run on
    a CPU tensor too)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the BatchNorm kernels take bf16 or f32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"the BatchNorm kernels take no empty tensor, got {tuple(x.shape)}")
    if not takes(x):
        raise ValueError(f"the BatchNorm kernels take (N, C, H, W) in channels_last memory, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    for v in vectors:
        if v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous() or v.numel() != x.shape[1]:
            raise ValueError(f"the BatchNorm kernels take contiguous f32 per-channel vectors of {x.shape[1]} on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if x.device.type != "cuda":
        raise ValueError(f"the BatchNorm kernels run on CUDA tensors, got {x.device}")


@functools.lru_cache(maxsize=None)
def _plan(rows: int, c: int, elem_bytes: int, aligned: bool, index: int, grad: bool) -> dict:
    sms = sm_count(index)
    plan = launch_plan(rows, c, elem_bytes, aligned, sms)
    per_sm = _occupancy(int(elem_bytes == 4), plan["v"], int(grad), plan["threads"])
    return launch_plan(rows, c, elem_bytes, aligned, sms, per_sm)


def plan_of(x: torch.Tensor, grad: bool, *others: torch.Tensor, ld: Optional[int] = None) -> dict:
    """:func:`launch_plan` for a CUDA ``x`` (and ``others`` read or written
    beside it, rows ``ld`` elements apart where given), for the forward's
    kernels or (``grad``) the backward's, its grids sized by their
    occupancy on ``x``'s card."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others)) and (ld or 0) * x.element_size() % 16 == 0
    return _plan(x.numel() // x.shape[1], x.shape[1], x.element_size(), aligned, x.device.index or 0, grad)


def _ranks_sum(sums: torch.Tensor, rows: int, mesh) -> torch.Tensor:
    """``[sums[0] (C), sums[1] (C), rows]`` in f64 summed over ``mesh``'s
    data group: one partial row and the global count, for the finishing
    pass."""
    return mesh.sum_(torch.cat([sums.flatten(), sums.new_full((1,), float(rows))]))


def batch_norm_forward(x, weight, bias, running_mean, running_var, *, eps: float, momentum: float, update: bool,
                       relu: bool, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the card: ``(y, coef)``, ``coef`` (4, C) f32 the
    batch's (the global batch's over ``mesh``'s data group) mean, invstd,
    mul and add; the running statistics moved in place where ``update``."""
    _check(x, weight, bias, running_mean, running_var)
    rows, c = x.numel() // x.shape[1], x.shape[1]
    y = torch.empty_like(x)
    plan = plan_of(x, False)
    coef = torch.empty((4, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((plan["chunks"], 2, c), dtype=torch.float64, device=x.device)
    lib = _library()

    def run(partial_ptr, count_ptr, chunks, passes):
        launch(lib.batchnorm_forward, x, x.data_ptr(), y.data_ptr(), int(x.dtype == torch.float32), rows, c,
               weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
               coef.data_ptr(), partial_ptr, count_ptr, int(update), int(relu), eps, momentum, 1 - momentum,
               plan["v"], plan["tx"], plan["ty"], chunks, plan["chunk_len"], plan["map_chunks"],
               plan["map_chunk_len"], passes, stream_of(x))

    if mesh is None:
        run(partial.data_ptr(), None, plan["chunks"], SUMS | FINISH | MAP)
    else:
        run(partial.data_ptr(), None, plan["chunks"], SUMS)
        total = _ranks_sum(partial.sum(0), rows, mesh)
        run(total.data_ptr(), total[2 * c:].data_ptr(), 1, FINISH | MAP)
    count("batchnorm.fwd_calls")
    return y, coef


def batch_norm_backward(dy, x, weight, coef, *, relu: bool, input_grad: bool = True, mesh=None
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The backward on the card: ``(dx, dweight, dbias)``, ``dx`` None
    without ``input_grad`` (the elementwise pass is skipped). ``dy`` is read
    as it is in ``x``'s layout or as a channel slice of a wider
    ``channels_last`` tensor (:func:`row_stride`); else it is copied
    (counted). Over ``mesh``'s data group, dx's coefficients take every
    rank's sums and ``dweight`` and ``dbias`` the rank's own
    (:func:`batch_norm_grad_plain`)."""
    _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    rows, c = x.numel() // x.shape[1], x.shape[1]
    ld = row_stride(dy)
    if ld is None:
        dy, ld = operand(dy), c
    dx = torch.empty_like(x) if input_grad else None
    plan = plan_of(x, True, dy, ld=ld)
    grad = torch.empty((4, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((plan["chunks"], 2, c), dtype=torch.float64, device=x.device)
    lib = _library()

    def run(partial_ptr, count_ptr, chunks, passes):
        launch(lib.batchnorm_backward, x, x.data_ptr(), dy.data_ptr(), None if dx is None else dx.data_ptr(),
               int(x.dtype == torch.float32), rows, c, ld, weight.data_ptr(), coef.data_ptr(), grad.data_ptr(),
               partial_ptr, count_ptr, int(relu), plan["v"], plan["tx"], plan["ty"], chunks, plan["chunk_len"],
               plan["map_chunks"], plan["map_chunk_len"], passes, stream_of(x))

    if mesh is None:
        run(partial.data_ptr(), None, plan["chunks"], SUMS | FINISH | MAP)
        dweight, dbias = grad[0], grad[1]
    else:
        run(partial.data_ptr(), None, plan["chunks"], SUMS)
        sums = partial.sum(0)  # this rank's [Σg, Σg(x - mean)]
        dweight, dbias = (sums[1] * coef[1].double()).float(), sums[0].float()
        if dx is not None:
            total = _ranks_sum(sums, rows, mesh)
            run(total.data_ptr(), total[2 * c:].data_ptr(), 1, FINISH | MAP)
    count("batchnorm.bwd_calls")
    return dx, dweight, dbias


class BatchNormReLU(torch.autograd.Function):
    """Train-mode BatchNorm (+ ReLU) on the kernels: keeps ``x``, ``weight``
    and the forward's ``coef`` for the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum, update, relu, mesh):
        y, coef = batch_norm_forward(x, weight, bias, running_mean, running_var, eps=eps, momentum=momentum,
                                     update=update, relu=relu, mesh=mesh)
        ctx.save_for_backward(x, weight, coef)
        ctx.relu, ctx.mesh = relu, mesh
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, coef = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dweight, dbias = batch_norm_backward(dy, x, weight, coef, relu=ctx.relu, input_grad=need[0],
                                                 mesh=ctx.mesh)
        return dx, dweight if need[1] else None, dbias if need[2] else None, *(None,) * 7


def batch_norm_train(x, weight, bias, running_mean, running_var, *, eps: float, momentum: float, update: bool,
                     relu: bool, mesh=None) -> torch.Tensor:
    """Train-mode BatchNorm (+ ReLU), its statistics over ``mesh``'s data
    group where given: the kernels on a CUDA tensor (copied first where
    :func:`operand` says), the plain version elsewhere."""
    if x.device.type != "cuda":
        return batch_norm_train_plain(x, weight, bias, running_mean, running_var, eps=eps, momentum=momentum,
                                      update=update, relu=relu, mesh=mesh)
    return BatchNormReLU.apply(operand(x), weight, bias, running_mean, running_var, eps, momentum, update, relu,
                               mesh)


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.batchnorm_forward.argtypes = [p, p, i, q, i] + [p] * 7 + [i, i, f, f, f, i, i, i, i, q, i, q, i, p]
        lib.batchnorm_forward.restype = i
        lib.batchnorm_backward.argtypes = [p, p, p, i, q, i, q] + [p] * 5 + [i, i, i, i, i, q, i, q, i, p]
        lib.batchnorm_backward.restype = i
        lib.batchnorm_occupancy.argtypes = [i] * 5
        lib.batchnorm_occupancy.restype = i
        _lib = lib
    return _lib

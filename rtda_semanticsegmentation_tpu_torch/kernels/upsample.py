"""The bilinear resize's backward as a CUDA kernel: a gather, not a scatter.

``F.interpolate(x, size, mode="bilinear", align_corners=False)``, the port's
``models/layers.py::resize_bilinear``, reads along each axis of ``n_in``
inputs and ``n_out`` outputs, for output index ``o``, inputs ``i0`` and
``i1`` with weights ``l0`` and ``l1``::

    src = max(0, (o + 0.5) * (n_in / n_out) - 0.5)       each operation rounded in f32
    i0 = floor(src),  i1 = i0 + (i0 < n_in - 1),  l1 = src - i0,  l0 = 1 - l1

:func:`upsample_bilinear_bwd` computes its adjoint, the input gradient from
the output gradient ``dy``: ``dx = Mh^T dy Mw`` per image and channel, with
``Mh`` (Ho, Hi) and ``Mw`` (Wo, Wi) the interpolation matrices
(:func:`interp_matrix`). On a CPU tensor it runs
:func:`upsample_bilinear_bwd_plain`, those two matrix products (W first, as
the kernel) in f32, or in f64 for an f64 gradient; on a CUDA tensor it
launches the kernel in ``csrc/upsample.cu`` (built on first use, see
:mod:`.build`) or raises.

It replaces no TPU kernel (the JAX package's resize is
``jax.image.resize``, left to XLA). PyTorch's own backward of the resize
scatters each output-gradient element into four input pixels with atomics,
rounding every add in bf16 for a bf16 gradient, and was the flagship train
step's largest device operation. The kernel gathers: it reads ``dy`` once,
sums in f32, rounds once and writes ``dx`` once, with no atomics, so it
gives the same bits on every run.

Layouts (:func:`layout_of`): ``dy`` bf16 or f32, (N, C, Ho, Wo) with a
16-byte aligned base and either channel stride 1 (``channels_last`` memory,
or a channel slice of it such as the gradient of one input of a
``torch.cat``) or W stride 1 (contiguous NCHW). ``dx`` comes in the memory
format asked for (by default ``channels_last`` where ``dy``'s channels are
innermost). :func:`launch_plan` chooses, from the shape, the channel count
and the ratio per axis, a block's tile of channels and input columns, its
band of input rows and its threads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.spans import count, module_counters
from .build import load_library, sm_count

SOURCE = "csrc/upsample.cu"

# Launches of the CUDA kernel in this process (the plain version never
# counts), and the copies :func:`operand` made of a gradient the kernel does
# not take as it is, read as ``bwd_launches`` and ``copies``: counters
# ``upsample.*`` of ``obs/spans.py``.
__getattr__ = module_counters("upsample", ("bwd_launches", "copies"))

TILED, MERGED, ROWS = 0, 1, 2  # how a row's tile comes into shared memory (csrc/upsample.cu Layout)
_DTYPES = (torch.bfloat16, torch.float32)
_THREADS = 256  # at most, a block
_ELEMS = (1, 2, 4, 8)  # elements (column, channel) a thread may own
_TILE = 1024  # elements a block's tile holds, about: 4 a thread
_ROWS_CHANNELS = 32  # at most, channels a ROWS tile holds
_STAGES = 4  # output rows in shared memory at once (csrc/upsample.cu kStages)
_MAX_SMEM = 232448  # bytes of dynamic shared memory an H100 block may use
_SM_SMEM = 233472  # bytes of shared memory of one H100 SM, for all its blocks
_BLOCK_RESERVED = 1024  # bytes the runtime keeps per block
_SM_THREADS = 2048
_lib = None


def source_index(n_in: int, n_out: int, dtype=torch.float32, device="cpu"):
    """Per output index of an axis: (i0, a, b), the lower input index and
    the weights onto ``i0`` and ``i0 + 1`` (at the last input index, where
    ``i1 = i0``, ``a = l0 + l1`` and ``b = 0``), computed in ``dtype`` as
    PyTorch's resize computes them and as the kernel does in f32."""
    scale = torch.tensor(float(n_in), dtype=dtype) / torch.tensor(float(n_out), dtype=dtype)
    o = torch.arange(n_out, dtype=dtype, device=device)
    src = (scale.to(device) * (o + 0.5) - 0.5).clamp_min(0)
    i0 = src.to(torch.int64)
    l1 = src - i0.to(dtype)
    l0 = 1 - l1
    last = i0 >= n_in - 1
    return i0, torch.where(last, l0 + l1, l0), torch.where(last, torch.zeros_like(l1), l1)


def interp_matrix(n_in: int, n_out: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(n_out, n_in): the resize along one axis is ``M @ x``."""
    i0, a, b = source_index(n_in, n_out, dtype, device)
    m = torch.zeros((n_out, n_in), dtype=dtype, device=device)
    rows = torch.arange(n_out, device=device)
    m[rows, i0] = a
    m[rows, (i0 + 1).clamp_max(n_in - 1)] += b  # b = 0 where i0 + 1 is clamped
    return m


def _check(dy, in_hw) -> Tuple[int, int]:
    if dy.dim() != 4:
        raise ValueError(f"dy must be (N, C, Ho, Wo), got {tuple(dy.shape)}")
    hi, wi = (int(v) for v in in_hw)
    ho, wo = dy.shape[2], dy.shape[3]
    if not (1 <= hi <= ho and 1 <= wi <= wo):
        raise ValueError(f"the resize's backward takes an upsample only: {(hi, wi)} -> {(ho, wo)}")
    return hi, wi


def memory_format_of(t: torch.Tensor) -> torch.memory_format:
    """``channels_last`` where ``t``'s channels are innermost, else
    contiguous: the format the input gradient of ``t`` comes in."""
    return torch.channels_last if t.stride(1) == 1 and t.shape[1] > 1 else torch.contiguous_format


def upsample_bilinear_bwd_plain(dy, in_hw, memory_format: Optional[torch.memory_format] = None,
                                exact: bool = False) -> torch.Tensor:
    """The adjoint in plain PyTorch, on any device and dtype: the two matrix
    products, W first, in f32 (f64 for an f64 ``dy``), rounded once. The
    weights are those the resize's forward uses for ``dy``'s dtype (f32,
    f64 for f64). With ``exact`` the products are taken in f64 and returned
    in f64: the reference the kernel is held to."""
    hi, wi = _check(dy, in_hw)
    weights = torch.float64 if dy.dtype == torch.float64 else torch.float32
    acc = torch.float64 if exact else weights
    mh = interp_matrix(hi, dy.shape[2], weights, dy.device).to(acc)
    mw = interp_matrix(wi, dy.shape[3], weights, dy.device).to(acc)
    dx = torch.matmul(mh.t(), torch.matmul(dy.to(acc), mw))
    return dx.to(acc if exact else dy.dtype).contiguous(memory_format=memory_format or memory_format_of(dy))


def _strides(t: torch.Tensor) -> list:
    """``t``'s strides in elements, 0 along a dimension of size 1."""
    return [s if d > 1 else 0 for d, s in zip(t.shape, t.stride())]


def layout_of(dy: torch.Tensor) -> Optional[int]:
    """How the kernel reads ``dy``, or None where it does not take it:
    ROWS where W is innermost, TILED where the channels are innermost and
    every stride and the channel count keep 16-byte runs aligned, MERGED
    where the channels are innermost and each row's (Wo, C) span is
    contiguous (a tile of at most 2048 elements then holds all C channels of
    a column)."""
    if dy.dim() != 4 or dy.dtype not in _DTYPES or dy.data_ptr() % 16:
        return None
    _, c, _, wo = dy.shape
    sn, sc, sh, sw = _strides(dy)
    v = 16 // dy.element_size()
    if wo == 1 or sw == 1:
        return ROWS
    if c == 1 or sc == 1:
        if c % v == 0 and sn % v == 0 and sh % v == 0 and sw % v == 0:
            return TILED
        if sw == c and c <= _THREADS * _ELEMS[-1]:
            return MERGED
    return None


@functools.lru_cache(maxsize=None)
def _first_outputs(n_in: int, n_out: int) -> np.ndarray:
    """``f[k + 1]``: the first output index whose i0 is at least ``k``, for
    ``k`` = -1 .. n_in (n_out if none), as the kernel finds it."""
    i0 = source_index(n_in, n_out)[0].numpy()
    return np.searchsorted(i0, np.arange(-1, n_in + 1), side="left")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, c: int, in_hw: Tuple[int, int], out_hw: Tuple[int, int], layout: int, elem_bytes: int,
                sms: int, per_sm: Optional[int] = None) -> dict:
    """A launch on (n, c) images of ``out_hw`` -> ``in_hw``: ``tc`` channels
    and ``tw`` input columns a tile (about ``_TILE`` elements: all channels
    for MERGED, runs of up to 64 for TILED, up to 32 channels for ROWS),
    ``bh`` input rows a band (as many bands as one wave of blocks holds on
    ``sms`` SMs of ``per_sm`` blocks: a second wave would run a few blocks
    alone, and taller bands read fewer halo rows twice), ``taps`` (the most
    output columns that touch one input column), ``span`` (the most output
    columns a tile reads), the stage's ``pitch`` and ``stage_elems``, ``e``
    elements a thread of ``threads``, and the block's ``smem`` bytes.
    Without ``per_sm`` (the kernel's occupancy, which :func:`plan_of` asks
    the card for) it is estimated from the threads and the shared memory."""
    (hi, wi), (ho, wo) = in_hw, out_hw
    v = 16 // elem_bytes
    if layout == TILED:
        tc = max(t for t in (64, 32, 16, 8, 4) if t % v == 0 and c % t == 0)
    elif layout == MERGED:
        tc = c
    else:
        tc = -(-c // -(-c // _ROWS_CHANNELS))
    tw = max(1, min(wi, _TILE // tc))
    ntw = -(-wi // tw)
    tw = -(-wi // ntw)
    f = _first_outputs(wi, wo)
    span = int(max(f[min(iw0 + tw, wi) + 1] - f[iw0] for iw0 in range(0, wi, tw)))
    taps = int((f[2:] - f[:-2]).max())
    pitch = 0
    if layout == TILED:
        stage = span * tc
    elif layout == MERGED:
        stage = _round_up(span * c + v - 1, v)
    else:
        # an odd number of 16-byte chunks between the channels' runs, so the
        # threads of one column (channel after channel) spread over 8 banks,
        # not 4
        pitch = _round_up(span + v - 1, v)
        pitch += v * (pitch // v % 2 == 0)
        stage = tc * pitch
    stage = _round_up(stage, 8)
    e = next((e for e in _ELEMS if e * _THREADS >= tw * tc), None)
    if e is None:
        raise ValueError(f"a tile of {tw} x {tc} elements exceeds a block's {_THREADS} x {_ELEMS[-1]}")
    threads = _round_up(-(-tw * tc // e), 32)
    smem = _STAGES * stage * elem_bytes + (taps + 2) * tw * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"the resize's backward needs {smem} bytes of shared memory for {out_hw} -> {in_hw} "
                         f"at {c} channels, above {_MAX_SMEM}")
    per_sm = per_sm or max(1, min(_SM_THREADS // threads, _SM_SMEM // (smem + _BLOCK_RESERVED)))
    bands = max(1, min(hi, sms * per_sm // (n * ntw * -(-c // tc))))
    bh = -(-hi // bands)
    return {"layout": layout, "tc": tc, "tw": tw, "bh": bh, "taps": taps, "span": span, "pitch": pitch,
            "stage_elems": stage, "e": e, "threads": threads, "smem": smem}


def operand(dy: torch.Tensor) -> torch.Tensor:
    """``dy`` as the kernel takes it: itself on the CPU or where
    :func:`layout_of` takes it, else a contiguous NCHW copy (counted in
    ``copies``)."""
    if dy.device.type != "cuda" or dy.dtype not in _DTYPES or layout_of(dy) is not None:
        return dy
    count("upsample.copies")
    return dy.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _occupancy(f32: int, e: int, threads: int, smem: int) -> int:
    """Blocks of the kernel an SM holds at once (its registers included)."""
    blocks = _library().upsample_bwd_occupancy(f32, e, threads, smem)
    if blocks < 1:
        raise RuntimeError(f"the resize's backward kernel fits no SM at {threads} threads and {smem} bytes")
    return blocks


def plan_of(dy: torch.Tensor, in_hw, layout: int) -> dict:
    """:func:`launch_plan` for a CUDA ``dy`` read in ``layout``, its bands
    sized by the kernel's occupancy on ``dy``'s card."""
    n, c, ho, wo = dy.shape
    sms = sm_count(dy.device.index or 0)
    plan = launch_plan(n, c, tuple(in_hw), (ho, wo), layout, dy.element_size(), sms)
    per_sm = _occupancy(int(dy.dtype == torch.float32), plan["e"], plan["threads"], plan["smem"])
    return launch_plan(n, c, tuple(in_hw), (ho, wo), layout, dy.element_size(), sms, per_sm)


def upsample_bilinear_bwd(dy: torch.Tensor, in_hw, memory_format: Optional[torch.memory_format] = None
                          ) -> torch.Tensor:
    """(N, C, Ho, Wo) gradient of the resize's output -> (N, C, Hi, Wi)
    gradient of its input, in ``memory_format`` (default:
    :func:`memory_format_of` ``dy``)."""
    hi, wi = _check(dy, in_hw)
    memory_format = memory_format or memory_format_of(dy)
    if dy.device.type == "cpu":
        return upsample_bilinear_bwd_plain(dy, (hi, wi), memory_format)
    if dy.device.type != "cuda":
        raise ValueError(f"upsample_bilinear_bwd runs on CPU or CUDA tensors, got {dy.device}")
    if dy.dtype not in _DTYPES:
        raise ValueError(f"the resize's backward kernel takes bf16 or f32, got {dy.dtype}")
    layout = layout_of(dy)
    if layout is None:
        raise ValueError(f"the resize's backward kernel takes dy with channel stride 1 or W stride 1 and a "
                         f"16-byte aligned base, got strides {dy.stride()}")
    n, c, ho, wo = dy.shape
    if n > 65535:
        raise ValueError(f"the resize's backward kernel takes at most 65535 images, got {n}")
    dx = torch.empty((n, c, hi, wi), dtype=dy.dtype, device=dy.device, memory_format=memory_format)
    if dx.numel() == 0:
        return dx
    plan = plan_of(dy, (hi, wi), layout)
    sizes, strides = dy.shape, _strides(dy)
    limit = 1 + sum((d - 1) * s for d, s in zip(sizes, strides))
    lib = _library()
    with torch.cuda.device(dy.device):
        err = lib.upsample_bwd_launch(
            dy.data_ptr(), dx.data_ptr(), int(dy.dtype == torch.float32), n, c, hi, wi, ho, wo,
            *strides, *_strides(dx), limit, layout, plan["tc"], plan["tw"], plan["bh"], plan["taps"],
            plan["pitch"], plan["stage_elems"], plan["e"], plan["threads"], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"upsample_bilinear_bwd launch failed: CUDA error {err}")
    count("upsample.bwd_launches")
    return dx


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.upsample_bwd_launch.argtypes = [p, p] + [i] * 7 + [q] * 9 + [i] * 9 + [p]
        lib.upsample_bwd_launch.restype = i
        lib.upsample_bwd_occupancy.argtypes = [i] * 4
        lib.upsample_bwd_occupancy.restype = i
        _lib = lib
    return _lib

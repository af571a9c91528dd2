"""Binned Lovász histogram (K1) and backward (K2) as CUDA kernels.

Counterparts of ``rtda_semanticsegmentation_tpu/ops/pallas_lovasz.py``:
``lovasz_radix_hist`` (K1) and ``lovasz_radix_bwd`` (K2). Both take the
probabilities as ``(B, C, N)`` f32, the layout of the port's NCHW
softmax, so class rows are contiguous per image and no transpose is
needed; at ``B == 1`` that is exactly the JAX package's ``(C, P)``.

Per class ``c`` and valid pixel (``label != ignore``), with
``fg = label == c``, ``e = |fg - p|`` and bucket
``k = min(int(e * bins), bins - 1)``:

- :func:`lovasz_hist` sums, into ``(C, 3, bins)`` f32, the count, the
  foreground count and the bf16-rounded ``e`` of bucket ``k``;
- :func:`lovasz_bwd` writes ``table[c, k] * (1 - 2 fg)`` per pixel, the
  table rounded to bf16; with ``interp`` the table is ``(C, 2, bins)`` and
  a pixel reads row 0 if it is foreground, row 1 if not. Invalid pixels get
  0.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel in ``csrc/lovasz.cu`` (built on first use,
see :mod:`.build`) or raises. ``ignore=-1`` stands for "no ignore label".

On the card both kernels keep their per-class tables in one block's shared
memory: where all classes' tables do not fit, they split the classes into
groups, one group per block row (:func:`class_groups` for K1,
:func:`bwd_class_groups` for K2), still one launch each. A group holds at
most 32 classes (the probabilities or runs a thread keeps in registers), so
any class count runs. Up to ``MAX_BINS`` = 16384 bins, the largest power of
two whose one-class table fits a block; above it the wrappers raise.

K1 sums in integers: counts exactly, the error sums as ``FIX_BITS`` = 40
bit fixed-point numbers. Each error term is bf16(e) on the grid of
multiples of ``2**-(log2(bins) + 16)`` (terms of bucket 0 round to it; the
others lie on it already), so every partial sum the kernel forms is exact
and its integer histogram is the sum of every term's own value: the same
bits on every run and however the pixels are cut into launches or ranks.
:func:`lovasz_hist_raw` returns that integer histogram (``RAW_ROWS`` int64
rows: count, fg count and the error sum * 2**40 as two 32-bit limbs),
which adds across launches and ranks by a plain integer sum (an
``all_reduce``); :func:`finalize_hist` rounds a total once to f32, as the
kernel's own last block does. One launch takes at most ``MAX_PIXELS`` =
2**24 - 1 pixels (B * N: its u64 error sums); :func:`hist_chunks` cuts a
larger call along B, or along N for one image above the limit.
:func:`hist_plan` says how a launch is cut into blocks: 4 pixels a thread
where the rows allow 16-byte loads, and blocks of at most 65535 pixels
(each bin's count and foreground count share one 32-bit word of shared
memory).
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

SOURCE = "csrc/lovasz.cu"

# Launches of the CUDA kernels in this process; the plain versions never count.
hist_launches = 0
bwd_launches = 0

_THREADS = 256
_MAX_GROUP = 32  # classes of one block's group (csrc/lovasz.cu kMaxClasses)
_SMALL_GROUP = 20  # K1 groups of up to 20 classes run 3 blocks to an SM, larger ones 2 (kSmallGroup)
FIX_BITS = 40  # K1's error sums: fixed point, s * 2**40
MAX_PIXELS = 2**24 - 1  # K1, per launch: so many errors of at most 1.0 fit a u64 sum at FIX_BITS
RAW_ROWS = 4  # the integer histogram: count, fg count, error sum's low and high 32-bit limbs
_LIMB = 2**32 - 1
_BLOCK_PIXELS = 65535  # K1: pixels a block may take (16-bit counts in shared memory)
MAX_BINS = 16384  # the largest power of two whose one-class table fits a block, for both kernels
_MAX_SMEM = 232448  # bytes of dynamic shared memory an H100 block may use
_SM_SMEM = 233472  # bytes of shared memory of one H100 SM, for all its blocks
_BLOCK_RESERVED = 1024  # bytes the runtime keeps per block
_lib = None


def _check(probas, labels, bins):
    if probas.dtype != torch.float32 or probas.dim() != 3:
        raise ValueError(f"probas must be (B, C, N) f32, got {probas.dtype} {tuple(probas.shape)}")
    b, c, n = probas.shape
    if labels.dtype != torch.int32 or tuple(labels.shape) != (b, n):
        raise ValueError(f"labels must be ({b}, {n}) int32, got {labels.dtype} {tuple(labels.shape)}")
    if bins <= 0 or bins & (bins - 1):
        raise ValueError(f"lovasz bins must be a power of two, got {bins}")
    return b, c, n


def _buckets(probas, labels, bins, ignore):
    """(fg, e, bucket, valid) per (image, class, pixel), as both kernels
    compute them."""
    c = probas.shape[1]
    classes = torch.arange(c, device=probas.device, dtype=torch.int32).view(1, c, 1)
    fg = labels.unsqueeze(1) == classes
    e = (fg.to(torch.float32) - probas).abs()
    k = (e * bins).to(torch.int32).clamp_(0, bins - 1)
    valid = (labels != ignore).unsqueeze(1).expand_as(fg)
    return fg, e, k, valid


def lovasz_hist_raw_plain(probas, labels, bins: int, ignore: int) -> torch.Tensor:
    """K1's integer histogram in plain PyTorch, on any device: (``RAW_ROWS``,
    C, bins) int64, the count, the foreground count and each error term's
    fixed-point value ``rint(bf16(e) * bins * 2**16) * 2**(24 - log2(bins))``
    (= the term on the kernel's grid times 2**40) summed as two 32-bit limbs
    by ``index_add_``. Integer sums, so the kernel's must equal them."""
    _, c, _ = _check(probas, labels, bins)
    shift = 24 - (bins.bit_length() - 1)
    if shift < 0:
        raise ValueError(f"the fixed-point error sums take at most 2**24 bins, got {bins}")
    fg, e, k, valid = _buckets(probas, labels, bins, ignore)
    idx = (torch.arange(c, device=probas.device).view(1, c, 1) * bins + k)[valid]
    units = torch.round(e.to(torch.bfloat16).to(torch.float32)[valid] * float(bins * 65536))
    fixed = units.to(torch.int64) << shift
    size = c * bins
    raw = torch.zeros((RAW_ROWS, size), dtype=torch.int64, device=probas.device)
    raw[0] = torch.bincount(idx, minlength=size)
    raw[1] = torch.bincount(idx[fg[valid]], minlength=size)
    raw[2].index_add_(0, idx, fixed & _LIMB)
    raw[3].index_add_(0, idx, fixed >> 32)
    return raw.view(RAW_ROWS, c, bins)


def finalize_hist(raw: torch.Tensor) -> torch.Tensor:
    """(``RAW_ROWS``, C, bins) int64 integer histogram, a sum of any number
    of launches' or ranks' -> (C, 3, bins) f32: counts converted, each
    error sum carried into one integer, rounded to the nearest f64, scaled
    by 2**-40 and rounded to f32, as the kernel's last block converts its
    u64 sums (``double(u64) * 2^-40`` to float)."""
    lo = raw[2]
    hi = raw[3] + (lo >> 32)  # below 2**53: exact in f64
    err = (hi.to(torch.float64) * 2.0**32 + (lo & _LIMB).to(torch.float64)) * 2.0**-FIX_BITS
    return torch.stack([raw[0].to(torch.float32), raw[1].to(torch.float32), err.to(torch.float32)], dim=1)


def lovasz_hist_plain(probas, labels, bins: int, ignore: int) -> torch.Tensor:
    """K1 in plain PyTorch, on any device: its integer histogram
    (:func:`lovasz_hist_raw_plain`) finalized. The kernel's result must be
    the same bits."""
    return finalize_hist(lovasz_hist_raw_plain(probas, labels, bins, ignore))


def _check_table(table, c, bins, interp):
    want = (c, 2, bins) if interp else (c, bins)
    if table.dtype != torch.float32 or tuple(table.shape) != want:
        raise ValueError(f"table must be f32 {want}, got {table.dtype} {tuple(table.shape)}")


def lovasz_bwd_plain(probas, labels, table, bins: int, ignore: int, interp: bool) -> torch.Tensor:
    """K2 in plain PyTorch, on any device: a gather from the bf16-rounded
    table. Every operation is exact in f32, so the kernel must match it bit
    for bit."""
    _, c, n = _check(probas, labels, bins)
    _check_table(table, c, bins, interp)
    fg, _, k, valid = _buckets(probas, labels, bins, ignore)
    tab = table.to(torch.bfloat16).to(torch.float32).reshape(-1)
    rows = torch.arange(c, device=probas.device).view(1, c, 1)
    if interp:
        rows = rows * 2 + (~fg).to(torch.int64)
    coef = tab[rows * bins + k]
    out = coef * (1.0 - 2.0 * fg.to(torch.float32))
    return torch.where(valid, out, torch.zeros((), device=probas.device))


def _cuda_operands(probas, labels, *extra):
    for t in (labels, *extra):
        if t.device != probas.device:
            raise ValueError(f"all operands must be on {probas.device}, got {t.device}")
    for t in (probas, labels, *extra):
        if not t.is_contiguous():
            raise ValueError("the Lovász kernels need contiguous operands")
    if probas.numel() >= 2**31:
        raise ValueError("too many elements for the kernels' 32-bit indices")


def _grid(device, per_sm: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


def _groups(c: int, row_bytes: int, max_per_sm: int) -> tuple:
    """(classes per group, groups, blocks of one group that fit on an SM)
    for a per-class table of ``row_bytes`` in one block's shared memory: the
    fewest groups whose table fits, with at most ``_MAX_GROUP`` classes
    each."""
    groups = -(-c // min(_MAX_GROUP, _MAX_SMEM // row_bytes))
    cg = -(-c // groups)
    per_sm = max(1, min(max_per_sm, _SM_SMEM // (cg * row_bytes + _BLOCK_RESERVED)))
    return cg, -(-c // cg), per_sm


def _check_bins(bins: int) -> None:
    if bins > MAX_BINS:
        raise ValueError(f"the Lovász kernels take at most {MAX_BINS} bins (one class's table must fit "
                         f"a block's {_MAX_SMEM} bytes of shared memory), got {bins}")


def class_groups(c: int, bins: int) -> tuple:
    """(classes per group, groups, blocks of one group that fit on an SM):
    K1 splits the classes into the fewest groups whose (cg, bins) histogram
    of 12-byte entries (a u64 error sum, a u32 count and fg count) fits one
    block's shared memory; at 256 bins (58 KB for 19 classes) that is one
    group, three blocks to an SM; two for groups of more than 20 classes
    (the registers of their per-class runs)."""
    _check_bins(bins)
    cg, groups, per_sm = _groups(c, 3 * bins * 4, 3)
    return cg, groups, per_sm if cg <= _SMALL_GROUP else min(per_sm, 2)


def hist_plan(b: int, c: int, n: int, bins: int, sms: int, aligned: bool = True) -> tuple:
    """(pixels a thread takes at a time, classes per group, groups, blocks
    per group) of a K1 launch on (b, c, n) probabilities on a card of
    ``sms`` SMs: 4 pixels (16-byte loads) where ``n`` is a multiple of 4 and
    the operands are 16-byte ``aligned``, else 1; one wave of blocks over
    all the groups, but at least enough that no block takes more than 65535
    pixels, and no more than one thread per load. Raises above
    ``MAX_PIXELS`` (:func:`hist_chunks` cuts a larger call first)."""
    if b * n > MAX_PIXELS:
        raise ValueError(f"one Lovász histogram launch takes at most {MAX_PIXELS} pixels (2**24 - 1: its u64 "
                         f"error sums at {FIX_BITS} fixed-point bits), got {b * n}")
    cg, groups, per_sm = class_groups(c, bins)
    vec = 4 if aligned and n % 4 == 0 else 1
    items = b * n // vec
    # a block takes at most ceil(items / (blocks * threads)) * threads items
    cap = _BLOCK_PIXELS // vec // _THREADS * _THREADS
    blocks = max(sms * per_sm // groups, -(-items // cap))
    return vec, cg, groups, max(1, min(blocks, -(-items // _THREADS)))


def bwd_class_groups(c: int, bins: int, interp: bool = True) -> tuple:
    """(classes per group, groups, blocks of one group that fit on an SM):
    K2 splits the classes into the fewest groups whose ((2 if interp else
    1), cg, bins) f32 table fits one block's shared memory: for 19 classes
    one group up to 1024 bins, 2 groups of 10 at 2048, 3 of 7 at 4096."""
    _check_bins(bins)
    return _groups(c, (2 if interp else 1) * bins * 4, 4)


def hist_chunks(b: int, n: int) -> list:
    """K1's launches for (b, ·, n) probabilities: ``(b0, b1, n0, n1)``
    slices of at most ``MAX_PIXELS`` pixels each. Whole images where one
    fits (the fewest launches, their images spread evenly), else each image
    cut along N into even pieces."""
    if b * n <= MAX_PIXELS:
        return [(0, b, 0, n)]
    if n <= MAX_PIXELS:
        launches = -(-b // (MAX_PIXELS // n))
        per = -(-b // launches)
        return [(b0, min(b0 + per, b), 0, n) for b0 in range(0, b, per)]
    most = MAX_PIXELS // 4 * 4  # pieces of a multiple of 4 pixels: 16-byte loads where the rows allow them
    pieces = -(-n // most)
    per = -(-(-(-n // pieces)) // 4) * 4
    return [(i, i + 1, n0, min(n0 + per, n)) for i in range(b) for n0 in range(0, n, per)]


def _launch_hist(probas, labels, bins: int, ignore: int, out) -> torch.Tensor:
    """One K1 launch; returns its workspace, which holds the integer
    histogram where ``out`` is None (else the launch finalizes into
    ``out``)."""
    b, c, n = _check(probas, labels, bins)
    _cuda_operands(probas, labels)
    aligned = probas.data_ptr() % 16 == 0 and labels.data_ptr() % 16 == 0
    vec, cg, _, blocks = hist_plan(b, c, n, bins, _grid(probas.device, 1), aligned)
    ws = torch.empty(2 * c * bins + 1, device=probas.device, dtype=torch.int64)  # zeroed by the launch
    lib = _library()
    with torch.cuda.device(probas.device):
        err = lib.lovasz_hist_launch(
            probas.data_ptr(), labels.data_ptr(), ws.data_ptr(), None if out is None else out.data_ptr(),
            b, c, n, bins, ignore, blocks, cg, int(vec == 4), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lovasz_hist launch failed: CUDA error {err}")
    global hist_launches
    hist_launches += 1
    return ws


def _device_check(probas, what: str) -> bool:
    """True on a CPU tensor (the plain version runs), False on a CUDA one."""
    if probas.device.type == "cpu":
        return True
    if probas.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {probas.device}")
    return False


def lovasz_hist_raw(probas, labels, bins: int, ignore: int) -> torch.Tensor:
    """K1's integer histogram, (``RAW_ROWS``, C, bins) int64: on the card one
    launch per :func:`hist_chunks` slice, each leaving its u64 sums, split
    into 32-bit limbs and added in int64. Sums of these (across ranks)
    finalize with :func:`finalize_hist`."""
    if _device_check(probas, "lovasz_hist_raw"):
        return lovasz_hist_raw_plain(probas, labels, bins, ignore)
    b, c, n = _check(probas, labels, bins)
    raw = torch.zeros((RAW_ROWS, c * bins), dtype=torch.int64, device=probas.device)
    for b0, b1, n0, n1 in hist_chunks(b, n):
        p, lab = probas[b0:b1], labels[b0:b1]
        if (n0, n1) != (0, n):  # a piece of one image: its rows copied contiguous
            p, lab = p[:, :, n0:n1].contiguous(), lab[:, n0:n1].contiguous()
        ws = _launch_hist(p, lab, bins, ignore, None)
        cf, err = ws[: c * bins], ws[c * bins: 2 * c * bins]
        raw[0] += cf & _LIMB
        raw[1] += cf >> 32
        raw[2] += err & _LIMB
        raw[3] += (err >> 32) & _LIMB  # the u64 sum's high word (an arithmetic shift in int64)
    return raw.view(RAW_ROWS, c, bins)


def lovasz_hist(probas, labels, bins: int, ignore: int) -> torch.Tensor:
    """(B, C, N) f32 probabilities, (B, N) int32 labels -> (C, 3, bins) f32
    [count, fg count, sum of bf16(error)] per class and error bucket. On
    the card one launch that finalizes its own sums where B * N is at most
    ``MAX_PIXELS``, else :func:`lovasz_hist_raw`'s launches finalized once:
    the same bits either way, and on every run."""
    if _device_check(probas, "lovasz_hist"):
        return lovasz_hist_plain(probas, labels, bins, ignore)
    b, c, n = _check(probas, labels, bins)
    if b * n > MAX_PIXELS:
        return finalize_hist(lovasz_hist_raw(probas, labels, bins, ignore))
    out = torch.empty((c, 3, bins), device=probas.device, dtype=torch.float32)
    _launch_hist(probas, labels, bins, ignore, out)
    return out


def lovasz_bwd(probas, labels, table, bins: int, ignore: int, interp: bool) -> torch.Tensor:
    """(B, C, N) f32 gradient of the binned Lovász loss w.r.t. the
    probabilities, from the per-bucket coefficient ``table`` ((C, 2, bins)
    with ``interp``, else (C, bins); cotangent and normalization folded in)."""
    if _device_check(probas, "lovasz_bwd"):
        return lovasz_bwd_plain(probas, labels, table, bins, ignore, interp)
    b, c, n = _check(probas, labels, bins)
    _check_table(table, c, bins, interp)
    _cuda_operands(probas, labels, table)
    cg, groups, per_sm = bwd_class_groups(c, bins, interp)
    out = torch.empty_like(probas)
    # one wave over all the class groups
    blocks = max(1, min(_grid(probas.device, per_sm) // groups, -(-b * n // _THREADS)))
    lib = _library()
    with torch.cuda.device(probas.device):
        err = lib.lovasz_bwd_launch(
            probas.data_ptr(), labels.data_ptr(), table.data_ptr(), out.data_ptr(),
            b, c, n, bins, ignore, int(interp), blocks, cg, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lovasz_bwd launch failed: CUDA error {err}")
    global bwd_launches
    bwd_launches += 1
    return out


def _library():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.lovasz_hist_launch.argtypes = [p, p, p, p] + [i] * 8 + [p]
        lib.lovasz_hist_launch.restype = i
        lib.lovasz_bwd_launch.argtypes = [p, p, p, p] + [i] * 8 + [p]
        lib.lovasz_bwd_launch.restype = i
        _lib = lib
    return _lib

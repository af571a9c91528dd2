"""Segmentation losses (port of the JAX ``ops/losses.py``).

The port's logits and probabilities are NCHW: the class axis is 1, as in
PyTorch's own losses, where the JAX package's are channel-last. Every loss
computes in at least f32.

- :func:`cross_entropy_with_ignore`: ``nn.CrossEntropyLoss(ignore_index)``
  with the JAX package's reductions; an all-ignored batch gives 0.
- :func:`lovasz_softmax`: the exact descending-sort Lovász-Softmax, the
  parity path.
- :func:`lovasz_softmax_binned`: the counting-sort Lovász-Softmax of the main
  path. Its forward histograms run on kernel K1 and its backward on kernel
  K2 (``kernels/lovasz.py``); the post-processing over (C, bins) is plain
  PyTorch.
- :func:`bce_with_logits`: the discriminator's mean binary cross-entropy
  against a constant target.

Data parallel: given a ``mesh`` (a ``parallel.MeshContext``) of more than
one data index, each loss returns this rank's share of the global loss, the
JAX package's loss over the sharded batch: the shares sum over the data
group to the global value, and their gradients, summed over it, to the
global loss's gradient. CE ``mean`` divides by the global valid-pixel
count, ``mean_per_image`` by the global image count; the binned Lovász
loss sums K1's integer histograms over the data group (the exact global
histogram) and K2 runs on the local pixels with the global tables; the
exact-sort Lovász gathers the global probabilities; the BCE scales the
local mean by the rank's share of the batch. The ranks of one model group
(tensor parallel) hold the same rows and compute the same share: every sum
here runs over the data group, never over the world.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import lovasz as klov


def _shares(mesh) -> int:
    """The data indices the global batch is split over (1 without a mesh)."""
    return 1 if mesh is None else mesh.data_size


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy_with_ignore(logits, labels, ignore_index: int = 255, reduction: str = "mean", mesh=None):
    """Softmax cross-entropy over (B, C, ...) logits with an ignore label.

    ``reduction``: ``mean`` over every valid pixel of the batch,
    ``mean_per_image`` (the mean over each image's valid pixels, then over
    the images) or ``none`` (per-pixel losses, 0 at ignored pixels). With a
    ``mesh`` of several ranks the batch is the global one and the result
    this rank's share."""
    labels = labels.long()
    valid = labels != ignore_index
    pixel = F.cross_entropy(_at_least_f32(logits), torch.where(valid, labels, 0), reduction="none")
    pixel = torch.where(valid, pixel, torch.zeros((), dtype=pixel.dtype, device=pixel.device))
    if reduction == "none":
        return pixel
    if reduction == "mean":
        count = valid.sum()
        if _shares(mesh) > 1:
            count = mesh.sum_(count)
        return pixel.sum() / count.clamp_min(1)
    if reduction == "mean_per_image":
        b = pixel.shape[0]
        per_img = pixel.reshape(b, -1).sum(1) / valid.reshape(b, -1).sum(1).clamp_min(1)
        return per_img.mean() if _shares(mesh) == 1 else per_img.sum() / (b * mesh.data_size)
    raise ValueError(f"unknown reduction {reduction!r}")


def _class_rows(probas, labels, ignore_index):
    """(C, P) probabilities in at least f32, (P,) labels, (P,) validity."""
    c = probas.shape[1]
    rows = _at_least_f32(probas).transpose(0, 1).reshape(c, -1)
    labels = labels.reshape(-1)
    if ignore_index is None:
        valid = torch.ones_like(labels, dtype=torch.bool)
    else:
        valid = labels != ignore_index
    return rows, labels, valid


def _gathered(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch of a rank-local ``x``: each rank's rows written
    into a zero-filled global buffer and summed over the data group (gloo
    has no ``all_gather`` of CUDA tensors); the sum carries the gradient
    back to each rank's rows."""
    lo, total = mesh.rows(x.shape[0])
    rest = tuple(x.shape[1:])
    full = torch.cat([x.new_zeros((lo,) + rest), x, x.new_zeros((total - lo - x.shape[0],) + rest)])
    return mesh.sum(full)


def lovasz_softmax(probas, labels, ignore_index=255, classes: str = "present", mesh=None):
    """Exact Lovász-Softmax over (B, C, H, W) probabilities: each class's
    errors in descending order (a stable sort, ignored pixels last with no
    contribution), averaged over the classes present (``present``) or all
    classes (``all``). With a ``mesh`` of several ranks: the loss of the
    gathered global batch, this rank's share of it."""
    if classes not in ("present", "all"):
        raise ValueError(f"classes must be 'present' or 'all', got {classes!r}")
    if _shares(mesh) > 1:
        loss = lovasz_softmax(_gathered(probas, mesh), _gathered(labels, mesh), ignore_index, classes)
        return loss / mesh.data_size
    p, labels, valid = _class_rows(probas, labels, ignore_index)
    c = p.shape[0]
    validf = valid.to(p.dtype)
    fg = (labels.unsqueeze(0) == torch.arange(c, device=p.device).unsqueeze(1)).to(p.dtype) * validf
    errors = (fg - p).abs() * validf
    key = -torch.where(valid.unsqueeze(0), errors, torch.full_like(errors, -1.0))
    order = torch.sort(key.detach(), dim=1, stable=True).indices
    errors_sorted = errors.gather(1, order)
    fg_sorted = fg.gather(1, order)
    gts = fg.sum(1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(1)
    union = gts + (1.0 - fg_sorted).cumsum(1)
    jaccard = 1.0 - intersection / union
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)
    loss_c = (errors_sorted * grad).sum(1)
    present = (gts[:, 0] > 0).to(p.dtype) if classes == "present" else torch.ones_like(loss_c)
    present_cnt = present.sum()
    loss = (loss_c * present).sum() / present_cnt.clamp_min(1.0)
    return torch.where(present_cnt > 0, loss, torch.zeros_like(loss))


def _radix_factors(bins: int) -> tuple:
    """Factor the bin count into two near-square radices (k1 * k2 == bins)."""
    if bins <= 0 or bins & (bins - 1):
        raise ValueError(f"lovasz bins must be a power of two, got {bins}")
    k1 = 1
    while k1 * k1 < bins:
        k1 *= 2
    return k1, bins // k1


def _kernel_operands(probas, labels, ignore_index):
    """(B, C, N) f32 probabilities, (B, N) int32 labels and the kernels'
    ignore label (-1 for none)."""
    b, c = probas.shape[:2]
    p = probas.reshape(b, c, -1).to(torch.float32).contiguous()
    lab = labels.reshape(b, -1).to(torch.int32).contiguous()
    return p, lab, -1 if ignore_index is None else ignore_index


def _binned_lovasz_forward(hists, classes: str, interp: bool):
    """Lovász post-processing of the K1 histograms ``(C, 3, bins)``: returns
    (loss, tables, present_cnt), the JAX package's
    ``_binned_lovasz_forward`` op for op.

    ``tables`` is (C, 2, bins), the fg/bg-split coefficients at each
    bucket's rank-span midpoint, with ``interp``; else (C, bins), the
    bucket-averaged coefficient. Both in ascending bucket order and zero for
    classes outside the mean."""
    if classes not in ("present", "all"):
        raise ValueError(f"classes must be 'present' or 'all', got {classes!r}")
    n = hists[:, 0].flip(1)
    f = hists[:, 1].flip(1)
    se = hists[:, 2].flip(1)
    gts = f.sum(1, keepdim=True)
    cn = n.cumsum(1)
    cf = f.cumsum(1)
    intersection = gts - cf
    union = gts + cn - cf
    zero = torch.zeros((), device=hists.device)
    jaccard = torch.where(union > 0, 1.0 - intersection / union.clamp_min(1.0), zero)
    delta = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)
    inv_n = torch.where(n > 0, 1.0 / n.clamp_min(1.0), zero)
    coef_desc = delta * inv_n
    loss_c = (se * coef_desc).sum(1)
    present = (gts[:, 0] > 0).to(torch.float32) if classes == "present" else torch.ones_like(loss_c)
    present_cnt = present.sum()
    loss = torch.where(present_cnt > 0, (loss_c * present).sum() / present_cnt.clamp_min(1.0), zero)
    if interp:
        cn0 = cn - n
        cf0 = cf - f
        um = gts + (cn0 - cf0) + 0.5 * (n - f)
        im = gts - cf0 - 0.5 * f
        ok = (n > 0) & ((cn0 - cf0 + gts) > 0)
        ums = um.clamp_min(0.5)
        c_fg = torch.where(ok, 1.0 / ums, coef_desc)
        c_bg = torch.where(ok, im / (ums * ums), coef_desc)
        tables = torch.stack([c_fg.flip(1) * present[:, None], c_bg.flip(1) * present[:, None]], dim=1)
        return loss, tables, present_cnt
    return loss, coef_desc.flip(1) * present[:, None], present_cnt


def lovasz_histograms(p, labels, bins: int, ignore: int, mesh=None) -> torch.Tensor:
    """K1's (C, 3, bins) histograms of the global batch from this rank's
    (B, C, N) f32 probabilities and (B, N) int32 labels: with a ``mesh`` of
    several data indices the integer sums added over the data group and
    finalized once, otherwise one call."""
    if _shares(mesh) > 1:
        return klov.finalize_hist(mesh.sum_(klov.lovasz_hist_raw(p, labels, bins, ignore)))
    return klov.lovasz_hist(p, labels, bins, ignore)


class LovaszSoftmaxBinned(torch.autograd.Function):
    """Forward: K1 histograms + post-processing. Backward: the cotangent and
    ``1 / present_cnt`` fold into the tables, then K2. Gradient for the
    probabilities only.

    With a ``mesh`` of several data indices the histograms are K1's integer
    sums added over the data group and finalized once, the exact global
    histogram, so every rank holds the same loss L and tables. The forward
    returns the share L / data_size; the backward gives the local pixels
    their gradient of L, so that the data group's gradients sum to the
    global one."""

    @staticmethod
    def forward(ctx, probas, labels, ignore_index, classes, bins, interp, mesh=None):
        p, lab, ignore = _kernel_operands(probas, labels, ignore_index)
        hists = lovasz_histograms(p, lab, bins, ignore, mesh)
        loss, tables, present_cnt = _binned_lovasz_forward(hists, classes, interp)
        ctx.save_for_backward(p, lab, tables, present_cnt)
        ctx.meta = (probas.shape, probas.dtype, ignore, bins, interp)
        return loss / _shares(mesh) if _shares(mesh) > 1 else loss

    @staticmethod
    def backward(ctx, g):
        p, lab, tables, present_cnt = ctx.saved_tensors
        shape, dtype, ignore, bins, interp = ctx.meta
        scale = torch.where(present_cnt > 0, g / present_cnt.clamp_min(1.0), torch.zeros_like(g))
        grad = klov.lovasz_bwd(p, lab, (tables * scale).contiguous(), bins, ignore, interp)
        return grad.reshape(shape).to(dtype), None, None, None, None, None, None


def lovasz_softmax_binned(probas, labels, ignore_index=255, classes: str = "present",
                          bins: int = 256, interp: bool = True, mesh=None):
    """Counting-sort Lovász-Softmax over (B, C, H, W) probabilities:
    errors binned into ``bins`` equal-width buckets, processed in
    descending order; the JAX package's ``lovasz_softmax_binned`` with the
    same ``classes``, ``bins`` and ``interp`` semantics. With a ``mesh`` of
    several ranks: this rank's share of the global batch's loss."""
    _radix_factors(bins)
    return LovaszSoftmaxBinned.apply(probas, labels, ignore_index, classes, bins, interp, mesh)


def bce_with_logits(logits: torch.Tensor, targets, mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy with logits against a broadcast target, in
    at least f32, in the JAX package's stable form
    ``max(x, 0) - x z + log1p(exp(-|x|))`` (``torch.maximum`` splits the
    gradient at a tie as ``jnp.maximum`` does). With a ``mesh`` of several
    ranks, the local mean times the rank's share of the global batch."""
    x = _at_least_f32(logits)
    z = torch.as_tensor(targets, dtype=x.dtype, device=x.device)
    loss = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device)) - x * z
    mean = (loss + torch.log1p(torch.exp(-x.abs()))).mean()
    return mean if _shares(mesh) == 1 else mean / mesh.data_size

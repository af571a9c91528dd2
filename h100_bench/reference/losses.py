"""The losses in float32 (float64 for the Lovász histograms).

- :func:`cross_entropy`: softmax cross-entropy, mean over the pixels whose
  label is not ``ignore``.
- :func:`lovasz_binned`: the Lovász-Softmax (Berman et al., CVPR 2018,
  arXiv:1705.08790) over the classes present, with each class's errors
  counted into ``bins`` equal-width buckets instead of sorted. The loss is
  the Lovász extension over the buckets taken in descending order, each
  bucket's error sum weighted by its mean Jaccard step. Its gradient gives
  each pixel the coefficient of its bucket at the midpoint of the bucket's
  rank span, with the bucket's foreground pixels ranked after its
  background ones (``interp``), or the bucket's mean coefficient.
- :func:`bce_with_logits`: mean binary cross-entropy against a constant.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels, ignore: int):
    labels = labels.long()
    valid = labels != ignore
    pixel = F.cross_entropy(logits.float(), torch.where(valid, labels, 0), reduction="none")
    return (pixel * valid).sum() / valid.sum().clamp_min(1)


def _histograms(p, lab, fg, classes, bins):
    """Per class and bucket (ascending error): pixel count, foreground
    count and error sum, in float64; and each pixel's bucket."""
    e = (fg.to(p.dtype) - p).abs()
    k = (e * bins).long().clamp_(0, bins - 1)
    idx = (torch.arange(classes, device=p.device).view(-1, 1) * bins + k).reshape(-1)
    size = classes * bins
    n = torch.bincount(idx, minlength=size).double()
    f = torch.bincount(idx[fg.reshape(-1)], minlength=size).double()
    se = torch.zeros(size, dtype=torch.float64, device=p.device).index_add_(0, idx, e.reshape(-1).double())
    return n.view(classes, bins), f.view(classes, bins), se.view(classes, bins), k


def lovasz_binned(probas, labels, ignore: int, bins: int, interp: bool = True):
    """(B, C, H, W) probabilities, (B, H, W) labels -> the loss; its
    gradient is the binned one described in the module docstring."""
    c = probas.shape[1]
    p = probas.float().transpose(0, 1).reshape(c, -1)
    lab = labels.reshape(-1).long()
    valid = lab != ignore
    p, lab = p[:, valid], lab[valid]
    fg = lab.view(1, -1) == torch.arange(c, device=p.device).view(-1, 1)
    n, f, se, k = _histograms(p.detach(), lab, fg, c, bins)
    # descending order of error
    n, f, se = n.flip(1), f.flip(1), se.flip(1)
    gts = f.sum(1, keepdim=True)
    cn, cf = n.cumsum(1), f.cumsum(1)
    union = gts + cn - cf
    jac = torch.where(union > 0, 1.0 - (gts - cf) / union.clamp_min(1.0), torch.zeros_like(union))
    step = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=1)
    coef = torch.where(n > 0, step / n.clamp_min(1.0), torch.zeros_like(step))
    present = (gts[:, 0] > 0).double()
    count = present.sum().clamp_min(1.0)
    loss = ((se * coef).sum(1) * present).sum() / count
    if interp:
        cn0, cf0 = cn - n, cf - f
        mid_union = (gts + (cn0 - cf0) + 0.5 * (n - f)).clamp_min(0.5)
        mid_inter = gts - cf0 - 0.5 * f
        ok = (n > 0) & ((cn0 - cf0 + gts) > 0)
        c_fg = torch.where(ok, 1.0 / mid_union, coef)
        c_bg = torch.where(ok, mid_inter / mid_union.square(), coef)
    else:
        c_fg = c_bg = coef
    # back to ascending buckets, one coefficient per pixel
    c_fg, c_bg = c_fg.flip(1) * present[:, None] / count, c_bg.flip(1) * present[:, None] / count
    pix = torch.where(fg, c_fg.float().gather(1, k), c_bg.float().gather(1, k))
    # d|fg - p| / dp = 1 - 2 fg
    surrogate = (pix * (1.0 - 2.0 * fg.float()) * p).sum()
    return loss.float() + (surrogate - surrogate.detach())


def bce_with_logits(logits, target: float):
    x = logits.float()
    return (x.clamp_min(0) - x * target + torch.log1p(torch.exp(-x.abs()))).mean()

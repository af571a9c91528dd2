"""Building blocks of the reference, in float32.

The control precision, float8 e4m3, the step below the configurations'
bfloat16: inside ``activations(True)`` (the reference puts the
augmentation and the models' forwards there) every floating-point result
of every operation is rounded to float8 with one scale per tensor (the
largest magnitude maps to 448), and every conv and linear layer rounds its
weights too, as a program computing in float8 would; the losses, the
gradients' own arithmetic and the optimizer stay float32. The gradient
passes each rounding unchanged (straight through), so the backward reads
the rounded values the forward used.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convs in float32, not TF32; the flags
    are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale, with a
    straight-through gradient."""
    d = t.detach()
    scale = E4M3_MAX / d.abs().amax().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(d.dtype) / scale
    return t + (q - d)


_WIDE = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _rounded(out):
    if isinstance(out, torch.Tensor) and out.dtype in _WIDE and out.numel():
        return round_fp8(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_rounded(o) for o in out)
    return out


class _Float8(torch.overrides.TorchFunctionMode):
    """Every operation's floating-point results, and every conv's weights,
    rounded to float8 (the rounding itself runs outside the mode)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunction():
            if func in (F.conv2d, F.linear):
                args = (args[0], round_fp8(args[1]), *args[2:])
        out = func(*args, **(kwargs or {}))
        with torch._C.DisableTorchFunction():
            return _rounded(out)


def activations(fp8: bool):
    """The region the control computes in float8 (``fp8``); float32
    otherwise."""
    return _Float8() if fp8 else contextlib.nullcontext()


def batch_norm(x, params, name, train: bool, stats: dict, momentum: float = 0.9, eps: float = 1e-5):
    """BatchNorm over (N, H, W). Train: the batch's mean and biased
    variance normalize; the running statistics move by ``momentum`` (kept
    share; 0 takes the batch's) towards the batch mean and the unbiased
    variance, written into ``stats``. Eval: the running statistics
    normalize."""
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    rm, rv = f"{name}.running_mean", f"{name}.running_var"
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            stats[rm] = momentum * stats[rm] + (1 - momentum) * mean.detach()
            stats[rv] = momentum * stats[rv] + (1 - momentum) * var.detach() * n / max(n - 1, 1)
    else:
        mean, var = stats[rm], stats[rv]
    inv = w / torch.sqrt(var + eps)
    return x * inv.view(1, -1, 1, 1) + (b - mean * inv).view(1, -1, 1, 1)


def gap(x):
    """Global average pool, keeping the spatial axes."""
    return x.mean(dim=(2, 3), keepdim=True)


def upsample(x, size):
    """Bilinear, half-pixel centres (``align_corners=False``)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)

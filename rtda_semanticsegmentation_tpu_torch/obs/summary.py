"""Model summaries: a per-module parameter table and a per-module FLOP and
parameter table (port of the JAX package's ``obs/summary.py``).

:func:`model_summary_table` is the counterpart of the JAX package's
``flax.linen.tabulate`` table: per module down to ``depth``, its type, its
own parameters' shapes and the parameter and batch-statistics counts of
its subtree, with the totals.

The counterpart of the reference's fvcore ``flop_count_table(max_depth=3)``:
one forward under ``torch.utils.flop_counter.FlopCounterMode`` gives each
module's FLOPs (convolutions and matrix products), reported as
multiply-accumulates (fvcore's convention, 1 MAC = 1 FLOP), beside the
module's parameter count, rows down to ``depth``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .profiler import count_params, model_flops


def model_summary_table(model: torch.nn.Module, depth: int = 3) -> str:
    """Rows ``path | module | parameter shapes | #params | #batch stats``
    for the model and its submodules down to ``depth``; the last line is
    ``Total Parameters: N``, parameters and batch statistics (buffers)
    together, as flax's table counts them."""
    counts = {}
    for kind, named in (("params", model.named_parameters()), ("stats", model.named_buffers())):
        for name, t in named:
            path = tuple(name.split(".")[:-1])
            for i in range(min(len(path), depth) + 1):
                counts.setdefault(path[:i], {"params": 0, "stats": 0})[kind] += t.numel()
    rows = [("path", "module", "parameter shapes", "#params", "#batch stats")]
    for name, module in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if len(path) > depth or path not in counts:
            continue
        own = ", ".join(f"{n}: {list(p.shape)}" for n, p in module.named_parameters(recurse=False))
        c = counts[path]
        rows.append((name or "(model)", type(module).__name__, own, f"{c['params']:,}", f"{c['stats']:,}"))
    total = counts.get((), {"params": 0, "stats": 0})
    rows.append(("", "", "Total", f"{total['params']:,}", f"{total['stats']:,}"))
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    lines = [" | ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows]
    lines.insert(1, "-+-".join("-" * w for w in widths))
    lines.append(f"Total Parameters: {total['params'] + total['stats']:,}")
    return "\n".join(lines)


def flop_count_table(model: torch.nn.Module, input_shape: Sequence[int], depth: int = 3,
                     dtype=torch.float32) -> str:
    """The table for one eval forward of ``model`` on zeros of NCHW
    ``input_shape`` in ``dtype``, on the model's device."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(tuple(input_shape), dtype=dtype, device=next(model.parameters()).device)
    model.eval()
    with torch.inference_mode(), FlopCounterMode(display=False, depth=None) as counter:
        model(x)
    macs = {}
    for name, ops in counter.get_flop_counts().items():
        if name == "Global":
            continue
        path = tuple(name.split(".")[1:])  # the first component is the model's class
        macs[path] = sum(ops.values()) // 2
    params: dict = {(): 0}
    for name, p in model.named_parameters():
        path = tuple(name.split(".")[:-1])
        for i in range(len(path) + 1):
            params[path[:i]] = params.get(path[:i], 0) + p.numel()

    def fmt(n, unit, scale):
        return f"{n / scale:.3f}{unit}"

    rows = [("module", "#parameters", "#flops (MACs)")]
    for mod in sorted(set(params) | set(macs)):
        if len(mod) > depth:
            continue
        name = "model" if not mod else "  " * (len(mod) - 1) + mod[-1]
        p, f = params.get(mod, 0), macs.get(mod, 0)
        rows.append((name, fmt(p, "M", 1e6) if p else "", fmt(f, "G", 1e9) if f else "--"))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = [" | ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows]
    lines.insert(1, "-+-".join("-" * w for w in widths))
    return "\n".join(lines)


def flops_and_params(model: torch.nn.Module, input_shape: Sequence[int],
                     dtype=torch.bfloat16) -> Tuple[Optional[float], int]:
    """(total eval-forward FLOPs or None, parameter count)."""
    device = next(model.parameters()).device
    x = torch.zeros(tuple(input_shape), dtype=dtype, device=device)
    model.eval()
    with torch.inference_mode():
        flops = model_flops(model, x)
    return flops, count_params(model)

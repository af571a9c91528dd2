"""The numbers that decide ``correct``.

Train cells compare, against the reference's first steps:

- ``loss`` (and ``loss_d``): the largest relative gap of a step's loss;
- ``grad1``: the first gradient as the optimizer took it, leaf by leaf;
- ``change3``: each leaf's change over the steps (the running statistics'
  too).

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of the
reference's norm of that leaf and the reference's median leaf norm; the
number is the worst leaf's. ``change3`` leaves out the leaves whose raw
first gradient in the reference is under a thousandth of the median
leaf's (a bias ahead of a train-mode BatchNorm): Adam moves them by
round-off alone. A leaf that the reference moves and the program lacks
reads as norm 0.

Serve cells compare the sampled requests' masks (:func:`mask_numbers`).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

EXCLUDE_BELOW = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return {}
    median = statistics.median(ref[k] for k in names)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30) for k in names}


def moved_leaves(raw_grad: Dict[str, float], change_names) -> set:
    """The leaves whose change is compared: buffers, and those whose raw
    first gradient is at least a thousandth of the median leaf's."""
    median = statistics.median(raw_grad.values()) if raw_grad else 0.0
    return {k for k in change_names if k not in raw_grad or raw_grad[k] >= EXCLUDE_BELOW * median}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    out = {"loss": max(rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"])),
           "loss1": rel_gap(prog["loss"][0], ref["loss"][0])}
    if ref["loss_d"]:
        out["loss_d"] = max(rel_gap(a, b) for a, b in zip(prog["loss_d"], ref["loss_d"]))
    keep = moved_leaves(ref["raw_grad"], ref["change"])
    for name, gaps in (("grad1", leaf_gaps(prog["grad"], ref["grad"])),
                       ("change3", leaf_gaps(prog["change"], ref["change"], keep))):
        worst = max(gaps, key=gaps.get) if gaps else ""
        out[name] = gaps[worst] if gaps else math.nan
        out[f"{name}_leaf"] = worst
        out[f"{name}_median"] = statistics.median(gaps.values()) if gaps else math.nan
    if len(prog["loss"]) != len(ref["loss"]) or not all(map(math.isfinite, prog["loss"])):
        out["loss"] = math.inf
    return out


@torch.no_grad()
def mask_numbers(ref_logits: torch.Tensor, masks: torch.Tensor) -> Dict[str, float]:
    """Per pixel, the gap by which the reference's logit of the served class
    lies below its best, over the spread of the pixel's reference logits
    (best minus worst): ``mask_gap`` the widest, ``mask_gap_mean`` the
    mean over the request's pixels; ``mask_mismatch`` the share of pixels
    whose served class is not the reference's best."""
    k = ref_logits.shape[1]
    m = masks.long()
    served = ref_logits.gather(1, m.clamp_max(k - 1).unsqueeze(1)).squeeze(1)
    best, worst = ref_logits.amax(1), ref_logits.amin(1)
    gap = torch.where(m >= k, torch.ones_like(best), (best - served) / (best - worst).clamp_min(1e-30))
    return {"mask_gap": float(gap.amax()), "mask_gap_mean": float(gap.double().mean()),
            "mask_mismatch": float((gap > 0).double().mean())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """``correct`` and the (name, number, limit) of every limited number."""
    rows = [(k, float(numbers.get(k, math.nan)), float(v)) for k, v in limits.items()]
    return all(math.isfinite(x) and x <= lim for _, x, lim in rows), rows


def describe(rows) -> List[str]:
    return [f"check {k}: {x!r} (limit {lim!r})" for k, x, lim in rows]

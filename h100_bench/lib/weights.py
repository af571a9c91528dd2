"""Seeded weights, made on the device in one draw.

Every kernel of ``shapes`` (a list of ``(name, shape)``, see
``reference/nets.py``) takes normal draws scaled by its rule: the first
entry of ``init`` (``[substring, std]`` pairs, from the configuration
file) whose substring is in the name, else Kaiming's fan-in rule,
``sqrt(2 / fan_in)``. All draws come from one ``torch.randn`` on the
device's generator. Biases and BatchNorm shifts and running means start at
0; BatchNorm scales and running variances at 1. Everything is float32,
the type the parameters are held in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .seeds import sub


def _std(name: str, shape: Tuple[int, ...], init) -> float:
    for pattern, std in init:
        if pattern in name:
            return float(std)
    fan_in = math.prod(shape[1:])
    return math.sqrt(2.0 / fan_in)


def make(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, tag: str, device, init=()) -> Dict[str, torch.Tensor]:
    kernels = [(n, s) for n, s in shapes if len(s) == 4]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(sub(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n, s in kernels:
        size = math.prod(s)
        out[n] = flat[at: at + size].view(s).mul_(_std(n, s, init))
        at += size
    for n, s in shapes:
        if len(s) != 4:
            one = n.endswith(("bn.weight", "running_var"))
            out[n] = (torch.ones if one else torch.zeros)(s, device=device)
    return {n: out[n] for n, _ in shapes}

"""Seeded weights, made on the device in one draw.

Each tensor of ``shapes`` (a list of ``(name, shape)``, see
``reference/nets.py``) starts as its architecture's ``rule(name, shape)``
says: drawn where the rule gives None, else filled with the value it
gives (``nets.default_init``: kernels drawn; BatchNorm scales and running
variances 1; biases, shifts and running means 0). A drawn tensor takes
normal draws scaled by the first entry of ``init`` (``[substring, std]``
pairs, from the configuration file) whose substring is in its name, else
by Kaiming's fan-in rule, ``sqrt(2 / prod(shape[1:]))``. All draws come
from one ``torch.randn`` on the device's generator, in the order of
``shapes``. Everything is float32, the type the parameters are held in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .seeds import sub

Rule = Callable[[str, Tuple[int, ...]], Optional[float]]


def _std(name: str, shape: Tuple[int, ...], init) -> float:
    for pattern, std in init:
        if pattern in name:
            return float(std)
    fan_in = math.prod(shape[1:])
    return math.sqrt(2.0 / fan_in)


def make(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, tag: str, device, init=(), *,
         rule: Rule) -> Dict[str, torch.Tensor]:
    starts = {n: rule(n, s) for n, s in shapes}
    drawn = [(n, s) for n, s in shapes if starts[n] is None]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(sub(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n, s in drawn:
        size = math.prod(s)
        out[n] = flat[at: at + size].view(s).mul_(_std(n, s, init))
        at += size
    for n, s in shapes:
        if starts[n] is not None:
            out[n] = torch.full(s, float(starts[n]), device=device)
    return {n: out[n] for n, _ in shapes}

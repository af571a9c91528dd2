"""The train state (port of the JAX ``train/state.py``).

The JAX state is an immutable pytree that each step replaces. Here the
model and the optimizer are updated in place by the step, PyTorch's idiom,
and the state carries them with the counters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]  # the optimizer's learning rate per update
    step: int = 0  # updates taken; the schedule's index
    best_miou: float = 0.0

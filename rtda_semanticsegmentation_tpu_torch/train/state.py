"""The train state (port of the JAX ``train/state.py``).

The JAX state is an immutable pytree that each step replaces. Here the
model and the optimizer are updated in place by the step, PyTorch's idiom,
and the state carries them with the counters. In the adversarial modes it
also carries the discriminator, its optimizer and its schedule; both
schedules index the one shared ``step``, as the JAX state's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]  # the optimizer's learning rate per update
    step: int = 0  # updates taken; the schedule's index
    best_miou: float = 0.0
    discriminator: Optional[torch.nn.Module] = None
    d_optimizer: Optional[torch.optim.Optimizer] = None
    d_schedule: Optional[Callable[[int], float]] = None  # D's learning rate per update

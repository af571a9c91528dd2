"""Learning-rate schedules (port of the JAX ``train/schedule.py``)."""

from __future__ import annotations


def poly_lr_schedule(base_lr: float, max_iter: int, power: float = 0.9):
    """``step -> base_lr * (1 - step / max_iter) ** power``, the reference's
    per-batch poly decay, clipped at 0 past ``max_iter``. Update ``t``
    (from 0) runs at ``schedule(t)``."""
    if max_iter <= 0:
        raise ValueError(f"max_iter must be positive, got {max_iter}")

    def schedule(step: int) -> float:
        return base_lr * max(1.0 - step / float(max_iter), 0.0) ** power

    return schedule

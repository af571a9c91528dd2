"""What a driver hands back to the harness, and what the per-layer metric
readers read."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .trace import Trace


@dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    settings: dict
    device: str = "cuda"
    started: float = 0.0  # time.time() at the process's start


@dataclass
class Outcome:
    kind: str  # "train" or "serve"
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]  # what was compared, and detail beside it
    limits: Dict[str, float]
    units: int  # steps or requests in the measured window
    window_s: float
    batch: int
    setup_s: float
    peak_bytes: int = 0  # the process's peak, before the reference ran
    window_peak_bytes: int = 0  # the peak inside the window (reset at its start)
    dispatch_s: List[float] = field(default_factory=list)
    flops_per_unit: Optional[float] = None
    trace: Optional[Trace] = None
    shapes: Dict[str, tuple] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)  # the port's counters' change over the window
    config: dict = field(default_factory=dict)  # the cell's configuration and traffic, as the run used them
    traffic: dict = field(default_factory=dict)

"""A ``torch.profiler`` trace of a stretch of work, reduced to plain lists.

:func:`capture` starts the profiler, runs some units of work whose events
it drops (the profiler's own start-up falls there), then a stretch of
units that ends with a device synchronize. On a card it records the
device's activity alone (kernels, copies, sets) and the CUDA runtime
calls that CUPTI sees, not the host's operators: recording every operator
slowed the serving cells' dispatch by 60-90%, so the stretch no longer
stood for the window. The traced window runs from the stretch's first
host event to the end of its last event, host or device.

:class:`Trace` keeps the device's intervals and the host's, in
microseconds, and reduces them: the union of the device's busy intervals
inside the window, kernel time by group, the top device operations and
the longest idle gaps, each named by the host call under way when it
began, or by the last one before it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "h100_bench.window"  # recorded where the host's operators are
STEP = "ProfilerStep"  # the schedule's own span around each of its steps
Interval = Tuple[str, float, float]  # (name, start us, end us)

# kernel groups by name, first match wins; the grouping of profile_train.py
GROUPS = (
    ("k5", ("conv_fwd_kernel", "conv_dw_kernel", "conv_dw_reduce", "conv_dx_kernel")),
    ("k1", ("lovasz_hist",)),
    ("k2", ("lovasz_bwd",)),
    ("k3", ("int8_conv",)),
    ("k4", ("conv3x3",)),
    ("conv", ("cudnn", "cutlass", "xmma", "sm90", "conv", "wgrad", "dgrad", "implicit", "gemm")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("upsample", ("upsample",)),
    ("softmax_ce", ("softmax", "nll", "cross_entropy", "log_softmax")),
    ("reduce", ("reduce",)),
)
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def group(name: str) -> str:
    if name.startswith(COPIES):
        return "copy"
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return "elementwise"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    units: int = 1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return union([(max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels(self, match: Callable[[str], bool]) -> List[Interval]:
        return [iv for iv in self.device if match(iv[0])]

    def group_ms(self, name: str) -> float:
        """Device milliseconds of kernel group ``name`` per unit."""
        return sum(e - s for n, s, e in self.device if group(n) == name) * 1e-3 / self.units

    def top_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for n, s, e in self.device:
            total[n] = total.get(n, 0.0) + (e - s) * 1e-6
        return [[n[:160], v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host call under way at ``t``; where none is, the
        host's own code after the last call that ended before ``t``."""
        best: Optional[Interval] = None
        last: Optional[Interval] = None
        for iv in self.host:
            if iv[0] == SPAN:
                continue
            if iv[1] <= t < iv[2] and (best is None or iv[2] - iv[1] < best[2] - best[1]):
                best = iv
            elif iv[2] <= t and (last is None or iv[2] > last[2]):
                last = iv
        if best is not None:
            return best[0][:160]
        return f"host code after {last[0][:140]}" if last else "(no host call)"

    def idle_gaps(self, k: int = 10) -> List[list]:
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:k]
        return [[self.host_at(s), (e - s) * 1e-6] for s, e in longest]


def _device_event(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def capture(unit: Callable[[], object], units: int, warmup: int, sync: Callable[[], None]) -> Trace:
    """Profile ``units`` calls of ``unit()`` (a step or a request) and the
    final ``sync``, after ``warmup`` calls under a profiler that is
    already tracing, whose events are dropped. Without a card the host's
    operators are what is recorded (the benchmark's own tests)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    sync()
    activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    plan = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[activity], schedule=plan) as prof:
        for _ in range(warmup):
            unit()
        sync()
        prof.step()
        with record_function(SPAN):
            for _ in range(units):
                unit()
            sync()
        prof.step()
    events = prof.events()
    device = [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events if _device_event(e)]
    host = [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and not e.name.startswith(STEP)]
    if not host:
        raise RuntimeError("the profiler recorded no host event in the stretch")
    window = (min(s for _, s, _ in host), max(e for _, _, e in host + device))
    return Trace(window, device, host, units)

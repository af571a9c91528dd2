"""What the per-layer metric readers (``metrics/<name>.py``) share. Each
returns None where its run has nothing to read, and the harness then
leaves the metric out."""

from __future__ import annotations

import statistics
from typing import Optional

from h100_bench.costs import lovasz as lovasz_bytes
from h100_bench.costs.peaks import BF16_FLOPS, HBM_BYTES_S
from h100_bench.lib.outcome import Outcome


def mfu(run: Outcome, kind: str) -> Optional[float]:
    """The window's FLOPs (counted on the reference) over its wall time, as
    a percentage of the bf16 dense peak."""
    if run.kind != kind or not run.flops_per_unit or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_unit * run.units / run.window_s / BF16_FLOPS


def idle_share(run: Outcome, kind: str) -> Optional[float]:
    """Percentage of the measured window in which nothing ran on the
    device: the traced stretch's busy time a unit (the union of its
    kernels and copies) over the window's wall time a unit. The trace
    gives the device's time and the untraced window the wall time, so the
    profiler's own cost on the host, which lengthens the traced stretch,
    does not count as idle."""
    if run.kind != kind or run.trace is None or not run.trace.device or run.units <= 0 or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - (run.trace.busy_s / run.trace.units) / (run.window_s / run.units))


def busy_ms(run: Outcome, kind: str) -> Optional[float]:
    """Device milliseconds a step or request in which a kernel or copy ran
    (the union of the traced stretch's intervals)."""
    if run.kind != kind or run.trace is None or not run.trace.device:
        return None
    return 1e3 * run.trace.busy_s / run.trace.units


def group_ms(run: Outcome, kind: str, group: str) -> Optional[float]:
    """Device milliseconds a step or request in a kernel group."""
    if run.kind != kind or run.trace is None:
        return None
    ms = run.trace.group_ms(group)
    return ms if ms > 0 else None


def peak_gib(run: Outcome, kind: str) -> Optional[float]:
    if run.kind != kind or run.window_peak_bytes <= 0:
        return None
    return run.window_peak_bytes / 2**30


def dispatch_ms(run: Outcome, kind: str) -> Optional[float]:
    """Mean host milliseconds inside the serving call, to its return."""
    if run.kind != kind or not run.dispatch_s:
        return None
    return 1e3 * statistics.fmean(run.dispatch_s)


def lovasz_roofline(run: Outcome, kernel: str) -> Optional[float]:
    """The bytes K1 or K2 must move (``costs/lovasz.py``) at the HBM rate,
    over its device time a launch, as a percentage."""
    if run.trace is None or "lovasz" not in run.shapes:
        return None
    name = {"k1": "lovasz_hist_kernel", "k2": "lovasz_bwd_kernel"}[kernel]
    launches = run.trace.kernels(lambda n: name in n)
    if not launches:
        return None
    seconds = sum(e - s for _, s, e in launches) * 1e-6 / len(launches)
    b, c, n, bins, interp = run.shapes["lovasz"]
    nbytes = lovasz_bytes.k1_bytes(b, c, n, bins) if kernel == "k1" else lovasz_bytes.k2_bytes(b, c, n, bins, interp)
    return 100.0 * nbytes / HBM_BYTES_S / seconds

"""Performance profiling: parameters, FLOPs, eval-forward latency and a
timeline trace (port of the JAX package's ``obs/profiler.py``).

The reference's protocol: batch 1 at the eval size, 10 warm-up and 100
timed forwards. The forwards are timed in spans of ``obs/spans.py``: by
CUDA events on a CUDA device, by the host clock on the CPU. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over one forward: it counts
the convolutions and matrix products (2 per multiply-accumulate), where the
JAX package reads XLA's cost analysis of the compiled forward, which also
counts elementwise work, so the two totals differ.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import spans


def count_params(params) -> int:
    """The number of parameters of a module, a state dict or an iterable of
    tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif hasattr(params, "values"):
        params = params.values()
    return sum(int(p.numel()) for p in params)


def model_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of ``fn(*args)`` per ``FlopCounterMode`` (None when it counts
    none)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None


def _timed(fn: Callable, x: torch.Tensor, calls: int) -> float:
    """Seconds of ``calls`` calls of ``fn(x)``, in a span of the recorder
    (``obs/spans.py``): on the device's timeline on a CUDA device, else the
    host clock."""
    with spans.span("perf.latency", x.device, always=True) as block:
        for _ in range(calls):
            fn(x)
    return block.device_ms * 1e-3


def timed_latency(fn: Callable, x: torch.Tensor, iterations: int = 100, warmup: int = 10,
                  blocks: int = 10) -> Dict[str, float]:
    """Latency of ``fn(x)``: the mean over one run of ``iterations`` calls
    after ``warmup`` calls, and the std / p50 over ``blocks`` runs of
    ``iterations // blocks`` calls each."""
    with torch.inference_mode():
        for _ in range(max(warmup, 1)):
            fn(x)
        mean_s = _timed(fn, x, iterations) / iterations
        per_block = max(1, iterations // blocks)
        block_means = [_timed(fn, x, per_block) / per_block for _ in range(blocks)]
    t = np.asarray(block_means)
    return {
        "mean_latency_ms": float(mean_s * 1e3),
        "std_latency_ms": float(t.std() * 1e3),
        "p50_latency_ms": float(np.percentile(t, 50) * 1e3),
        "mean_fps": float(1.0 / mean_s),
        "std_fps": float(t.std() / (mean_s ** 2)),
    }


def performance_metrics(model: torch.nn.Module, height: int = 512, width: int = 1024, iterations: int = 100,
                        warmup: int = 10, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The reference's end-of-run report: ``flops_g``, ``params_m`` and the
    mean / std latency and FPS of the eval forward of ``model`` at batch 1
    and ``height`` x ``width``, on the model's device."""
    device = next(model.parameters()).device
    images = torch.zeros((1, 3, height, width), dtype=dtype, device=device)
    model.eval()

    def forward(x):
        return model(x)

    with torch.inference_mode():
        flops = model_flops(forward, images)
    lat = timed_latency(forward, images, iterations=iterations, warmup=warmup)
    return {
        "flops_g": round(flops / 1e9, 2) if flops else None,
        "params_m": round(count_params(model) / 1e6, 2),
        **{k: round(v, 3) for k, v in lat.items()},
    }


def start_trace() -> torch.profiler.profile:
    """Start a ``torch.profiler`` trace of the host and, where there is one,
    the card; :func:`stop_trace` ends it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    prof.started_ns = time.time_ns()
    return prof


def stop_trace(prof: torch.profiler.profile, path: str) -> str:
    """Wait for the card, stop ``prof`` and write its timeline to ``path``
    (chrome://tracing or Perfetto) with, under the key ``spans``, the
    recorder's spans (``obs/spans.py``) that opened during the trace, their
    device ms read from their events. Returns ``path``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        timeline = json.load(f)
    timeline["spans"] = spans.export(since_ns=prof.started_ns)
    with open(path, "w") as f:
        json.dump(timeline, f)
    return path


@contextmanager
def trace(log_dir: str = "logs/trace"):
    """A ``torch.profiler`` timeline trace around a block (the host, and the
    card where there is one), written by :func:`stop_trace` as
    ``<log_dir>/trace_<pid>_<n>.json``. Yields the profiler."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, os.path.join(log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))

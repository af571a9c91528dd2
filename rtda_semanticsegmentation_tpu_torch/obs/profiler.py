"""Performance profiling: parameters, FLOPs, eval-forward latency and a
timeline trace (port of the JAX package's ``obs/profiler.py``).

The reference's protocol: batch 1 at the eval size, 10 warm-up and 100
timed forwards. On a CUDA device the forwards are timed by CUDA events; on
the CPU by ``time.perf_counter``. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over one forward: it counts
the convolutions and matrix products (2 per multiply-accumulate), where the
JAX package reads XLA's cost analysis of the compiled forward, which also
counts elementwise work, so the two totals differ.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


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


class _Timer:
    """Elapsed milliseconds of a block: CUDA events on a CUDA device, else
    the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def timed_latency(fn: Callable, x: torch.Tensor, iterations: int = 100, warmup: int = 10,
                  blocks: int = 10) -> Dict[str, float]:
    """Latency of ``fn(x)``: the mean over one run of ``iterations`` calls
    after ``warmup`` calls, and the std / p50 over ``blocks`` runs of
    ``iterations // blocks`` calls each."""
    timer = _Timer(x.device)
    with torch.inference_mode():
        for _ in range(max(warmup, 1)):
            fn(x)
        with timer:
            for _ in range(iterations):
                fn(x)
        mean_s = timer.ms / 1e3 / iterations
        per_block = max(1, iterations // blocks)
        block_means = []
        for _ in range(blocks):
            with timer:
                for _ in range(per_block):
                    fn(x)
            block_means.append(timer.ms / 1e3 / per_block)
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


@contextmanager
def trace(log_dir: str = "logs/trace"):
    """A ``torch.profiler`` timeline trace around a block (the host, and the
    card where there is one), written as ``<log_dir>/trace_<pid>_<n>.json``
    for chrome://tracing or Perfetto. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))

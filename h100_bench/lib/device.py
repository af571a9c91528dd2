"""The card: its presence, name, power limit, clocks, and the host's view
of device time."""

from __future__ import annotations

import os
import subprocess
import sys

import torch

SMI_FIELDS = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def check_cards(chips: int) -> str:
    """An empty string when ``chips`` cards are there, else why not."""
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} are available"
    return ""


def smi(index: int = 0) -> str:
    """One ``nvidia-smi`` reading of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:  # no nvidia-smi: say so, measure on
        return f"nvidia-smi unavailable: {err}"


def pin_host(n: int) -> list:
    """Keep every thread of this process, and each it starts later, on the
    last ``n`` CPUs it may use; the CPUs kept."""
    keep = sorted(os.sched_getaffinity(0))[-n:]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), keep)
        except OSError:  # the thread has ended
            pass
    return keep


def info(device, chips: int, peak_bytes: int) -> dict:
    if not is_cuda(device):
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if is_cuda(device) else 0


def reset_peak(device) -> None:
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    import gc

    gc.collect()
    if is_cuda(device):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def note(line: str) -> None:
    """A line of the run's log, on standard output before the result."""
    print(line, flush=True)


def warn(line: str) -> None:
    print(line, file=sys.stderr, flush=True)

"""One run of one cell: find its files, check the cards, drive the port,
read the metrics, check the outputs, print the result.

Exit codes: 0 a result was printed; 2 the arguments or the cell's files
are wrong; 3 the cards the cell needs are not there; 4 the port cannot be
imported (a checkout that holds only the benchmark); 5 the process holds
JAX or the JAX package once the window has closed. Only 0 prints a
result line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import List, Optional

from h100_bench.lib import compare, device as dev, spec
from h100_bench.lib.outcome import Context, Outcome

BANNED = ("jax", "jaxlib", "flax", "optax", "rtda_semanticsegmentation_tpu")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_of(cell: spec.Cell, out: Outcome, trace: bool, root=spec.ROOT) -> dict:
    if not trace:
        return {m["name"]: {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    found = {}
    for m in cell.per_layer:
        value = spec.read_metric(m["name"], out, root)
        if value is not None and math.isfinite(value):
            found[m["name"]] = {"value": value, "unit": m["unit"]}
    return found


def _earlier_lines(out: Outcome, ctx: Context) -> None:
    if dev.is_cuda(ctx.device):
        import torch

        dev.note(f"card {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
                 f"torch {torch.__version__}, cuda {torch.version.cuda}")
    build = sys.modules.get("rtda_semanticsegmentation_tpu_torch.kernels.build")
    for source, info in (getattr(build, "build_log", None) or {}).items():
        dev.note(f"kernel build {source}: {info['seconds']:.2f} s")
    per = "step" if out.kind == "train" else "request"
    for k, v in out.counters.items():
        dev.note(f"counter {k}: {v} over the window ({v / max(out.units, 1):.3f} a {per})")
    dev.note(f"window: {out.units} {per}s of batch {out.batch} in {out.window_s:.4f} s; set-up {out.setup_s:.3f} s; "
             f"peak {out.peak_bytes} B (window {out.window_peak_bytes} B)")
    for k, v in out.numbers.items():
        dev.note(f"compared {k}: {v}")


def main(argv, started: Optional[float] = None, require_card: bool = True, device: str = "cuda",
         overrides: Optional[dict] = None, root=spec.ROOT) -> int:
    """``require_card=False`` and ``device='cpu'`` (with ``overrides`` of
    the cell's configuration, traffic and settings) drive the rest of a
    run on the CPU, for the benchmark's own tests."""
    started = time.time() if started is None else started
    args = parse(argv)
    try:
        cell = spec.resolve(spec.benchmark(root), args.workload, root)
        drive = spec.driver(cell.traffic["driver"], root)
    except (KeyError, FileNotFoundError, ValueError) as err:
        dev.warn(f"h100_bench: {err}")
        return 2
    if require_card:
        why = dev.check_cards(cell.chips)
        if why:
            dev.warn(f"h100_bench: {why}; nothing measured")
            return 3
    try:
        import rtda_semanticsegmentation_tpu_torch  # noqa: F401
    except ImportError as err:
        dev.warn(f"h100_bench: the port cannot be imported ({err}); nothing measured")
        return 4
    dev.note(f"set-up: port imported {time.time() - started:.3f} s after the start")
    over = overrides or {}
    ctx = Context(cell=cell.name, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  config={**cell.config, **over.get("config", {})}, traffic={**cell.traffic, **over.get("traffic", {})},
                  settings={**cell.settings, **over.get("settings", {})}, device=device, started=started)
    if dev.is_cuda(device):
        dev.note(f"smi at start: {dev.smi()}")
    out = drive.run(ctx)
    banned = banned_modules()
    if banned:
        dev.warn(f"h100_bench: the process holds {banned}; no result")
        return 5
    metrics = metrics_of(cell, out, ctx.trace, root)
    correct, rows = compare.verdict(out.numbers, out.limits)
    correct = correct and out.failed == 0
    _earlier_lines(out, ctx)
    device_info = dev.info(device, cell.chips, out.peak_bytes)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device_info}
    if ctx.trace and out.trace is not None:
        device_info.update({"busy_s": out.trace.busy_s, "window_s": out.trace.window_s})
        result["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    result["checks"] = {k: {"value": x, "limit": lim} for k, x, lim in rows}
    for line in compare.describe(rows):
        dev.warn(line)
    print(json.dumps(result), flush=True)
    return 0

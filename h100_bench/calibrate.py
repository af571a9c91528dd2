#!/usr/bin/env python3
"""The readings that the correctness limits are set from, for one cell, in
one process.

    python3 h100_bench/calibrate.py --workload r18-adv-train --seeds 1,2,...,12 \
        --control-seeds 1,2,3 --faults half_batch [--seconds 2]

For each of ``--seeds``, the numbers a sound run of the program gives
(its first steps against the reference, or its sampled masks over a short
window at the cell's own load). For each of ``--control-seeds``, the same
numbers for the control: the reference in float8 put in the program's
place (train cells), or the port's own int8 serving path, calibrated on
two seeded batches (serve cells); and for each fault in ``--faults``
(``lib/faults.py``), the program with that fault planted. One JSON line a
reading, then a summary: the largest sound reading (the lower reading)
and the smallest control and fault readings of each number. The
benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

STARTED = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100_bench.lib import compare, device as dev, faults, spec  # noqa: E402
from h100_bench.lib.outcome import Context  # noqa: E402


def _train(drive, ctx, variant, fault=None):
    """(sound or fault numbers) or control numbers, against the reference."""
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        prog = drive.Program(ctx)
        read = prog.first_steps(ctx.traffic["first_steps"])
        ring, states = prog.ring, prog.gen_states
        prog.close()
    ref = drive.reference(ctx, ring, states)
    if variant == "control":
        read = drive.reference(ctx, ring, states, fp8=True)
    return compare.train_numbers(read, ref)


def _serve(drive, ctx, variant, fault=None):
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        prog = drive.Program(ctx, precision="int8" if variant == "control" else None)
        prog.warm()
        prog.loop(seconds=ctx.seconds)
        frames, kept = prog.frames, prog.kept
        prog.close()
    return drive.mask_numbers(ctx, frames, kept)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0, help="the serve cells' short window")
    args = p.parse_args()
    cell = spec.resolve(spec.benchmark(), args.workload)
    why = dev.check_cards(cell.chips)
    if why:
        dev.warn(why)
        return 3
    drive = spec.driver(cell.traffic["driver"])
    measure = _train if drive.KIND == "train" else _serve
    rows = []
    plan = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    plan += [(int(s), "control", None) for s in args.control_seeds.split(",") if s]
    plan += [(int(s), "fault", f) for f in args.faults.split(",") if f for s in args.control_seeds.split(",") if s]
    for seed, variant, fault in plan:
        ctx = Context(cell=cell.name, seed=seed, seconds=args.seconds, trace=False, config=cell.config,
                      traffic=cell.traffic, settings=cell.settings, started=time.time())
        t0 = time.time()
        numbers = measure(drive, ctx, variant, fault)
        row = {"seed": seed, "variant": variant if fault is None else f"fault:{fault}", **numbers,
               "seconds": time.time() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for k in sorted({k for r in rows for k, v in r.items() if isinstance(v, float) and k != "seconds"}):
        sound = [r[k] for r in rows if r["variant"] == "program" and k in r]
        summary[k] = {"lower": max(sound) if sound else None}
        for v in sorted({r["variant"] for r in rows if r["variant"] != "program"}):
            vals = [r[k] for r in rows if r["variant"] == v and k in r]
            summary[k][v] = min(vals) if vals else None
    print(json.dumps({"summary": summary, "smi": dev.smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

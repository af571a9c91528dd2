"""The controls, at a size a CPU test run holds: each cell's control comes
out not correct under the cell's own limits. Train cells: the reference in
float8 (``reference/ops.py::fp8``) in the program's place. Serve cells:
the port's own int8 serving path, calibrated on two seeded batches. On the
card the controls are read at the cells' own sizes by
``h100_bench/calibrate.py``."""

import pytest
import torch

from h100_bench.drivers import serve_closed_loop, train_step
from h100_bench.lib import compare, spec
from h100_bench.lib.outcome import Context

TRAIN = {"r18-adv-train": {"batch": 4, "source": [64, 96], "target": [64, 96]},
         "dlv2-train": {"batch": 4, "source": [64, 96]}}
SERVE = {"r18-serve-b8": {"batch": 2, "size": [128, 256], "warmup_rounds": 1, "sample": 4}}


def _ctx(cell, traffic):
    c = spec.resolve(spec.benchmark(), cell)
    return c, Context(cell=cell, seed=2147483901, seconds=0.3, trace=False, config=c.config,
                      traffic={**c.traffic, **traffic}, settings=c.settings, device="cpu")


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_train_control_fails(cell):
    c, ctx = _ctx(cell, TRAIN[cell])
    prog = train_step.Program(ctx)
    prog.first_steps(ctx.traffic["first_steps"])
    ring, states = prog.ring, prog.gen_states
    prog.close()
    ref = train_step.reference(ctx, ring, states)
    control = train_step.reference(ctx, ring, states, fp8=True)
    correct, rows = compare.verdict(compare.train_numbers(control, ref), c.settings["limits"])
    assert not correct, rows


@pytest.mark.parametrize("cell", sorted(SERVE))
def test_serve_control_fails(cell):
    torch.manual_seed(0)
    c, ctx = _ctx(cell, SERVE[cell])
    prog = serve_closed_loop.Program(ctx, precision="int8")
    prog.loop(count=4)
    frames, kept = prog.frames, prog.kept
    prog.close()
    correct, rows = compare.verdict(serve_closed_loop.mask_numbers(ctx, frames, kept), c.settings["limits"])
    assert not correct, rows

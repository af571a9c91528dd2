"""Whole serving request: FLOPs of the window's eval forwards over the window's
wall time, % of the bf16 dense peak."""

from h100_bench.lib.readers import mfu


def read(run):
    return mfu(run, "serve")

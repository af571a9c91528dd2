"""Whole train step: FLOPs of the window's steps (the reference's convs and
matrix products, forward and backward) over the window's wall time, % of the
bf16 dense peak."""

from h100_bench.lib.readers import mfu


def read(run):
    return mfu(run, "train")

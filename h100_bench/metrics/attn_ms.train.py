"""Model: device ms a train step in the attention's kernels
(``F.scaled_dot_product_attention``: flash or memory-efficient, forward and
backward)."""

from h100_bench.lib.kernels import ATTENTION, kernel_seconds


def read(run):
    if run.kind != "train":
        return None
    s = kernel_seconds(run, ATTENTION)
    return None if s is None else 1e3 * s

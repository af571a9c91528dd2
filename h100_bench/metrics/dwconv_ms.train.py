"""Model: device ms a train step in the Mix-FFN's depthwise conv kernels
(forward, data gradient and weight gradient)."""

from h100_bench.lib.kernels import DEPTHWISE, kernel_seconds


def read(run):
    if run.kind != "train":
        return None
    s = kernel_seconds(run, DEPTHWISE)
    return None if s is None else 1e3 * s

"""Model: device ms a request in convolution kernels."""

from h100_bench.lib.readers import group_ms


def read(run):
    return group_ms(run, "serve", "conv")

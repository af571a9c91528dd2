"""Model: device ms a train step in convolution kernels (cuDNN, CUTLASS, the
port's conv kernels by their names), forward and backward."""

from h100_bench.lib.readers import group_ms


def read(run):
    return group_ms(run, "train", "conv")

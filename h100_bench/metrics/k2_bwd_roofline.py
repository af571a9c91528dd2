"""K2 (csrc/lovasz.cu backward): its bytes at the HBM rate over its device time
a launch, %."""

from h100_bench.lib.readers import lovasz_roofline


def read(run):
    return lovasz_roofline(run, "k2")

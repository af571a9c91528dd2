"""Device: % of the traced stretch of train steps with nothing running on the
card (the union of kernels and copies)."""

from h100_bench.lib.readers import idle_share


def read(run):
    return idle_share(run, "train")

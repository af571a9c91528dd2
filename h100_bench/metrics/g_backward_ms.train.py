"""Train step phases: device ms a step in the ``train.g_backward`` span, G's
backward (the bilinear backward, K2, a remat's recompute); the program's own
CUDA events over the traced steps."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.phase_ms(spans.describe(run), "train.step", "train.g_backward")

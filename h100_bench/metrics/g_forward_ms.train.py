"""Train step phases: device ms a step in the ``train.g_forward`` span, G's
train-mode forwards (and the live target's D input); the program's own CUDA
events over the traced steps."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.phase_ms(spans.describe(run), "train.step", "train.g_forward")

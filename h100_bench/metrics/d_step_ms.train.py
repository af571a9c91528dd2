"""Train step phases: device ms a step in the ``train.d_step`` span, the
discriminator's step: its input, forwards, loss, backward and update; the
program's own CUDA events over the traced steps."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.phase_ms(spans.describe(run), "train.step", "train.d_step")

"""Train step phases: device ms a step in the ``train.augment`` span, the
source's augmentation and normalization, the target's normalization; the
program's own CUDA events over the traced steps."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.phase_ms(spans.describe(run), "train.step", "train.augment")

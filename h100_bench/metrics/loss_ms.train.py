"""Train step phases: device ms a step in the ``train.loss`` span, the
segmentation loss (CE, softmax, Lovasz on K1) and the adversarial BCE
through D; the program's own CUDA events over the traced steps."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.phase_ms(spans.describe(run), "train.step", "train.loss")

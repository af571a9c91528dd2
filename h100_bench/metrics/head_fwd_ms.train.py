"""Model: device ms a train step in the ``segformer.head`` span, the all-MLP
decoder's forward and the logits' resize; the program's own CUDA events
over the traced steps."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.phase_ms(spans.describe(run), "train.step", "segformer.head")

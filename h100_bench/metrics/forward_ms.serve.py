"""Serve entry: device ms a request in the ``serve.forward`` span
(normalize, forward, argmax, uint8); the program's own CUDA events."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    return spans.phase_ms(spans.describe(run), "serve.request", "serve.forward")

"""Serve entry: host ms a request in the ``serve.copy_in`` span, the frames'
copy from pinned host memory to the card."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    return spans.phase_ms(spans.describe(run), "serve.request", "serve.copy_in", kind="host")

"""Serve entry: device idle ms a request in the trace's gaps that start while
the host is inside ``serve.forward`` (its innermost span), the spans aligned
with the trace by their ``cudaEventRecord`` calls."""

from h100_bench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    return spans.idle_ms(run, "serve.forward")

"""Serve entry: mean host ms inside the serving call, up to its return, for
batched requests."""

from h100_bench.lib.readers import dispatch_ms


def read(run):
    return dispatch_ms(run, "serve")

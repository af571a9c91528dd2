"""Device: ms a batched request in which a kernel or copy ran on the card;
steadier than the host-timed rate it moves."""

from h100_bench.lib.readers import busy_ms


def read(run):
    return busy_ms(run, "serve")

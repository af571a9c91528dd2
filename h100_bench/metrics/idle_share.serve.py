"""Device: % of the traced stretch of batched requests with nothing running on
the card."""

from h100_bench.lib.readers import idle_share


def read(run):
    return idle_share(run, "serve")

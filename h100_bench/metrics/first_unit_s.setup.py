"""Set-up: host seconds of the process's first train step or serving request
(lazy initialisation, cuDNN's plans), its ``kernels.build`` spans left out."""

from h100_bench.lib import spans


def read(run):
    return spans.first_unit_s(spans.describe(run))

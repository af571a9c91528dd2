"""Set-up: host seconds in the port's ``setup.build`` spans (``build_model``,
``build_discriminator``, ``load_variables``)."""

from h100_bench.lib import spans


def read(run):
    return spans.build_s(spans.describe(run))

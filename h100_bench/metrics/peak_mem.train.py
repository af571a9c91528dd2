"""Device memory: the peak allocated in the measured window, GiB."""

from h100_bench.lib.readers import peak_gib


def read(run):
    return peak_gib(run, "train")

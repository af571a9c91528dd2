"""Kernels: the attention's FLOPs a train step (``costs/attention.py``:
forward and backward products) at the bf16 dense peak, over its kernels'
device time a step, %."""

from h100_bench.costs.attention import train_step_flops
from h100_bench.costs.peaks import BF16_FLOPS
from h100_bench.lib.kernels import ATTENTION, kernel_seconds


def read(run):
    if run.kind != "train" or "mit_embed_dims" not in run.config.get("model", {}):
        return None
    s = kernel_seconds(run, ATTENTION)
    return None if s is None else 100.0 * train_step_flops(run.config, run.traffic) / BF16_FLOPS / s

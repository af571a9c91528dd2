"""Device time of kernels picked out by name in a run's trace, for the
readers of a layer that no group of ``lib/trace.py`` claims whole (the
attention's kernels fall in its ``conv`` group by their ``cutlass``
template arguments). Names are matched as the profiler prints them."""

from __future__ import annotations

from typing import Optional, Tuple

from h100_bench.lib.outcome import Outcome

# F.scaled_dot_product_attention's flash kernels (forward; the backward's
# dq/dk/dv, its dO.O product and its dq conversion) and its memory-efficient ones
ATTENTION = ("flash_fwd", "flash_bwd", "fmha_cutlass")
# the depthwise conv's forward, data gradient and weight gradient: cuDNN's
# channel-multiplier-1 NHWC kernels (conv2d_/dgrad2d_/wgrad2d_c1_k1_nhwc*),
# or PyTorch's own (conv_depthwise2d_*) where the input is NCHW
DEPTHWISE = ("_c1_k1_nhwc", "conv_depthwise2d")


def kernel_seconds(run: Outcome, names: Tuple[str, ...]) -> Optional[float]:
    """Device seconds a unit in kernels whose name holds one of ``names``;
    None where the run has no trace or no such kernel."""
    if run.trace is None:
        return None
    found = run.trace.kernels(lambda n: any(k in n for k in names))
    if not found:
        return None
    return sum(e - s for _, s, e in found) * 1e-6 / run.trace.units

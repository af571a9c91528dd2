"""The trace reduction on a made-up trace."""

import pytest

from h100_bench.lib import readers
from h100_bench.lib.outcome import Outcome
from h100_bench.lib.trace import SPAN, Trace, group, union


def _trace():
    device = [("void cudnn::conv_kernel", 0.0, 10.0), ("elementwise_kernel", 5.0, 15.0),
              ("Memcpy HtoD (Pinned -> Device)", 20.0, 30.0), ("lovasz_hist_kernel<4>", 45.0, 60.0)]
    host = [(SPAN, 0.0, 40.0), ("aten::conv2d", 14.0, 22.0), ("aten::copy_", 16.0, 19.0), ("aten::cat", 29.0, 39.0)]
    return Trace((0.0, 40.0), device, host, units=2)


def test_union_merges_overlaps():
    assert union([(5, 15), (0, 10), (20, 30), (30, 31)]) == [(0, 15), (20, 31)]


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    assert t.busy_intervals() == [(0.0, 15.0), (20.0, 30.0)]
    assert t.busy_s == pytest.approx(25e-6) and t.window_s == pytest.approx(40e-6)
    assert t.gaps() == [(15.0, 20.0), (30.0, 40.0)]


def test_idle_gaps_named_by_the_innermost_host_op():
    gaps = _trace().idle_gaps()
    assert gaps[0][0] == "aten::cat" and gaps[0][1] == pytest.approx(10e-6)
    assert gaps[1][0] == "aten::conv2d" and gaps[1][1] == pytest.approx(5e-6)


def test_idle_gap_outside_any_host_call_is_named_by_the_last_one():
    device = [("kernel_a", 0.0, 10.0), ("kernel_b", 30.0, 40.0)]
    host = [("cudaLaunchKernel", 1.0, 3.0), ("cudaMemcpyAsync", 5.0, 8.0), ("cudaLaunchKernel", 25.0, 27.0)]
    assert Trace((0.0, 40.0), device, host).idle_gaps() == [["host code after cudaMemcpyAsync", pytest.approx(20e-6)]]


def test_groups_and_readers():
    assert group("void cudnn::conv_kernel") == "conv" and group("Memset (Device)") == "copy"
    assert group("lovasz_hist_kernel<4>") == "k1" and group("vectorized_elementwise_kernel") == "elementwise"
    # the untraced window: 2 units in 80 us, so 40 us a unit against 12.5 us busy a unit in the trace
    run = Outcome(kind="train", end_to_end={}, attempted=2, failed=0, numbers={}, limits={}, units=2,
                  window_s=80e-6, batch=8, setup_s=1.0, trace=_trace(), flops_per_unit=989e12 * 80e-6 / 4,
                  shapes={"lovasz": (1, 1, 1000, 256, True)})
    assert readers.idle_share(run, "train") == pytest.approx(100 * (1 - 12.5 / 40))
    assert readers.idle_share(run, "serve") is None
    assert readers.busy_ms(run, "train") == pytest.approx(12.5e-3)
    assert readers.group_ms(run, "train", "conv") == pytest.approx(10e-3 / 2)
    assert readers.mfu(run, "train") == pytest.approx(50.0)
    # K1 moves 4*1000 + 4*1000 + 4*3*256 bytes in 15 us
    want = 100 * (8000 + 3072) / 3.35e12 / 15e-6
    assert readers.lovasz_roofline(run, "k1") == pytest.approx(want)
    assert readers.lovasz_roofline(run, "k2") is None


def test_capture_keeps_only_the_stretch():
    """The warm-up units run under the profiler but are dropped; the window
    span holds the stretch's units alone."""
    import torch

    from h100_bench.lib.trace import capture

    t = capture(lambda: torch.ones(64).sum(), 5, 3, lambda: None)
    assert sum(1 for n, _, _ in t.host if n == "aten::sum") == 5 and t.units == 5
    assert t.window_s > 0 and not any(n.startswith("ProfilerStep") for n, _, _ in t.host)

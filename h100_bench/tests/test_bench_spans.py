"""The readers of the port's spans (``lib/spans.py``) on made-up traces with
planted anchors, and on whole traced runs on the CPU."""

import json
import random
import sys

import pytest

from h100_bench import harness
from h100_bench.lib import spans
from h100_bench.lib.outcome import Outcome
from h100_bench.lib.trace import Trace

EPOCH_US = 1.7e15  # host clock (time.time_ns() / 1000) of the made-up spans
SHIFT_US = EPOCH_US - 500.0  # the trace's zero on the host clock


def _rec(name, parent, t0_us, t1_us, device_ms=None, unit=1, events=True, profiled=True, first=False, setup=False):
    host_ms = (t1_us - t0_us) * 1e-3
    return {"name": name, "parent": parent, "unit": unit, "t0_ns": int((EPOCH_US + t0_us) * 1e3),
            "t1_ns": int((EPOCH_US + t1_us) * 1e3), "host_ms": host_ms,
            "device_ms": host_ms if device_ms is None else device_ms, "events": events, "profiled": profiled,
            "first": first, "setup": setup}


def _steps(n=2, period=1000.0):
    """``n`` traced steps, each a root and three phases (host us from the
    epoch)."""
    recs = []
    for k in range(n):
        at = k * period
        root = len(recs)
        recs.append(_rec("train.step", None, at, at + 900, device_ms=0.95, unit=k + 1))
        for name, a, b, ms in (("train.augment", 10, 200, 0.2), ("train.g_forward", 210, 500, 0.3),
                               ("train.g_backward", 510, 890, 0.45)):
            recs.append(_rec(name, root, at + a, at + b, device_ms=ms, unit=k + 1))
    return recs


def _anchored(recs, extra=(), jitter=4.0, seed=0):
    """Host events of a card's trace: an event record ending just before
    each span boundary (the trace's clock), plus ``extra`` records."""
    rnd = random.Random(seed)
    host = []
    for r in recs:
        for t in (r["t0_ns"], r["t1_ns"]):
            end = t / 1e3 - SHIFT_US - rnd.uniform(0.5, jitter)
            host.append(("cudaEventRecordWithFlags", end - 3.0, end))
    host += [("cudaEventRecord", t - 2.0, t) for t in extra]
    host.append(("cudaLaunchKernel", 0.0, 5.0))
    return sorted(host, key=lambda h: h[1])


def _run(recs, host, device, units=2):
    window = (min(h[1] for h in host), max(h[2] for h in host + device))
    return Outcome(kind="train", end_to_end={}, attempted=units, failed=0, numbers={}, limits={}, units=units,
                   window_s=1e-3, batch=8, setup_s=1.0, trace=Trace(window, device, host, units))


def test_alignment_survives_extra_event_records_and_a_shifted_clock():
    recs = _steps()
    # other event records (a pinned copy's) between boundaries, one just before the first
    extra = [100.0, 320.0, 700.0, 1350.0, 1720.0]
    host = _anchored(recs, extra)
    run = _run(recs, host, [("kernel", 500.0, 2400.0)])
    shift, residual = spans.align(run, recs)
    assert shift == pytest.approx(SHIFT_US, abs=5.0) and residual <= spans.TOLERANCE_US
    # the same spans, the trace's zero elsewhere on the host clock
    later = [(n, s + 12345.0, e + 12345.0) for n, s, e in host]
    shift2, _ = spans.align(_run(recs, later, [("kernel", 13000.0, 14000.0)]), recs)
    assert shift2 == pytest.approx(SHIFT_US - 12345.0, abs=5.0)


@pytest.mark.parametrize("fault", ["moved", "missing"])
def test_a_mismatch_gives_none(fault):
    recs = _steps()
    host = _anchored(recs)
    records = [i for i, h in enumerate(host) if h[0] == "cudaEventRecordWithFlags"]
    k = records[5]
    if fault == "moved":
        n, s, e = host[k]
        host[k] = (n, s + 60.0, e + 60.0)
    else:
        del host[k]
    run = _run(recs, host, [("kernel", 500.0, 2400.0)])
    assert spans.align(run, recs) is None and spans.idle_by_span(run, recs) is None
    # the phases need no alignment: their device ms are the program's own
    assert spans.phase_ms(recs, "train.step", "train.g_backward") == pytest.approx(0.45)


def test_idle_gaps_go_to_the_innermost_span():
    recs = _steps(n=1)
    host = _anchored(recs, jitter=0.0)
    # trace us = host us from the epoch + 500; gaps start at 550 (augment), 800
    # (g_forward), 1005 (train.step, between phases) and 1405 (outside: after the step)
    device = [("k", 400.0, 550.0), ("k", 560.0, 800.0), ("k", 830.0, 1005.0), ("k", 1009.0, 1405.0),
              ("k", 1450.0, 1500.0)]
    run = _run(recs, host, device, units=1)
    run.trace.window = (400.0, 1500.0)
    idle = spans.idle_by_span(run, recs)
    assert idle["train.augment"] == pytest.approx(10.0)
    assert idle["train.g_forward"] == pytest.approx(30.0)
    assert idle["train.step"] == pytest.approx(4.0)
    assert idle[spans.OUTSIDE] == pytest.approx(45.0)


def test_phase_ms_is_a_mean_over_the_traced_units():
    recs = _steps(n=3) + [_rec("train.step", None, 5000, 5100, device_ms=9.0, unit=9, profiled=False)]
    assert spans.phase_ms(recs, "train.step", "train.step") == pytest.approx(0.95)
    assert spans.phase_ms(recs, "train.step", "train.augment", kind="host") == pytest.approx(0.19)
    assert spans.phase_ms(recs, "train.step", "train.d_step") is None
    assert spans.phase_ms(recs, "serve.request", "serve.forward") is None
    assert spans.phase_ms(None, "train.step", "train.augment") is None


def test_set_up_readers():
    recs = [
        _rec("setup.build", None, 0, 2e5, unit=None, profiled=False, setup=True),
        _rec("setup.build", 0, 1e5, 1.5e5, unit=None, profiled=False, setup=True),  # nested: counted once
        _rec("setup.build", None, 3e5, 3.5e5, unit=None, profiled=False, setup=True),
        _rec("train.step", None, 4e5, 9e5, unit=1, profiled=False, first=True),
        _rec("train.loss", 3, 5e5, 8e5, unit=1, profiled=False, first=True),
        _rec("kernels.build", 4, 5.5e5, 7.5e5, unit=1, profiled=False, first=True, setup=True),
        _rec("kernels.build", None, 9.5e5, 9.6e5, unit=None, profiled=False, setup=True),  # not in the step
        _rec("serve.request", None, 9.8e5, 9.9e5, unit=2, profiled=False, first=True),  # a later first call
    ]
    assert spans.build_s(recs) == pytest.approx(0.25)
    assert spans.first_unit_s(recs) == pytest.approx(0.3)
    assert spans.build_s([]) is None and spans.first_unit_s(recs[:3]) is None


def test_no_recorder_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, spans.MODULE, None)
    assert spans.records() is None and spans.build_s(spans.records()) is None


SMALL = {"settings": {"trace_units": 2, "trace_warmup": 1}}


def _f32(name):
    from h100_bench.lib import spec

    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    return {"model": {**cfg["model"], "compute_dtype": "float32"},
            "augment": {**cfg["augment"], "aug_dtype": "float32"}, "serve_precision": "f32"}


@pytest.mark.parametrize("cell,over,want", [
    ("r18-serve-b8", {"traffic": {"batch": 2, "size": [64, 96], "warmup_rounds": 1}},
     ("copy_in_ms.serve", "forward_ms.serve", "copy_in_idle_ms.serve", "forward_idle_ms.serve", "build_s.setup",
      "first_unit_s.setup")),
    ("r18-adv-train", {"traffic": {"batch": 2, "source": [64, 96], "target": [64, 96]}},
     ("augment_ms.train", "g_forward_ms.train", "d_step_ms.train", "loss_ms.train", "g_backward_ms.train",
      "optimizer_ms.train", "build_s.setup", "first_unit_s.setup")),
])
def test_traced_cpu_run_reads_every_span_metric(cell, over, want, capsys):
    """A whole ``--trace 1`` run on the CPU: the spans align with the trace
    by their own profiler ranges, and every new metric of the cell reads."""
    from rtda_semanticsegmentation_tpu_torch.obs import spans as port_spans

    port_spans.RECORDER.clear()  # one traced stretch a process, as the harness runs
    over = {**over, **SMALL, "config": _f32("bisenet-r18")}
    argv = ["--workload", cell, "--seed", "2147483711", "--seconds", "0.3", "--trace", "1"]
    assert harness.main(argv, require_card=False, device="cpu", overrides=over) == 0
    out, err = capsys.readouterr()
    metrics = json.loads(out.strip().splitlines()[-1])["metrics"]
    assert set(want) <= set(metrics), (sorted(metrics), err[-2000:])
    assert "residual" in err and "spans a unit over 2 units" in err

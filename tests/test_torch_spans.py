"""The port's spans and counters (``obs/spans.py``) on the CPU: which spans
the train step and the serving call record, and when; that they share the
profiler's clock; that they change no result; that an exported serving
graph holds none; and that the kernel wrappers' launch counters still read
under their module names. BiSeNet-R18 at 2 x 32 x 64, float32."""

import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtda_semanticsegmentation_tpu_torch import serving
from rtda_semanticsegmentation_tpu_torch.config import get_preset
from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3, conv4x4, int8_conv, lovasz
from rtda_semanticsegmentation_tpu_torch.models.factory import (
    build_discriminator,
    build_model,
    eval_variables,
    init_discriminator,
    init_model,
)
from rtda_semanticsegmentation_tpu_torch.obs import spans
from rtda_semanticsegmentation_tpu_torch.train.optim import build_discriminator_tx, build_generator_tx
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState
from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step

B, H, W = 2, 32, 64
ADV_CHILDREN = ["train.augment", "train.g_forward", "train.d_step", "train.loss", "train.g_backward",
                "train.optimizer"]
SOURCE_CHILDREN = [n for n in ADV_CHILDREN if n != "train.d_step"]
SERVE_CHILDREN = ["serve.copy_in", "serve.forward"]


def _cfg(adversarial: bool):
    cfg = get_preset("bisenet_adversarial_lovasz" if adversarial else "bisenet_source_small")
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                       augment=dataclasses.replace(cfg.augment, aug_dtype="float32"))


def _state(cfg, seed: int = 0) -> TrainState:
    model = build_model(cfg.model, "cpu", train=True)
    init_model(model, torch.Generator().manual_seed(seed))
    sched = poly_lr_schedule(cfg.optimizer.learning_rate, 100, cfg.optimizer.poly_power)
    state = TrainState(model, build_generator_tx(cfg.optimizer, model), sched)
    if cfg.adversarial.enabled:
        disc = build_discriminator(cfg.model, "cpu")
        init_discriminator(disc, torch.Generator().manual_seed(seed + 1))
        state.discriminator, state.d_optimizer = disc, build_discriminator_tx(cfg.adversarial, disc)
        state.d_schedule = poly_lr_schedule(cfg.adversarial.disc_learning_rate, 100, cfg.optimizer.poly_power)
    return state


def _batch(seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.randint(0, 256, (B, H, W, 3), generator=g, dtype=torch.uint8),
            "label": torch.randint(0, 19, (B, H, W), generator=g, dtype=torch.int32),
            "target_image": torch.randint(0, 256, (B, H, W, 3), generator=g, dtype=torch.uint8)}


class Job:
    """A state, its step function (first call already taken) and a batch."""

    def __init__(self, adversarial: bool, seed: int = 0):
        self.cfg = _cfg(adversarial)
        self.state = _state(self.cfg, seed)
        self.step = make_train_step(self.cfg, self.state.schedule, self.state.d_schedule)
        self.batch = _batch()
        self.gen = torch.Generator().manual_seed(7)
        self.metrics = self.run()

    def run(self) -> dict:
        self.state, metrics = self.step(self.state, self.batch, self.gen)
        return metrics


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def adv():
    return Job(adversarial=True)


@pytest.fixture(scope="module")
def src():
    return Job(adversarial=False)


@pytest.fixture(scope="module")
def serve():
    cfg = _cfg(False)
    model = build_model(cfg.model, "cpu", train=True)
    variables = eval_variables(init_model(model, torch.Generator().manual_seed(3)))
    fn = serving.make_serving_fn(cfg.model, cfg.augment, variables, "f32", device="cpu")
    frames = _batch(5)["image"]
    fn(frames)  # the first call
    return fn, frames


def _recorded(fn) -> list:
    """The spans ``fn()`` leaves in the recorder, as exported records."""
    t0 = time.time_ns()
    fn()
    return spans.export(since_ns=t0)


def _profiled(fn):
    """``fn()`` under a profiler that records the host; (spans, profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        fn()
    return spans.export(since_ns=t0), prof


def _children(records: list, root: str) -> list:
    (i,) = [k for k, r in enumerate(records) if r["name"] == root]
    return [r for r in records if r["parent"] == i]


def test_no_unit_span_without_a_profiler(adv, serve):
    fn, frames = serve
    assert _recorded(adv.run) == []
    assert _recorded(lambda: fn(frames)) == []


def _check_unit(records: list, root: str, children: list) -> None:
    kids = _children(records, root)
    assert [r["name"] for r in kids] == children
    (top,) = [r for r in records if r["name"] == root]
    assert top["parent"] is None and top["unit"] is not None
    assert all(r["unit"] == top["unit"] and r["profiled"] for r in records)
    for r in records:
        parent = top if r["parent"] is None else records[r["parent"]]
        assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= parent["t1_ns"], r["name"]
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(kids, kids[1:]))


def test_adversarial_step_records_its_six_phases(adv):
    records, _ = _profiled(adv.run)
    _check_unit(records, "train.step", ADV_CHILDREN)
    assert len(records) == 7  # no mesh: no train.grad_sync


def test_source_step_records_five_phases(src):
    records, _ = _profiled(src.run)
    _check_unit(records, "train.step", SOURCE_CHILDREN)


def test_serving_call_records_copy_in_and_forward(serve):
    fn, frames = serve
    records, _ = _profiled(lambda: fn(frames))
    _check_unit(records, "serve.request", SERVE_CHILDREN)
    assert all(r["device_ms"] == r["host_ms"] and not r["events"] for r in records)  # the CPU


@pytest.mark.parametrize("what", ["adversarial", "serve"])
def test_spans_share_the_profilers_clock(what, adv, serve):
    """Each span's host start and end lie within 50 us of the profiler's own
    range of the same name, on ``time.time_ns()``'s clock."""
    fn, frames = serve
    records, prof = _profiled(adv.run if what == "adversarial" else lambda: fn(frames))
    start_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(e.time_range)
    assert records
    for r in records:
        (rng,) = ranges[r["name"]]
        assert abs(start_us + rng.start - r["t0_ns"] / 1e3) < 50, r["name"]
        assert abs(start_us + rng.end - r["t1_ns"] / 1e3) < 50, r["name"]


def test_spans_on_give_the_same_bits_as_off():
    on, off = Job(adversarial=True, seed=4), Job(adversarial=True, seed=4)
    with profile(activities=[ProfilerActivity.CPU]):
        m_on = on.run()
    m_off = off.run()
    assert m_on.keys() == m_off.keys()
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k
    for a, b in ((on.state.model, off.state.model), (on.state.discriminator, off.state.discriminator)):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name


def test_first_call_records_without_a_profiler(adv):
    step = make_train_step(adv.cfg, adv.state.schedule, adv.state.d_schedule)
    first = _recorded(lambda: step(adv.state, adv.batch, adv.gen))
    assert [r["name"] for r in first if r["parent"] is None] == ["train.step"]
    assert [r["name"] for r in _children(first, "train.step")] == ADV_CHILDREN
    assert all(r["first"] and not r["profiled"] for r in first)
    assert _recorded(lambda: step(adv.state, adv.batch, adv.gen)) == []


def test_export_serving_graph_holds_no_span():
    cfg = _cfg(False)
    model = build_model(cfg.model, "cpu", train=True)
    variables = eval_variables(init_model(model, torch.Generator().manual_seed(3)))
    with profile(activities=[ProfilerActivity.CPU]):
        exported, _ = serving.export_serving(cfg.model, cfg.augment, variables, H, W, batch=B, precision="f32",
                                             device="cpu")
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t for t in targets)


@pytest.mark.parametrize("module,prefix,names", [
    (lovasz, "lovasz", ("hist_launches", "bwd_launches")),
    (conv4x4, "conv4x4", ("fwd_launches", "dw_launches", "dx_launches", "copies")),
    (conv3x3, "conv3x3", ("launches", "copies")),
    (int8_conv, "int8_conv", ("launches", "copies")),
])
def test_launch_counters_read_under_their_module_names(module, prefix, names):
    for name in names:
        before = getattr(module, name)
        spans.count(f"{prefix}.{name}", 3)
        assert getattr(module, name) == before + 3
        spans.set_counter(f"{prefix}.{name}", before)
        assert getattr(module, name) == before
    with pytest.raises(AttributeError):
        module.no_such_counter

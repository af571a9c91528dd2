"""Traffic kind ``serve_closed_loop``: one client that sends each request to
the port's serving entry as soon as the last one's masks are back.

Traffic parameters: ``batch`` frames of ``size`` [H, W] a request, uint8,
from a ``ring`` of distinct batches in pinned host memory, sent in an
order drawn from the seed; ``warmup_rounds`` through the ring in set-up;
``sample``, the requests whose masks are kept (drawn from the seed,
reservoir-style) and compared with the reference once the window has
closed.

A request is timed from the serving call with the frames in pinned host
memory to its uint8 masks on the host. The window sends requests until
``--seconds`` have passed on the host clock and ends when the last of
them is back: the rate is all frames over all that time, the 95th
percentile that of every request in it.
"""

from __future__ import annotations

import itertools
import math
import random
import time

import torch

from h100_bench.lib import compare, device as dev, scenes, trace as tr, weights
from h100_bench.lib.outcome import Context, Outcome
from h100_bench.lib.port import counted_since, counters, experiment
from h100_bench.lib.seeds import sub
from h100_bench.reference import nets
from h100_bench.reference.serve import batch_statistics, logits as reference_logits

KIND = "serve"


def make_weights(config: dict, traffic: dict, seed: int, device):
    """Seeded kernels; BatchNorm statistics of four seeded frames of the
    traffic's size (``reference/serve.py::batch_statistics``)."""
    model = config["model"]
    w = weights.make(nets.param_shapes(model, train=False), seed, "generator", device, config.get("init", ()),
                     rule=nets.arch(model).init_rule)
    gen = torch.Generator(device=device).manual_seed(sub(seed, "statistics"))
    frames = scenes.make(4, *traffic["size"], gen, model["num_classes"], with_labels=False)[0]
    batch_statistics(config, w, frames)
    return w


def make_ring(config: dict, traffic: dict, seed: int, device):
    """The ring's frames on the device (for the reference) and, on a card,
    in pinned host memory (what the requests send)."""
    gen = torch.Generator(device=device).manual_seed(sub(seed, "frames"))
    frames = [scenes.make(traffic["batch"], *traffic["size"], gen, config["model"]["num_classes"],
                          with_labels=False)[0] for _ in range(traffic["ring"])]
    host = [f.cpu().pin_memory() if dev.is_cuda(device) else f.clone() for f in frames]
    return frames, host


class Program:
    """The port's serving function of the configuration's precision."""

    def __init__(self, ctx: Context, precision: str = None):
        from rtda_semanticsegmentation_tpu_torch import serving

        self.ctx, self.device, self.traffic = ctx, ctx.device, ctx.traffic
        exp = experiment(ctx.config)
        variables = make_weights(ctx.config, ctx.traffic, ctx.seed, self.device)
        dev.reset_peak(self.device)  # the benchmark's statistics pass is not the program's
        precision = precision or ctx.config["serve_precision"]
        if precision == "int8":
            variables = self._calibrated(exp, variables)
        self.serve = serving.make_serving_fn(exp.model, exp.augment, variables, precision, device=self.device)
        del variables
        self.frames, self.host = make_ring(ctx.config, ctx.traffic, ctx.seed, self.device)
        self.order = list(range(len(self.host)))
        random.Random(sub(ctx.seed, "order")).shuffle(self.order)
        self.latency, self.dispatch, self.kept = [], [], []
        self.sampler = random.Random(sub(ctx.seed, "sample"))
        self.served = 0

    def _calibrated(self, exp, variables):
        """int8 statistics from two seeded batches the window never sends."""
        from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate
        from h100_bench.reference.augment import normalize

        gen = torch.Generator(device=self.device).manual_seed(sub(self.ctx.seed, "calibration"))
        k, t = exp.model.num_classes, self.traffic
        batches = [normalize(scenes.make(t["batch"], *t["size"], gen, k, with_labels=False)[0].float() / 255.0,
                             self.ctx.config["augment"]) for _ in range(2)]
        return calibrate(exp.model, variables, batches, device=self.device)

    def request(self, slot: int) -> None:
        t0 = time.perf_counter()
        out = self.serve(self.host[slot])
        t1 = time.perf_counter()
        masks = out.cpu()
        t2 = time.perf_counter()
        self.latency.append(t2 - t0)
        self.dispatch.append(t1 - t0)
        keep = self.traffic["sample"]
        if len(self.kept) < keep:
            self.kept.append((slot, masks))
        else:
            j = self.sampler.randrange(self.served + 1)
            if j < keep:
                self.kept[j] = (slot, masks)
        self.served += 1

    def warm(self) -> None:
        for _ in range(self.traffic["warmup_rounds"]):
            for slot in self.order:
                self.serve(self.host[slot]).cpu()

    def loop(self, seconds: float = None, count: int = None):
        """Requests back to back from now: until ``seconds`` have passed,
        or ``count`` of them. Returns (requests, seconds to the last
        one's masks)."""
        start = time.perf_counter()
        deadline = None if seconds is None else start + seconds
        i = 0
        while (count is None or i < count) and (deadline is None or time.perf_counter() < deadline):
            self.request(self.order[i % len(self.order)])
            i += 1
        return i, time.perf_counter() - start

    def close(self) -> None:
        del self.serve
        dev.free(self.device)


def mask_numbers(ctx: Context, frames, kept) -> dict:
    """The kept requests' masks against the reference
    (``lib/compare.py::mask_numbers``), worst over the requests."""
    weights_ = make_weights(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    out = {}
    for slot in sorted({s for s, _ in kept}):
        ref = reference_logits(ctx.config, weights_, frames[slot])
        for s, masks in kept:
            if s == slot:
                for k, v in compare.mask_numbers(ref, masks.to(ctx.device)).items():
                    out[k] = max(out.get(k, 0.0), v)
        del ref
    out["compared_requests"] = len(kept)
    return out


def run(ctx: Context) -> Outcome:
    traffic, settings = ctx.traffic, ctx.settings
    prog = Program(ctx)
    dev.note(f"set-up: program built {time.time() - ctx.started:.3f} s after the start")
    prog.warm()
    dev.sync(ctx.device)
    setup_s = time.time() - ctx.started
    peak = dev.peak_bytes(ctx.device)
    dev.note(f"smi before window: {dev.smi()}")
    dev.reset_peak(ctx.device)
    before = counters()
    n, secs = prog.loop(seconds=ctx.seconds)
    window_peak = dev.peak_bytes(ctx.device)
    counted = counted_since(before)
    dev.note(f"smi after window: {dev.smi()}")
    lat = sorted(prog.latency)
    # nearest rank: at least 95% of the requests took no longer
    p95 = lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] if lat else math.nan
    dispatch = list(prog.dispatch)
    trace = None
    if ctx.trace:
        slots = itertools.cycle(prog.order)
        trace = tr.capture(lambda: prog.serve(prog.host[next(slots)]).cpu(), settings["trace_units"],
                           settings["trace_warmup"], lambda: dev.sync(ctx.device))
    frames, kept = prog.frames, prog.kept
    prog.close()
    numbers = mask_numbers(ctx, frames, kept)
    b = traffic["batch"]
    flops = None
    if ctx.trace:
        from h100_bench.costs.flops import serve_flops

        flops = serve_flops(ctx.config, traffic)
    return Outcome(
        kind=KIND,
        end_to_end={"serve_img_s": n * b / secs, "serve_p95_ms": p95 * 1e3, "setup_s": setup_s},
        attempted=n, failed=0, numbers=numbers, limits=settings["limits"], units=n, window_s=secs, batch=b,
        setup_s=setup_s, peak_bytes=max(peak, window_peak), window_peak_bytes=window_peak, dispatch_s=dispatch,
        flops_per_unit=flops, trace=trace, counters=counted, config=ctx.config, traffic=traffic,
    )

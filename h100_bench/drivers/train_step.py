"""Traffic kind ``train_step``: the port's train step, driven back to back.

Traffic parameters: ``batch``; ``source`` [H, W] of the uint8 source
frames and int32 labels; ``target`` [H, W] of the uint8 target frames,
or null where the step has no target domain; ``ring``, the number of
distinct device-resident batches made in set-up and cycled through;
``first_steps``, the steps set-up drives and the reference follows.

Set-up builds one train state (G, and D where the configuration is
adversarial, with their optimizers and poly schedules) from the seed's
weights and hands it, after ``first_steps`` steps through the same call
and feed as the window's, to the window. The window runs steps until
``--seconds`` have passed on the host, then waits for the device: the
rate is all steps over all that time. With ``--trace 1`` a traced stretch
of ``trace_units`` more steps follows, after ``trace_warmup`` steps under
the profiler that are not kept (the cell's settings; ``host_cpus``, where
set, keeps the process on that many CPUs from the window on). Then the
program is freed and the reference follows the first steps from the same
weights, frames and generator states.
"""

from __future__ import annotations

import time

import torch

from h100_bench.lib import compare, device as dev, scenes, trace as tr, weights
from h100_bench.lib.outcome import Context, Outcome
from h100_bench.lib.port import counted_since, counters, experiment
from h100_bench.lib.seeds import sub
from h100_bench.reference import nets
from h100_bench.reference.train import follow

KIND = "train"


def make_weights(config: dict, seed: int, device):
    model = config["model"]
    g = weights.make(nets.param_shapes(model, train=True), seed, "generator", device, config.get("init", ()),
                     rule=nets.arch(model).init_rule)
    d = None
    if config["adversarial"]["enabled"]:
        d = weights.make(nets.discriminator_shapes(model), seed, "discriminator", device, config.get("d_init", ()),
                         rule=nets.default_init)
    return g, d


def make_ring(config: dict, traffic: dict, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(sub(seed, "frames"))
    k = config["model"]["num_classes"]
    ring = []
    for _ in range(traffic["ring"]):
        frames, labels = scenes.make(traffic["batch"], *traffic["source"], gen, k)
        batch = {"image": frames, "label": labels}
        if traffic.get("target"):
            batch["target_image"] = scenes.make(traffic["batch"], *traffic["target"], gen, k, with_labels=False)[0]
        ring.append(batch)
    return ring


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def _first_grads(module, optimizer, prefix: str) -> dict:
    """Each leaf's first gradient as the optimizer took it, from its state
    after one step: Adam's first moment over (1 - beta1), or SGD's
    momentum buffer."""
    names = {id(p): n for n, p in module.named_parameters()}
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "exp_avg" in st:
                out[prefix + names[id(p)]] = st["exp_avg"] / (1.0 - group["betas"][0])
            elif "momentum_buffer" in st:
                out[prefix + names[id(p)]] = st["momentum_buffer"]
    return out


class Program:
    """The port's train state and step, built from the seed."""

    def __init__(self, ctx: Context):
        from rtda_semanticsegmentation_tpu_torch.models import factory
        from rtda_semanticsegmentation_tpu_torch.train import optim, schedule, state, steps

        self.ctx, self.device = ctx, ctx.device
        cfg = ctx.config
        exp = experiment(cfg)
        g_w, d_w = make_weights(cfg, ctx.seed, self.device)
        self.start = {f"g.{k}": v.clone() for k, v in g_w.items()}
        model = factory.build_model(exp.model, self.device, train=True)
        factory.load_variables(model, g_w)
        max_iter, power = cfg["schedule"]["max_iter"], exp.optimizer.poly_power
        g_sched = schedule.poly_lr_schedule(exp.optimizer.learning_rate, max_iter, power)
        tx = optim.build_generator_tx(exp.optimizer, model, freeze_bn=cfg.get("freeze_bn", False),
                                      decay_exempt=() if exp.loss.aux_weight else factory.AUX_HEADS)
        self.state = state.TrainState(model, tx, g_sched)
        d_sched = None
        if exp.adversarial.enabled:
            disc = factory.build_discriminator(exp.model, self.device, fused_conv1=cfg.get("fused_conv1", False))
            factory.load_variables(disc, d_w)
            self.start.update({f"d.{k}": v.clone() for k, v in d_w.items()})
            d_sched = schedule.poly_lr_schedule(exp.adversarial.disc_learning_rate, max_iter, power)
            self.state.discriminator = disc
            self.state.d_optimizer = optim.build_discriminator_tx(exp.adversarial, disc)
            self.state.d_schedule = d_sched
        del g_w, d_w
        self.step = steps.make_train_step(exp, g_sched, d_sched)
        self.ring = make_ring(cfg, ctx.traffic, ctx.seed, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(sub(ctx.seed, "augment"))
        self.gen_states = []
        self.t = 0

    def one(self) -> dict:
        batch = self.ring[self.t % len(self.ring)]
        self.state, metrics = self.step(self.state, batch, self.gen)
        self.t += 1
        return metrics

    def first_steps(self, n: int) -> dict:
        out = {"loss": [], "loss_d": []}
        st = self.state
        for t in range(n):
            self.gen_states.append(self.gen.get_state())
            m = self.one()
            if t == 0:
                grads = _first_grads(st.model, st.optimizer, "g.")
                if st.discriminator is not None:
                    grads.update(_first_grads(st.discriminator, st.d_optimizer, "d."))
                out["grad"] = _norms(grads)
            out["loss"].append(float(m["loss"]))
            if "loss_d" in m:
                out["loss_d"].append(float(m["loss_d"]))
        now = {f"g.{k}": v for k, v in st.model.state_dict().items()}
        if st.discriminator is not None:
            now.update({f"d.{k}": v for k, v in st.discriminator.state_dict().items()})
        out["change"] = _norms({k: now[k].float() - self.start[k] for k in self.start if k in now})
        del self.start
        return out

    def window(self, seconds: float):
        dev.sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.one()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dev.sync(self.device)
        return n, time.perf_counter() - t0

    def close(self) -> None:
        del self.state, self.step
        dev.free(self.device)


def reference(ctx: Context, ring, gen_states, fp8: bool = False) -> dict:
    """The reference's readings of the first steps (``fp8``: the control's)."""
    g_w, d_w = make_weights(ctx.config, ctx.seed, ctx.device)
    batches = [ring[t % len(ring)] for t in range(len(gen_states))]
    out = follow(ctx.config, g_w, d_w, batches, gen_states, ctx.device, fp8)
    del g_w, d_w
    dev.free(ctx.device)
    return out


def run(ctx: Context) -> Outcome:
    traffic, settings = ctx.traffic, ctx.settings
    prog = Program(ctx)
    dev.note(f"set-up: program built {time.time() - ctx.started:.3f} s after the start")
    prog_read = prog.first_steps(traffic["first_steps"])
    dev.sync(ctx.device)
    setup_s = time.time() - ctx.started
    peak = dev.peak_bytes(ctx.device)
    dev.note(f"smi before window: {dev.smi()}")
    dev.reset_peak(ctx.device)
    if settings.get("host_cpus") and dev.is_cuda(ctx.device):
        dev.note(f"host: the window's threads kept on CPUs {dev.pin_host(settings['host_cpus'])}")
    before = counters()
    steps, secs = prog.window(ctx.seconds)
    window_peak = dev.peak_bytes(ctx.device)
    counted = counted_since(before)
    dev.note(f"smi after window: {dev.smi()}")
    trace = None
    if ctx.trace:
        trace = tr.capture(prog.one, settings["trace_units"], settings["trace_warmup"], lambda: dev.sync(ctx.device))
    ring, gen_states = prog.ring, prog.gen_states
    prog.close()
    ref = reference(ctx, ring, gen_states)
    numbers = compare.train_numbers(prog_read, ref)
    b = traffic["batch"]
    loss = ctx.config["loss"]
    shapes = {}
    if loss["use_lovasz"]:
        shapes["lovasz"] = (b, ctx.config["model"]["num_classes"], traffic["source"][0] * traffic["source"][1],
                            loss["lovasz_bins"], loss["lovasz_interp"])
    flops = None
    if ctx.trace:
        from h100_bench.costs.flops import train_step_flops

        flops = train_step_flops(ctx.config, traffic)
    return Outcome(
        kind=KIND, end_to_end={"train_img_s": steps * b / secs, "setup_s": setup_s},
        attempted=steps, failed=0, numbers=numbers, limits=settings["limits"], units=steps, window_s=secs,
        batch=b, setup_s=setup_s, peak_bytes=max(peak, window_peak), window_peak_bytes=window_peak,
        flops_per_unit=flops, trace=trace, shapes=shapes, counters=counted, config=ctx.config, traffic=traffic,
    )


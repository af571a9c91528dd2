#!/usr/bin/env python3
"""Where the train-step time of the PyTorch port goes on one CUDA GPU.

    python3 profile_train.py [--mode source|flagship|both|loop]

Runs the train configurations of ``chip_smoke.py``, seeded random init and
synthetic frames: ``source``, preset ``bisenet_source_aug`` with the binned
Lovász loss (BiSeNet-R18 in bf16, Adam, ``all_four_combined`` augmentation,
batch 8 at 512x1024), and ``flagship``, preset
``bisenet_adversarial_lovasz`` (the same G plus the FC-Discriminator with
its first conv on K5a-c; source 720x1280, target 512x1024, batch 8). For
each, after 3 warm-up steps it prints, twice (the repeat shows the
spread):

- ms/step by CUDA events over 5 steps, with no profiler attached;
- the device kernel time per step from ``torch.profiler`` over 3 steps,
  split into kernel groups, and the kernels launched per step;
- the device idle share, ``1 - kernel ms / step ms``.

Last it times the augmentation alone (``augment_batch`` on the source
batch, CUDA events over 10 calls), which the elementwise group contains.

``loop`` runs the flagship preset through ``train/loop.py::run_experiment``
instead, twice: synthetic train, target and validation sets at the
preset's sizes, batch 8, one epoch of 12 steps (96 samples), train scalars
logged every 100 steps (no host sync per step), D on cuDNN as the loop
builds it, a ``torch.profiler`` trace of steps 4-7. It prints each step's
time on the device's timeline (which holds the device's waits for the
host), the host's wait for each batch, their medians from step 4, and from
the trace the kernel time and the device's idle share over those 4 steps; and the host's time to make one batch of
synthetic frames (8 source + 8 target), serially and on the loader's
threads.

The last line is a JSON summary of all of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from rtda_semanticsegmentation_tpu_torch.ops.augment import augment_batch

PROFILED, TIMED, WARMUP = 3, 5, 3

# (group, substrings of the kernel name), first match wins
GROUPS = (
    ("K5a conv_fwd_kernel", ("conv_fwd_kernel",)),
    ("K5b conv_dw_kernel (+ its block reduce)", ("conv_dw_kernel", "conv_dw_reduce")),
    ("K5c conv_dx_kernel", ("conv_dx_kernel",)),
    ("K1 lovasz_hist (+ its block reduce)", ("lovasz_hist",)),
    ("K2 lovasz_bwd", ("lovasz_bwd",)),
    ("convs, forward and backward (cuDNN / CUTLASS)",
     ("cudnn", "cutlass", "xmma", "sm90", "conv", "wgrad", "dgrad", "implicit", "gemm")),
    ("optimizer and grad norm (foreach)", ("multi_tensor", "foreach")),
    ("bilinear upsample, forward and backward", ("upsample",)),
    ("softmax and cross-entropy", ("softmax", "nll", "cross_entropy", "log_softmax")),
    ("reductions (BN statistics, means, sums)", ("reduce",)),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise / copies (BN apply, ReLU, casts, augmentation)"


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profile_steps(state, step, batch, gen) -> dict:
    state, _ = step(state, batch, gen)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED):
        state, _ = step(state, batch, gen)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TIMED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    # device events, less the ranges of user annotations (Optimizer.step),
    # which span kernels counted on their own
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and _device_us(e) > 0 and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    groups: dict = {}
    for e in kernels:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + _device_us(e) / 1e3 / PROFILED
    kernel_ms = sum(groups.values())
    return {
        "ms": ms,
        "kernel_ms": kernel_ms,
        "idle_share": max(0.0, 1.0 - kernel_ms / ms),
        "kernels_per_step": sum(e.count for e in kernels) / PROFILED,
        "groups": groups,
        "top": [(e.key[:100], _device_us(e) / 1e3 / PROFILED, e.count / PROFILED)
                for e in sorted(kernels, key=_device_us, reverse=True)[:12]],
    }


def _setup(mode: str):
    """(cfg, state, step, batch) of one train configuration."""
    if mode == "source":
        cfg = cs.get_preset("bisenet_source_aug")
        cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, use_lovasz=True))
        state, step = cs._train_setup(cfg, cs.DEV)
        return cfg, state, step, cs._train_batch(cfg.train.batch_size, *cfg.train_size, 21, cs.DEV)
    cfg = cs.get_preset("bisenet_adversarial_lovasz")
    state, step = cs._train_setup(cfg, cs.DEV, fused_conv1=True)
    batch = cs._adversarial_batch(cfg.train.batch_size, cfg.train_size, cfg.data.cityscapes_size, 31, cs.DEV)
    return cfg, state, step, batch


def profile_mode(mode: str) -> dict:
    cfg, state, step, batch = _setup(mode)
    h, w = cfg.train_size
    b = cfg.train.batch_size
    gen = torch.Generator(device=cs.DEV).manual_seed(7)
    for _ in range(WARMUP):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    runs = []
    for _ in range(2):
        r = profile_steps(state, step, batch, gen)
        runs.append(r)
        print(f"== {mode} train step ({cfg.train_mode}) b{b} {h}x{w}: {r['ms']:.3f} ms/step, "
              f"{b * 1e3 / r['ms']:.1f} source img/s (CUDA events, no profiler); kernel time "
              f"{r['kernel_ms']:.3f} ms/step, {r['kernels_per_step']:.1f} kernels/step, "
              f"idle share {r['idle_share']:.3f}")
        for g, t in sorted(r["groups"].items(), key=lambda kv: -kv[1]):
            print(f"  {t:8.3f} ms  {g}")
        for name, t, n in r["top"]:
            print(f"  {t:8.3f} ms x{n:5.1f}  {name}")
    aug_ms = cs.cuda_ms(lambda: augment_batch(batch["image"], batch["label"], gen, cfg.augment), 10)
    print(f"{mode}: augmentation alone ({cfg.augment.pipeline}, {cfg.augment.aug_dtype}): {aug_ms:.3f} ms/step")
    return {"runs": runs, "augment_ms": aug_ms}


LOOP_STEPS, LOOP_TRACED = 12, 4
LOOP_DIR = os.path.join("build", "profile_loop")


def _trace_kernels(trace_dir: str) -> tuple:
    """(kernel ms, window ms) of the chrome trace the loop wrote: the sum of
    the device kernels' durations and the span from the first kernel's
    start to the last one's end."""
    (name,) = os.listdir(trace_dir)
    events = json.load(open(os.path.join(trace_dir, name)))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the loop's trace has no device kernels")
    start = min(e["ts"] for e in kernels)
    end = max(e["ts"] + e["dur"] for e in kernels)
    return sum(e["dur"] for e in kernels) / 1e3, (end - start) / 1e3


def _host_batch_ms(cfg) -> tuple:
    """Host ms to make one batch of synthetic frames (8 source at the train
    size, 8 target at the target size), serially and on the loader's
    threads."""
    from rtda_semanticsegmentation_tpu_torch.data.datasets import SyntheticDataset

    b = cfg.train.batch_size
    sets = [SyntheticDataset(b, cfg.train_size), SyntheticDataset(b, cfg.data.cityscapes_size)]
    t0 = time.perf_counter()
    for ds in sets:
        [ds.load(i) for i in range(b)]
    serial = (time.perf_counter() - t0) * 1e3
    with ThreadPoolExecutor(cfg.data.resolved_num_workers()) as pool:
        t0 = time.perf_counter()
        for ds in sets:
            list(pool.map(ds.load, range(b)))
        threaded = (time.perf_counter() - t0) * 1e3
    return serial, threaded


def profile_loop() -> dict:
    from rtda_semanticsegmentation_tpu_torch.train.loop import TRACE_SKIP, run_experiment

    cfg = cs.get_preset("bisenet_adversarial_lovasz")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, train_dataset="synthetic", val_dataset="synthetic",
                                 adversarial_target_dataset="synthetic", synthetic_length=LOOP_STEPS * 8),
        train=dataclasses.replace(cfg.train, epochs=1, steps_per_epoch=LOOP_STEPS, profile_steps=LOOP_TRACED,
                                  checkpoint_dir=os.path.join(LOOP_DIR, "ckpt")),
        obs=dataclasses.replace(cfg.obs, backend="null", log_dir=os.path.join(LOOP_DIR, "logs")),
    )
    runs = []
    for i in range(2):
        shutil.rmtree(LOOP_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        report = run_experiment(cfg, run_name="loop", measure_performance=False, verbose=False)
        seconds = time.perf_counter() - t0
        t = report["timings"]
        steps, waits = t["step_ms"], t["loader_wait_ms"]
        kernel_ms, window_ms = _trace_kernels(os.path.join(LOOP_DIR, "logs", "loop", "trace"))
        r = {
            "step_ms": steps, "loader_wait_ms": waits, "seconds": seconds,
            # a step's device-timeline time holds the device's wait for the
            # host, the wait for the next batch included; medians, since the
            # step that ends the trace also writes it
            "device_ms_from_4": float(np.median(steps[TRACE_SKIP:])),
            "wait_ms_from_4": float(np.median(waits[TRACE_SKIP:])),
            "traced_kernel_ms_per_step": kernel_ms / LOOP_TRACED,
            "traced_window_ms_per_step": window_ms / LOOP_TRACED,
            "traced_idle_share": max(0.0, 1.0 - kernel_ms / window_ms),
            "eval_ms_per_batch": t["eval_ms_per_batch"], "checkpoint_save_s": t["checkpoint_save_s"],
        }
        runs.append(r)
        print(f"== loop run {i + 1}, flagship through run_experiment, {LOOP_STEPS} steps: "
              f"{seconds:.1f} s for the run; ms/step on the device timeline "
              + " ".join(f"{x:.1f}" for x in steps) + "; loader wait ms/step "
              + " ".join(f"{x:.1f}" for x in waits))
        print(f"  medians from step {TRACE_SKIP + 1}: {r['device_ms_from_4']:.3f} ms/step on the device timeline, "
              f"of which the host waited {r['wait_ms_from_4']:.3f} ms/step for batches; traced "
              f"steps: kernel time {r['traced_kernel_ms_per_step']:.3f} ms/step over a window of "
              f"{r['traced_window_ms_per_step']:.3f} ms/step, idle share {r['traced_idle_share']:.3f}; eval "
              f"ms/batch {t['eval_ms_per_batch']}; checkpoint save s {t['checkpoint_save_s']}")
        del report
    serial, threaded = _host_batch_ms(cfg)
    print(f"loop: the host makes one batch of synthetic frames (8 x {cfg.train_size} + 8 x "
          f"{cfg.data.cityscapes_size}) in {serial:.1f} ms serially, {threaded:.1f} ms on "
          f"{cfg.data.resolved_num_workers()} threads")
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    return {"runs": runs, "host_batch_ms": {"serial": serial, "threads": threaded}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=("source", "flagship", "both", "loop"), default="both")
    args = parser.parse_args()
    smi = cs.phase_device()
    out = {"card": smi}
    if args.mode == "loop":
        out["loop"] = profile_loop()
    else:
        for mode in ("source", "flagship") if args.mode == "both" else (args.mode,):
            out[mode] = profile_mode(mode)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

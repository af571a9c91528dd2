#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda);
without a device it raises and prints no result. Phases, each raising on
failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``csrc/int8_conv.cu`` and ``csrc/lovasz.cu`` for sm_90a
   into build/kernels/, one nvcc each, started together; prints the ptxas
   reports;
3. kernels: the s8 conv kernel (K3) against its plain PyTorch version at
   every quantized conv shape of BiSeNet-R18 at 512x1024, batch 8: bf16
   outputs and requantized s8 codes must be bit-identical; the Lovász
   histogram (K1) and backward (K2) against theirs at the train path's
   shape, (8, 19, 512*1024) softmax probabilities with ~10% ignore labels:
   K1's count and fg rows and all of K2's output (both table forms) must be
   identical, K1's error sums within 1e-4 relative (f32 sums of up to 4 M
   terms in another order). Times each kernel, its plain version and its
   bound;
4. serve: BiSeNet-R18 with seeded random weights, calibrated on 2 batches
   of 8 synthetic frames and frozen, serves 4 requests of 8 frames through
   ``make_serving_fn`` in bf16 and int8. Masks must be uint8 (8, 512, 1024)
   below 19, logits finite, each int8 request must launch K3 exactly 15
   times, and the int8 masks must match those of the same model with the
   kernel swapped for its plain version (>= 0.999 of pixels); the f32
   forward on the card must match the CPU's on a small input. Prints img/s;
5. train: the ``bisenet_source_aug`` preset with the binned Lovász loss
   (BiSeNet-R18, bf16, Adam, ``all_four_combined`` augmentation, batch 8 at
   512x1024) from a seeded init on synthetic frames and structured labels.
   From one saved state, a step with the kernels and a step with their plain
   versions agree (loss within 1e-4, grad norm within 1e-2 relative); an f32
   step at 2x64x96 on the card matches the same step on the CPU, TF32 off
   (losses within 1e-4 relative, grad norm within 1e-2: the convs, the
   BatchNorm statistics and K1's error sums add in other orders). Then 8
   steps on one repeated batch: every loss finite, the mean of the last 3
   below the first, K1 and K2 launched exactly once per step. Prints
   ms/step and img/s (CUDA events, after 3 warm-up steps) and the peak
   device memory.

The last two lines are a JSON summary of the kernels and the result line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rtda_semanticsegmentation_tpu_torch.config import AugmentConfig, ModelConfig, get_preset
from rtda_semanticsegmentation_tpu_torch.kernels import build as kbuild
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate, freeze
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.ops.losses import _binned_lovasz_forward
from rtda_semanticsegmentation_tpu_torch.serving import make_serving_fn
from rtda_semanticsegmentation_tpu_torch.train.optim import build_generator_tx
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState
from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step

BATCH, H, W = 8, 512, 1024
REQUESTS = 4
QUANT_CONVS = 15
# BiSeNet-R18's quantized convs at 512x1024 (quant_min_ch=128):
# (where, cin, cout, input h, input w, kernel, stride, pad, convs per forward)
SHAPES = (
    ("layer2 3x3/s1", 128, 128, 64, 128, 3, 1, 1, 3),
    ("layer3 3x3/s1", 256, 256, 32, 64, 3, 1, 1, 3),
    ("layer4 3x3/s1", 512, 512, 16, 32, 3, 1, 1, 3),
    ("ffm 3x3/s1", 1024, 19, 64, 128, 3, 1, 1, 1),
    ("spatial_path/convblock3 3x3/s2", 128, 256, 128, 256, 3, 2, 1, 1),
    ("layer3_0/conv1 3x3/s2", 128, 256, 64, 128, 3, 2, 1, 1),
    ("layer4_0/conv1 3x3/s2", 256, 512, 32, 64, 3, 2, 1, 1),
    ("layer3_0/downsample 1x1/s2", 128, 256, 64, 128, 1, 2, 0, 1),
    ("layer4_0/downsample 1x1/s2", 256, 512, 32, 64, 1, 2, 0, 1),
)
DEV = torch.device("cuda", 0)
# the train phase: classes, Lovász bins, steps on the card, of which warm-up
CLASSES, BINS = 19, 256
TRAIN_STEPS, WARMUP_STEPS = 8, 3
MAX_ITER = 1000
EXEMPT = ("supervision1", "supervision2")
# published H100 SXM peaks (dense): int8 tensor-core rate and HBM bandwidth
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the device, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        for f in [pool.submit(k3._library), pool.submit(klov._library)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kbuild.nvcc_path()})")
    for source, info in kbuild.build_log.items():
        print(f"build log {source} ({info['seconds']:.2f} s):\n{info['log']}")


def bound_ms(nbytes: float, int8_ops: float = 0.0):
    """The least time the card could take: the larger of bytes over the
    memory rate and int8 operations over the int8 peak. Returns (ms,
    bound_by)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, int8_ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _conv_case(i, cin, cout, h, w, k):
    g = torch.Generator(device=DEV).manual_seed(1000 + i)
    xq = torch.randint(-127, 128, (BATCH, h, w, cin), generator=g, device=DEV, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=DEV, dtype=torch.int8)
    # scale so z = acc * a + b spans a few units and the requantized codes
    # fill the grid instead of clipping: std(acc) ~ 73.3^2 * sqrt(k*k*cin)
    a = torch.rand(cout, generator=g, device=DEV) * 2.0 / (73.3 ** 2 * (k * k * cin) ** 0.5)
    b = torch.randn(cout, generator=g, device=DEV, dtype=torch.float32) * 0.5
    inv = (torch.rand(cout, generator=g, device=DEV) + 0.5) * 100.0
    return xq, wq, a, b, inv


def phase_kernels() -> dict:
    total_ms = total_plain_ms = total_bound = 0.0
    by_ops = by_bytes = 0.0
    max_err = 0.0
    for i, (where, cin, cout, h, w, k, s, p, count) in enumerate(SHAPES):
        xq, wq, a, b, inv = _conv_case(i, cin, cout, h, w, k)
        kw = dict(stride=s, padding=p)
        out = k3.int8_conv(xq, wq, a, b, relu=False, out_dtype=torch.bfloat16, **kw)
        ref = k3.int8_conv_plain(xq, wq, a, b, relu=False, out_dtype=torch.bfloat16, **kw)
        codes = k3.int8_conv(xq, wq, a, b, inv, relu=True, **kw)
        codes_ref = k3.int8_conv_plain(xq, wq, a, b, inv, relu=True, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        code_err = (codes.int() - codes_ref.int()).abs().max().item()
        if not torch.equal(out, ref) or not torch.equal(codes, codes_ref):
            raise AssertionError(
                f"{where}: kernel differs from its plain version "
                f"(bf16 max |diff| {err}, s8 codes max |diff| {code_err})"
            )
        max_err = max(max_err, err, float(code_err))
        ms = cuda_ms(lambda: k3.int8_conv(xq, wq, a, b, relu=False, out_dtype=torch.bfloat16, **kw), 20)
        plain_ms = cuda_ms(
            lambda: k3.int8_conv_plain(xq, wq, a, b, relu=False, out_dtype=torch.bfloat16, **kw), 5, 1
        )
        ho, wo = out.shape[1], out.shape[2]
        ops = 2.0 * BATCH * ho * wo * cout * k * k * cin
        # s8 input and weights, f32 a and b read once; bf16 output written once
        nbytes = BATCH * h * w * cin + k * k * cin * cout + 8 * cout + 2 * BATCH * ho * wo * cout
        bound, by = bound_ms(nbytes, ops)
        tops = ops / (ms * 1e-3) / 1e12
        print(f"kernel {where} {cin}->{cout} @{h}x{w} b{BATCH}: bit-identical (bf16 and s8); "
              f"kernel {ms:.4f} ms ({tops:.1f} TOP/s), plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), x{count} per forward")
        total_ms += count * ms
        total_plain_ms += count * plain_ms
        total_bound += count * bound
        by_ops += count * (bound if by == "operations" else 0.0)
        by_bytes += count * (bound if by == "bytes" else 0.0)
    print(f"kernel total over one forward's {QUANT_CONVS} quantized convs: "
          f"{total_ms:.4f} ms kernel, {total_plain_ms:.4f} ms plain, {total_bound:.4f} ms bound")
    # no PyTorch call computes an s8 convolution on CUDA: no library time
    return {"ms": total_ms, "plain_ms": total_plain_ms, "max_abs_err": max_err,
            "bound_ms": total_bound, "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": None}


def _lovasz_case():
    """(8, 19, 512*1024) probabilities from a seeded softmax, spread so the
    buckets fill, and labels with ~10% ignore, on the card."""
    g = torch.Generator(device=DEV).manual_seed(2)
    n = H * W
    logits = torch.randn((BATCH, CLASSES, n), generator=g, device=DEV) * 3.0
    probas = torch.softmax(logits, dim=1)
    labels = torch.randint(0, CLASSES, (BATCH, n), generator=g, device=DEV, dtype=torch.int32)
    labels[torch.rand((BATCH, n), generator=g, device=DEV) < 0.1] = 255
    return probas, labels


def phase_lovasz_kernels() -> dict:
    probas, labels = _lovasz_case()
    p_bytes, l_bytes = probas.numel() * 4, labels.numel() * 4
    hist = klov.lovasz_hist(probas, labels, BINS, 255)
    ref = klov.lovasz_hist_plain(probas, labels, BINS, 255)
    torch.cuda.synchronize()
    if not torch.equal(hist[:, :2], ref[:, :2]):
        raise AssertionError("K1: count/fg rows differ from the plain version")
    err = (hist[:, 2] - ref[:, 2]).abs()
    hist_err = err.max().item()
    if not bool((err <= 1e-4 * ref[:, 2].abs().clamp_min(1.0)).all()):
        raise AssertionError(f"K1: error sums differ from the plain version by up to {hist_err}")
    _, tables, _ = _binned_lovasz_forward(hist, "present", True)
    tables = (tables * 0.37).contiguous()  # a cotangent / present-count fold
    for interp, table in ((True, tables), (False, tables[:, 1].contiguous())):
        got = klov.lovasz_bwd(probas, labels, table, BINS, 255, interp)
        want = klov.lovasz_bwd_plain(probas, labels, table, BINS, 255, interp)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 (interp={interp}) differs from the plain version: "
                                 f"max |diff| {(got - want).abs().max().item()}")
    print(f"kernel lovasz_hist (8, 19, {H * W}) bins {BINS}: count/fg rows identical, "
          f"error sums max |diff| {hist_err:.3e}; lovasz_bwd: identical (both table forms)")
    out = {}
    for name, fn, plain, nbytes in (
        ("lovasz_hist", lambda: klov.lovasz_hist(probas, labels, BINS, 255),
         lambda: klov.lovasz_hist_plain(probas, labels, BINS, 255),
         p_bytes + l_bytes + CLASSES * 3 * BINS * 4),
        ("lovasz_bwd", lambda: klov.lovasz_bwd(probas, labels, tables, BINS, 255, True),
         lambda: klov.lovasz_bwd_plain(probas, labels, tables, BINS, 255, True),
         2 * p_bytes + l_bytes + tables.numel() * 4),
    ):
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(plain, 5, 1)
        bound, by = bound_ms(nbytes)
        print(f"kernel {name}: {ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s), plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
        # no single PyTorch call computes either function: no library time
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "max_abs_err": hist_err if name == "lovasz_hist" else 0.0}
    return out


def _frames(seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (BATCH, H, W, 3), np.uint8)).to(DEV)


def _check_masks(masks, what):
    if masks.dtype != torch.uint8 or tuple(masks.shape) != (BATCH, H, W):
        raise AssertionError(f"{what}: masks {masks.dtype} {tuple(masks.shape)}")
    if int(masks.max()) >= 19:
        raise AssertionError(f"{what}: mask value {int(masks.max())} >= 19")


def phase_slice() -> int:
    aug = AugmentConfig()
    cfg = ModelConfig(compute_dtype="bfloat16")
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    variables = {k: v.to(DEV) for k, v in variables.items()}

    # the f32 forward on the card against the CPU's, on a small input
    small = np.random.RandomState(7).randint(0, 256, (2, 64, 128, 3), np.uint8)
    f32 = ModelConfig(compute_dtype="float32")
    cpu_vars = {k: v.cpu() for k, v in variables.items()}
    lg_gpu = make_serving_fn(f32, aug, variables, "f32", device=DEV).logits(torch.from_numpy(small)).cpu()
    lg_cpu = make_serving_fn(f32, aug, cpu_vars, "f32", device="cpu").logits(torch.from_numpy(small))
    f32_err = (lg_gpu - lg_cpu).abs().max().item()
    scale = lg_cpu.abs().max().item()
    agree_small = (lg_gpu.argmax(1) == lg_cpu.argmax(1)).float().mean().item()
    print(f"f32 forward, card vs CPU at 2x64x128: max |diff| {f32_err:.3e} (max |logit| {scale:.3e}), "
          f"argmax agreement {agree_small:.6f}")
    if not f32_err <= 1e-3 * scale or agree_small < 0.999:
        raise AssertionError("the f32 forward on the card disagrees with the CPU's")

    t0 = time.perf_counter()
    calib = [normalize_u8(_frames(s), aug) for s in (1, 2)]
    variables = freeze(cfg, calibrate(cfg, variables, calib, device=DEV))
    torch.cuda.synchronize()
    print(f"calibrate (2 x {BATCH} frames) + freeze: {time.perf_counter() - t0:.2f} s")

    serve_bf16 = make_serving_fn(cfg, aug, variables, "bf16", device=DEV)
    serve_int8 = make_serving_fn(cfg, aug, variables, "int8", device=DEV)
    requests = [_frames(100 + r) for r in range(REQUESTS)]

    masks_bf16 = [serve_bf16(x) for x in requests]
    # the main path: the kernel's launches during the int8 requests only
    k3.launches = 0
    masks_int8 = [serve_int8(x) for x in requests]
    torch.cuda.synchronize()
    launches = k3.launches
    print(f"int8 serving: {launches} kernel launches over {REQUESTS} requests")
    if launches != QUANT_CONVS * REQUESTS:
        raise AssertionError(f"expected {QUANT_CONVS * REQUESTS} kernel launches, got {launches}")
    for what, masks in (("bf16", masks_bf16), ("int8", masks_int8)):
        for m in masks:
            _check_masks(m, what)
        lg = (serve_bf16 if what == "bf16" else serve_int8).logits(requests[0])
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{what}: non-finite logits")

    # the same int8 model with the kernel swapped for its plain version
    kernel = k3.int8_conv
    k3.int8_conv = k3.int8_conv_plain
    try:
        masks_plain = [serve_int8(x) for x in requests]
    finally:
        k3.int8_conv = kernel
    agree_plain = float(np.mean([(a == b).float().mean().item() for a, b in zip(masks_int8, masks_plain)]))
    agree_bf16 = float(np.mean([(a == b).float().mean().item() for a, b in zip(masks_int8, masks_bf16)]))
    print(f"int8 masks vs the plain-version int8 masks: agreement {agree_plain:.6f}")
    print(f"int8 vs bf16 mask agreement (random weights, informational): {agree_bf16:.6f}")
    if agree_plain < 0.999:
        raise AssertionError(f"int8 kernel path agrees with its plain version on only {agree_plain:.6f}")

    for what, serve in (("bf16", serve_bf16), ("int8", serve_int8)):
        ms = cuda_ms(lambda: serve(requests[0]), 10)
        print(f"serve {what} b{BATCH} {H}x{W}: {ms:.3f} ms/request, {BATCH * 1e3 / ms:.1f} img/s")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _train_batch(b: int, h: int, w: int, seed: int, device) -> dict:
    """Synthetic uint8 frames and structured labels: classes in 64x128
    blocks (32x48 at small sizes), ~10% ignore, each frame the block
    colours plus noise."""
    rng = np.random.RandomState(seed)
    bh, bw = (64, 128) if h >= 256 else (32, 48)
    grid = rng.randint(0, CLASSES, (b, -(-h // bh), -(-w // bw)))
    labels = np.repeat(np.repeat(grid, bh, axis=1), bw, axis=2)[:, :h, :w].astype(np.int32)
    palette = rng.randint(0, 256, (CLASSES, 3))
    frames = 0.6 * palette[labels] + 0.4 * rng.randint(0, 256, (b, h, w, 3))
    labels[rng.rand(b, h, w) < 0.1] = 255
    return {"image": torch.from_numpy(frames.astype(np.uint8)).to(device),
            "label": torch.from_numpy(labels).to(device)}


def _train_setup(cfg, device):
    model = build_model(cfg.model, device=device, train=True)
    init_model(model, torch.Generator().manual_seed(0))
    sched = poly_lr_schedule(cfg.optimizer.learning_rate, MAX_ITER, cfg.optimizer.poly_power)
    state = TrainState(model, build_generator_tx(cfg.optimizer, model, decay_exempt=EXEMPT), sched)
    return state, make_train_step(cfg, sched)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _kernels_vs_plain_step(state, step, batch) -> None:
    """From one saved state: a step with K1/K2 and a step with their plain
    versions swapped in."""
    saved = (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()), state.step)
    results = []
    for plain in (False, True):
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = saved[2]
        kernels = (klov.lovasz_hist, klov.lovasz_bwd)
        if plain:
            klov.lovasz_hist, klov.lovasz_bwd = klov.lovasz_hist_plain, klov.lovasz_bwd_plain
        try:
            _, m = step(state, batch, torch.Generator(device=DEV).manual_seed(5))
        finally:
            klov.lovasz_hist, klov.lovasz_bwd = kernels
        results.append({k: float(v) for k, v in m.items()})
    kern, plain = results
    print(f"train step, kernels vs plain versions from one state: loss {kern['loss']:.6f} vs "
          f"{plain['loss']:.6f}, loss_lovasz {kern['loss_lovasz']:.6f} vs {plain['loss_lovasz']:.6f}, "
          f"grad_norm {kern['grad_norm']:.6f} vs {plain['grad_norm']:.6f}")
    if _rel(kern["loss"], plain["loss"]) > 1e-4 or _rel(kern["grad_norm"], plain["grad_norm"]) > 1e-2:
        raise AssertionError("the train step with the kernels disagrees with the plain versions")


def _card_vs_cpu_f32_step(cfg) -> None:
    """One f32 step at 2x64x96 on the card and on the CPU, TF32 off; no
    augmentation, whose draws differ between a CUDA and a CPU generator."""
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                      augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"))
    out = []
    for device in (DEV, torch.device("cpu")):
        state, step = _train_setup(cfg, device)
        _, m = step(state, _train_batch(2, 64, 96, 11, device), torch.Generator(device=device))
        out.append({k: float(v) for k, v in m.items()})
    card, cpu = out
    # the losses within 1e-4; the grad norm within 1e-2: the train-form
    # BatchNorm's var = E[x^2] - mean^2 cancels in f32 over as few as 2 values
    # (the ARM gates, n = B) at this size, so the order of its sums moves
    # the gradient by up to a few 1e-3
    tols = {"loss": 1e-4, "loss_ce": 1e-4, "loss_lovasz": 1e-4, "grad_norm": 1e-2}
    errs = {k: _rel(card[k], cpu[k]) for k in tols}
    print("f32 train step, card vs CPU at 2x64x96: " + ", ".join(
        f"{k} {card[k]:.6f} vs {cpu[k]:.6f} (rel {errs[k]:.1e})" for k in errs))
    if any(errs[k] > tol for k, tol in tols.items()):
        raise AssertionError("the f32 train step on the card disagrees with the CPU's")


def phase_train() -> dict:
    cfg = get_preset("bisenet_source_aug")
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, use_lovasz=True))
    h, w = cfg.train_size
    b = cfg.train.batch_size
    _card_vs_cpu_f32_step(cfg)

    state, step = _train_setup(cfg, DEV)
    batch = _train_batch(b, h, w, 21, DEV)
    _kernels_vs_plain_step(state, step, batch)
    state, step = _train_setup(cfg, DEV)  # the 8 steps start from the init
    gen = torch.Generator(device=DEV).manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # the main path: the kernels' launches during the train steps only
    klov.hist_launches = klov.bwd_launches = 0
    metrics = []
    for i in range(TRAIN_STEPS):
        if i == WARMUP_STEPS:
            start.record()
        state, m = step(state, batch, gen)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    launches = {"lovasz_hist": klov.hist_launches, "lovasz_bwd": klov.bwd_launches}
    losses = [float(m["loss"]) for m in metrics]
    ms = start.elapsed_time(end) / (TRAIN_STEPS - WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train {cfg.train_mode} b{b} {h}x{w} bf16: losses " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train: launches {launches} over {TRAIN_STEPS} steps")
    print(f"train: {ms:.3f} ms/step, {b * 1e3 / ms:.1f} img/s (CUDA events over "
          f"{TRAIN_STEPS - WARMUP_STEPS} steps after {WARMUP_STEPS} warm-up), peak device memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses}")
    if launches != {"lovasz_hist": TRAIN_STEPS, "lovasz_bwd": TRAIN_STEPS}:
        raise AssertionError(f"expected one K1 and one K2 launch per step, got {launches}")
    return launches


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    k3_times = phase_kernels()
    lovasz_times = phase_lovasz_kernels()
    k3_launches = phase_slice()
    train_launches = phase_train()
    pkg = "rtda_semanticsegmentation_tpu_torch/csrc"
    ref = "rtda_semanticsegmentation_tpu/ops"
    kernels = [{
        "name": "int8_conv", "route": "cuda", "source": f"{pkg}/int8_conv.cu",
        "replaces": f"{ref}/pallas_conv_int8.py:145", "launches": k3_launches, **k3_times,
    }] + [{
        "name": name, "route": "cuda", "source": f"{pkg}/lovasz.cu",
        "replaces": f"{ref}/pallas_lovasz.py:{line}", "launches": train_launches[name],
        **lovasz_times[name],
    } for name, line in (("lovasz_hist", 124), ("lovasz_bwd", 257))]
    print(f"chip_smoke.py: all phases passed in {time.perf_counter() - t0:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

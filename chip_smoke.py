#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda);
without a device it raises and prints no result. Phases, each raising on
failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``csrc/int8_conv.cu`` for sm_90a into build/kernels/;
3. kernels: the s8 conv kernel against its plain PyTorch version at every
   quantized conv shape of BiSeNet-R18 at 512x1024, batch 8: bf16 outputs
   and requantized s8 codes must be bit-identical; times both;
4. slice: BiSeNet-R18 with seeded random weights, calibrated on 2 batches of
   8 synthetic frames and frozen, serves 4 requests of 8 frames through
   ``make_serving_fn`` in bf16 and int8. Masks must be uint8 (8, 512, 1024)
   below 19, logits finite, each int8 request must launch the kernel exactly
   15 times, and the int8 masks must match those of the same model with the
   kernel swapped for its plain version (>= 0.999 of pixels); the f32 forward
   on the card must match the CPU's on a small input. Prints img/s.

The last two lines are a JSON summary of the kernels and the result line.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from rtda_semanticsegmentation_tpu_torch.config import AugmentConfig, ModelConfig
from rtda_semanticsegmentation_tpu_torch.kernels import build as kbuild
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate, freeze
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.serving import make_serving_fn

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
    k3._library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kbuild.nvcc_path()})")
    for source, info in kbuild.build_log.items():
        print(f"build log {source} ({info['seconds']:.2f} s):\n{info['log']}")


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
    total_ms = total_plain_ms = 0.0
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
        tops = 2.0 * BATCH * ho * wo * cout * k * k * cin / (ms * 1e-3) / 1e12
        print(f"kernel {where} {cin}->{cout} @{h}x{w} b{BATCH}: bit-identical (bf16 and s8); "
              f"kernel {ms:.4f} ms ({tops:.1f} TOP/s), plain {plain_ms:.4f} ms, x{count} per forward")
        total_ms += count * ms
        total_plain_ms += count * plain_ms
    print(f"kernel total over one forward's {QUANT_CONVS} quantized convs: "
          f"{total_ms:.4f} ms kernel, {total_plain_ms:.4f} ms plain")
    return {"ms": total_ms, "plain_ms": total_plain_ms, "max_abs_err": max_err}


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
    variables = init_model(build_model(cfg), torch.Generator().manual_seed(0))
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


def main() -> None:
    phase_device()
    phase_build()
    times = phase_kernels()
    launches = phase_slice()
    print(json.dumps({"kernels": [{
        "name": "int8_conv",
        "route": "cuda",
        "source": "rtda_semanticsegmentation_tpu_torch/csrc/int8_conv.cu",
        "replaces": "rtda_semanticsegmentation_tpu/ops/pallas_conv_int8.py:145",
        "launches": launches,
        **times,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

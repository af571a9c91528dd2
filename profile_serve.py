#!/usr/bin/env python3
"""Where the serving time of the PyTorch port goes on one CUDA GPU.

    python3 profile_serve.py

Builds the model of ``chip_smoke.py`` (BiSeNet-R18, 512x1024, batch 8,
seeded random weights), calibrates it on 2 synthetic batches and freezes
it. Then, for bf16, int8, int8 and bf16 (the repeats show the spread), it
prints:

- ms/request by CUDA events, 10 requests after 3 of warm-up, with no
  profiler attached;
- the device kernel time per request from ``torch.profiler`` over 5
  requests, split into kernel groups, and the kernels launched per request;
- the device idle share, ``1 - kernel ms / request ms``.

Last it times the activation quantizer alone at the inputs of the 15
quantized convs. The last line is a JSON summary of all of it.
"""

from __future__ import annotations

import json

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from rtda_semanticsegmentation_tpu_torch.config import AugmentConfig, ModelConfig
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate, freeze
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.ops.quant import quantize_act_unsigned
from rtda_semanticsegmentation_tpu_torch.serving import make_serving_fn

PROFILED = 5


def _group(name: str) -> str:
    if "int8_conv_kernel" in name:
        return "s8 conv kernel"
    if any(t in name for t in ("cudnn", "cutlass", "xmma", "sm90", "conv")):
        return "cuDNN conv"
    if "upsample" in name:
        return "bilinear upsample"
    if "reduce" in name:
        return "reductions"
    return "elementwise / copies"


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profile_precision(serve, x) -> dict:
    ms = cs.cuda_ms(lambda: serve(x), 10, 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            serve(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
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
        "kernels_per_request": sum(e.count for e in kernels) / PROFILED,
        "groups": groups,
        "top": [(e.key[:100], _device_us(e) / 1e3 / PROFILED, e.count / PROFILED)
                for e in sorted(kernels, key=_device_us, reverse=True)[:8]],
    }


def quantizer_ms() -> float:
    """The activation quantizer over one forward's 15 conv inputs (bf16 NHWC)."""
    total = 0.0
    for (_, cin, _, h, w, _, _, _, count) in cs.SHAPES:
        xa = torch.rand(cs.BATCH, h, w, cin, device=cs.DEV).to(torch.bfloat16)
        absmax = torch.ones(cin, device=cs.DEV)
        total += count * cs.cuda_ms(lambda: quantize_act_unsigned(xa, absmax), 10)
    return total


def main() -> None:
    smi = cs.phase_device()
    aug, cfg = AugmentConfig(), ModelConfig(compute_dtype="bfloat16")
    variables = init_model(build_model(cfg), torch.Generator().manual_seed(0))
    variables = {k: v.to(cs.DEV) for k, v in variables.items()}
    calib = [normalize_u8(cs._frames(s), aug) for s in (1, 2)]
    variables = freeze(cfg, calibrate(cfg, variables, calib, device=cs.DEV))
    x = cs._frames(100)
    runs = []
    for precision in ("bf16", "int8", "int8", "bf16"):
        r = profile_precision(make_serving_fn(cfg, aug, variables, precision, device=cs.DEV), x)
        runs.append({"precision": precision, **r})
        print(f"== {precision}: {r['ms']:.3f} ms/request (CUDA events, no profiler); "
              f"kernel time {r['kernel_ms']:.3f} ms/request, "
              f"{r['kernels_per_request']:.1f} kernels/request, idle share {r['idle_share']:.3f}")
        for g, t in sorted(r["groups"].items(), key=lambda kv: -kv[1]):
            print(f"  {t:8.3f} ms  {g}")
        for name, t, n in r["top"]:
            print(f"  {t:8.3f} ms x{n:5.1f}  {name}")
    q_ms = quantizer_ms()
    print(f"activation quantizer over one forward's 15 conv inputs: {q_ms:.3f} ms")
    print(json.dumps({"card": smi, "runs": runs, "quantizer_ms": q_ms}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the serving time of the PyTorch port goes on one CUDA GPU.

    python3 profile_serve.py [--model r18|r101|deeplabv2] [--fused_conv3]
                             [--artifact [--precision bf16|int8]]

Builds one model of ``chip_smoke.py`` at 512x1024, batch 8, seeded random
weights: BiSeNet-R18 (``r18``, the default), BiSeNet-R101 (``r101``) or
DeepLabV2 (``deeplabv2``). Without ``--fused_conv3`` it profiles bf16,
int8, int8 and bf16 (the model is calibrated on 2 synthetic batches and
frozen first); with ``--fused_conv3``
it profiles bf16 with the 3x3 ConvBNs on cuDNN and on K4 in turns (cuDNN,
K4, K4, cuDNN); with ``--artifact`` it profiles ``--precision`` (with
``--fused_conv3``: bf16 on K4) through ``make_serving_fn`` and through the
artifact ``serving.export_serving`` makes of it on the card (symbolic
batch, saved and loaded) in turns (eager, artifact, artifact, eager). The
repeats show the spread. For each run it prints:

- ms/request by CUDA events, 10 requests after 3 of warm-up, with no
  profiler attached;
- the device kernel time per request from ``torch.profiler`` over 5
  requests, split into kernel groups, and the kernels launched per request;
- the device idle share, ``1 - kernel ms / request ms``.

For R18 without ``--fused_conv3`` it last times the activation quantizer
alone at the inputs of the 15 quantized convs. The last line is a JSON
summary of all of it.
"""

from __future__ import annotations

import argparse
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


MODELS = {"r18": {}, "r101": {"context_path": "resnet101"}, "deeplabv2": {"name": "deeplabv2"}}


def _group(name: str) -> str:
    if "int8_conv_kernel" in name:
        return "s8 conv kernel"
    if "conv3x3_kernel" in name:
        return "K4 3x3 conv kernel"
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
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=tuple(MODELS), default="r18")
    parser.add_argument("--fused_conv3", action="store_true",
                        help="profile bf16 with the 3x3 ConvBNs on cuDNN and on K4, in turns")
    parser.add_argument("--artifact", action="store_true",
                        help="profile --precision eagerly and through its exported artifact, in turns")
    parser.add_argument("--precision", choices=("bf16", "int8"), default="bf16")
    args = parser.parse_args()
    if args.artifact and args.fused_conv3 and args.precision != "bf16":
        parser.error("--fused_conv3 serves bf16 only")
    smi = cs.phase_device()
    aug, cfg = AugmentConfig(), ModelConfig(compute_dtype="bfloat16", **MODELS[args.model])
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    variables = {k: v.to(cs.DEV) for k, v in variables.items()}
    quantizer = args.model == "r18" and not args.fused_conv3 and not args.artifact
    if args.artifact:
        p, f = args.precision, args.fused_conv3
        plan = ((p, f, False), (p, f, True), (p, f, True), (p, f, False))
    elif args.fused_conv3:
        plan = (("bf16", False, False), ("bf16", True, False), ("bf16", True, False), ("bf16", False, False))
    else:
        plan = (("bf16", False, False), ("int8", False, False), ("int8", False, False), ("bf16", False, False))
    if any(precision == "int8" for precision, _, _ in plan):
        calib = [normalize_u8(cs._frames(s), aug) for s in (1, 2)]
        variables = freeze(cfg, calibrate(cfg, variables, calib, device=cs.DEV))
    x = cs._frames(100)
    serves = {}
    for precision, fused, artifact in set(plan):
        if artifact:
            serves[precision, fused, artifact] = cs._artifact(cfg, variables, precision, fused, cs.DEV)[0]
        else:
            serves[precision, fused, artifact] = make_serving_fn(cfg, aug, variables, precision, device=cs.DEV,
                                                                 fused_conv3=fused)
    runs = []
    for precision, fused, artifact in plan:
        r = profile_precision(serves[precision, fused, artifact], x)
        label = f"{precision}{' K4' if fused else ''}{' artifact' if artifact else ''}"
        runs.append({"model": args.model, "precision": precision, "fused_conv3": fused, "artifact": artifact, **r})
        print(f"== {args.model} {label}: {r['ms']:.3f} ms/request (CUDA events, no profiler); "
              f"kernel time {r['kernel_ms']:.3f} ms/request, "
              f"{r['kernels_per_request']:.1f} kernels/request, idle share {r['idle_share']:.3f}")
        for g, t in sorted(r["groups"].items(), key=lambda kv: -kv[1]):
            print(f"  {t:8.3f} ms  {g}")
        for name, t, n in r["top"]:
            print(f"  {t:8.3f} ms x{n:5.1f}  {name}")
    summary = {"card": smi, "runs": runs}
    if quantizer:
        summary["quantizer_ms"] = q_ms = quantizer_ms()
        print(f"activation quantizer over one forward's 15 conv inputs: {q_ms:.3f} ms")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

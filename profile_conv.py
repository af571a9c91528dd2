#!/usr/bin/env python3
"""Device and host time of the hand-written convs K4, K3 and K5a-c on one CUDA GPU.

    python3 profile_conv.py [--root DIR] [--only k5]

Times K4 (``kernels/conv3x3.py::conv3x3``) at the 10 shapes of
``chip_smoke.CONV3_SHAPES``, K3 (``kernels/int8_conv.py::int8_conv``) at
the 9 of ``chip_smoke.SHAPES`` and the discriminator's first conv
(``kernels/conv4x4.py``: K5a forward, K5b weight gradient, K5c input
gradient) on the flagship's softmax maps (source 720x1280, target
512x1024), b8, on ``chip_smoke.py``'s seeded operands, each three ways:

- ``graph``: device ms per launch, 20 launches replayed from a CUDA graph
  (no host cost between them);
- ``stream``: ms per launch, 20 launches issued back to back (a launch whose
  host cost exceeds its device time is timed at its host cost);
- ``host``: host microseconds per launch.

It then sums each over one forward of BiSeNet-R18, BiSeNet-R101 and
DeepLabV2 (K4), over one int8 forward of BiSeNet-R18 (K3) and over one
flagship step (K5a once on the source map and twice on the target, K5b
once on each, K5c once on the target). ``--only k5`` times K5 alone. ``--root``
imports the port's package from another checkout (for example a parent
commit unpacked with ``git archive`` under ``build/``), whose kernels build
there, so two versions are timed by the same code, one process each; the
shapes and operands are always this checkout's. K3 gets the K-major weights
made once where its wrapper takes them (``kmajor``). The last line is a JSON
summary.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _load(root: Path):
    """This checkout's chip_smoke (shapes, operands, timers), importing the
    port's package from ``root``."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _three_ways(cs, fn) -> dict:
    return {"graph": cs.graph_ms(fn), "stream": cs.cuda_ms(fn, 20), "host_us": cs.host_us(fn)}


def profile_k4(cs) -> dict:
    k4 = cs.k4
    per_model = {m: {"graph": 0.0, "stream": 0.0} for m in cs.K4_CONVS}
    shapes = {}
    for i, (where, c, co, h, w, d, counts) in enumerate(cs.CONV3_SHAPES):
        x, wt, scale, shift = cs._conv3_case(i, c, co, h, w)
        t = _three_ways(cs, lambda: k4.conv3x3(x, wt, scale, shift, relu=True, dilation=d))
        shapes[where] = t
        print(f"K4 {where} {c}->{co} @{h}x{w} d{d}: graph {t['graph']:.4f} ms, stream {t['stream']:.4f} ms, "
              f"host {t['host_us']:.1f} us per launch")
        for model, n in counts.items():
            for key in ("graph", "stream"):
                per_model[model][key] += n * t[key]
        del x, wt
    for model, t in per_model.items():
        print(f"K4 per {model} forward ({cs.K4_CONVS[model]} convs): graph {t['graph']:.4f} ms, "
              f"stream {t['stream']:.4f} ms")
    return {"shapes": shapes, "per_forward": per_model}


def profile_k3(cs) -> dict:
    k3 = cs.k3
    takes_kmajor = "kmajor" in inspect.signature(k3.int8_conv).parameters
    total = {"graph": 0.0, "stream": 0.0}
    shapes = {}
    for i, (where, cin, cout, h, w, k, s, p, count) in enumerate(cs.SHAPES):
        xq, wq, a, b, _ = cs._conv_case(i, cin, cout, h, w, k)
        kw = dict(stride=s, padding=p, relu=False, out_dtype=torch.bfloat16)
        if takes_kmajor:
            kw["kmajor"] = k3.kmajor_weights(wq)
        t = _three_ways(cs, lambda: k3.int8_conv(xq, wq, a, b, **kw))
        shapes[where] = t
        print(f"K3 {where} {cin}->{cout} @{h}x{w}: graph {t['graph']:.4f} ms, stream {t['stream']:.4f} ms, "
              f"host {t['host_us']:.1f} us per launch, x{count} per forward")
        for key in total:
            total[key] += count * t[key]
    print(f"K3 per int8 forward ({cs.QUANT_CONVS} convs): graph {total['graph']:.4f} ms, "
          f"stream {total['stream']:.4f} ms")
    return {"shapes": shapes, "per_forward": total}


def profile_k5(cs) -> dict:
    kc = cs.kc
    g = torch.Generator(device=cs.DEV).manual_seed(3)
    w = torch.randn((cs.NDF, cs.CLASSES, 4, 4), generator=g, device=cs.DEV) * 0.02
    per_step = {"conv4x4s2p1": (1, 2), "conv4x4s2p1_dw": (1, 1), "conv4x4s2p1_dx": (0, 1)}
    total = {name: {"graph": 0.0, "stream": 0.0} for name in per_step}
    shapes = {}
    for where, hw, seed in (("source", cs.SOURCE_HW, 10), ("target", cs.TARGET_HW, 11)):
        x = cs._softmax_map(hw, seed)
        ho, wo = hw[0] // 2, hw[1] // 2
        dy = (torch.randn((cs.BATCH, cs.NDF, ho, wo), generator=g, device=cs.DEV) * 1e-3).to(torch.bfloat16)
        fns = {"conv4x4s2p1": lambda: kc.conv4x4s2p1(x, w), "conv4x4s2p1_dw": lambda: kc.conv4x4s2p1_dw(x, dy),
               "conv4x4s2p1_dx": lambda: kc.conv4x4s2p1_dx(dy, w)}
        for name, fn in fns.items():
            count = per_step[name][where == "target"]
            if not count:
                continue
            t = _three_ways(cs, fn)
            shapes[f"{name} {where}"] = t
            print(f"K5 {name} {where} {tuple(x.shape)}: graph {t['graph']:.4f} ms, stream {t['stream']:.4f} ms, "
                  f"host {t['host_us']:.1f} us per launch, x{count} per step")
            for key in ("graph", "stream"):
                total[name][key] += count * t[key]
        del x, dy
    for name, t in total.items():
        print(f"K5 {name} per flagship step: graph {t['graph']:.4f} ms, stream {t['stream']:.4f} ms")
    return {"shapes": shapes, "per_step": total}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="checkout whose package is timed")
    ap.add_argument("--only", choices=("k5",), help="time only the K5 kernels")
    args = ap.parse_args()
    cs = _load(args.root.resolve())
    smi = cs.phase_device()
    result = {"root": str(args.root), "device": smi}
    if args.only is None:
        cs.k4._library()
        cs.k3._library()
        result.update(k4=profile_k4(cs), k3=profile_k3(cs))
    cs.kc._library()
    result["k5"] = profile_k5(cs)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

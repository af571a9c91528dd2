#!/usr/bin/env python3
"""Device and host time of the hand-written convs K4 and K3 on one CUDA GPU.

    python3 profile_conv.py [--root DIR]

Times K4 (``kernels/conv3x3.py::conv3x3``) at the 10 shapes of
``chip_smoke.CONV3_SHAPES`` and K3 (``kernels/int8_conv.py::int8_conv``) at
the 9 of ``chip_smoke.SHAPES``, b8, on ``chip_smoke.py``'s seeded operands,
each three ways:

- ``graph``: device ms per launch, 20 launches replayed from a CUDA graph
  (no host cost between them);
- ``stream``: ms per launch, 20 launches issued back to back (a launch whose
  host cost exceeds its device time is timed at its host cost);
- ``host``: host microseconds per launch.

It then sums each over one forward of BiSeNet-R18, BiSeNet-R101 and
DeepLabV2 (K4) and over one int8 forward of BiSeNet-R18 (K3). ``--root``
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="checkout whose package is timed")
    args = ap.parse_args()
    cs = _load(args.root.resolve())
    smi = cs.phase_device()
    cs.k4._library()
    cs.k3._library()
    result = {"root": str(args.root), "device": smi, "k4": profile_k4(cs), "k3": profile_k3(cs)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()

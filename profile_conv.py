#!/usr/bin/env python3
"""Device and host time of the hand-written kernels K4, K3, K5a-c, K1 and K2 on one CUDA GPU.

    python3 profile_conv.py [--root DIR] [--only k5|lovasz]

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
once on each, K5c once on the target). ``--only k5`` times K5 alone.
``--only lovasz`` times the Lovász histogram (K1) and backward (K2) alone
(``kernels/lovasz.py``), the same three ways, at the source-only step's
shape (8, 19, 512*1024) on the three distributions of
``chip_smoke.LOVASZ_DISTRIBUTIONS`` at 256 bins, at 1024 and 2048 bins,
and at the flagship's source map (8, 19, 720*1280), and splits K1's
device time over its kernels by ``torch.profiler``. ``--only k1-variants``
prints the census of K1's atomics in its SASS (``cuobjdump``) and, where
the checkout's ``csrc/lovasz.cu`` has K1's current layout, times K1 on the
three distributions beside two variants built from that source: without
its background binning (the class-row loads and the foreground runs only) and without its end-of-block global atomics
(timing only; both give wrong histograms). ``--root``
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
import re
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


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def _kernel_split(fn, n: int = 10) -> dict:
    """Device ms per call of each CUDA kernel (and memset or copy) that
    ``fn`` runs, by torch.profiler over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: _device_us(e) / 1e3 / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0}


def profile_lovasz(cs) -> dict:
    klov = cs.klov
    out = {}

    def run(tag, probas, labels, bins, bwd=False):
        fn = lambda: klov.lovasz_hist(probas, labels, bins, 255)  # noqa: E731
        t = _three_ways(cs, fn)
        print(f"K1 {tag} bins {bins}: graph {t['graph']:.4f} ms, stream {t['stream']:.4f} ms, "
              f"host {t['host_us']:.1f} us per launch")
        out[f"lovasz_hist {tag} {bins}"] = t
        if bwd:
            table = torch.rand((cs.CLASSES, 2, bins), device=cs.DEV) * 1e-3
            t = _three_ways(cs, lambda: klov.lovasz_bwd(probas, labels, table, bins, 255, True))
            print(f"K2 {tag} bins {bins}: graph {t['graph']:.4f} ms, stream {t['stream']:.4f} ms, "
                  f"host {t['host_us']:.1f} us per launch")
            out[f"lovasz_bwd {tag} {bins}"] = t

    for kind in cs.LOVASZ_DISTRIBUTIONS:
        probas, labels = cs._lovasz_case(kind)
        run(f"{kind} {tuple(probas.shape)}", probas, labels, cs.BINS, bwd=kind == "spread")
        if kind == "spread":
            split = _kernel_split(lambda: klov.lovasz_hist(probas, labels, cs.BINS, 255))
            for name, ms in split.items():
                print(f"K1 spread bins {cs.BINS} split (torch.profiler): {ms:.4f} ms {name}")
            out["lovasz_hist split"] = split
            for bins in (1024, 2048):
                run(f"{kind} {tuple(probas.shape)}", probas, labels, bins)
        del probas, labels
    probas, labels = cs._lovasz_case("spread", cs.SOURCE_HW[0] * cs.SOURCE_HW[1])
    run(f"flagship source {tuple(probas.shape)}", probas, labels, cs.BINS, bwd=True)
    return out


# markers of csrc/lovasz.cu that the K1 variants cut at
_BINNING = ("      // the background elements of the V pixels", "    // the foreground elements:")


def _k1_variant_sources(src: str) -> dict:
    """K1's source without its background binning, and without its global
    atomics; {} where the source has another layout (an older checkout)."""
    if not all(m in src for m in _BINNING + ("  int fg_slot = -1;", "    if (cf) {")):
        return {}
    a, b = src.index(_BINNING[0]), src.index(_BINNING[1])
    keep = ("#pragma unroll\n      for (int j = 0; j < V; ++j) {\n"
            "        sink += Vec<V>::at(p, j);\n        if (lab[j] == c0 + c) p_fg[j] = Vec<V>::at(p, j);\n      }\n    }\n")
    loads = src[:a] + keep + src[b:]
    loads = loads.replace("  int fg_slot = -1;", "  float sink = 0.0f;  // keeps the loads\n  int fg_slot = -1;", 1)
    loads = loads.replace("  const int total = C * bins;", "  if (sink == -1.0f) s_cf[0] = 1u;\n  const int total = C * bins;", 1)
    return {"loads only": loads, "no global atomics": src.replace("    if (cf) {", "    if (cf && bins < 0) {", 1)}


def profile_k1_variants(cs) -> dict:
    import ctypes
    import subprocess

    build = cs.kbuild

    klov = cs.klov
    shipped = klov._library()
    lib_path = max(build.BUILD_DIR.glob("lovasz-*.so"), key=lambda q: q.stat().st_mtime)
    sass = subprocess.run([str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    census = {}
    for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+|MATCH\.[A-Z]+|ATOMG\.[A-Z0-9.]+|REDG?\.[A-Z0-9.]+)", sass):
        census[op] = census.get(op, 0) + 1
    print(f"K1 SASS census of {lib_path.name}: {census}")
    out = {"sass": census, "graph": {}}
    cases = {kind: cs._lovasz_case(kind) for kind in cs.LOVASZ_DISTRIBUTIONS}
    libs = {"shipped": shipped}
    src = (build.PACKAGE_DIR / klov.SOURCE).read_text()
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for name, text in _k1_variant_sources(src).items():
        cu = vdir / f"lovasz-{name.replace(' ', '-')}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, check=True)
        lib = ctypes.CDLL(str(so))
        lib.lovasz_hist_launch.argtypes = shipped.lovasz_hist_launch.argtypes
        lib.lovasz_hist_launch.restype = ctypes.c_int
        libs[name] = lib
    try:
        for name, lib in libs.items():
            klov._lib = lib
            for kind, (probas, labels) in cases.items():
                t = cs.graph_ms(lambda: klov.lovasz_hist(probas, labels, cs.BINS, 255))
                out["graph"][f"{name} {kind}"] = t
                print(f"K1 {name} {kind} bins {cs.BINS}: graph {t:.4f} ms")
    finally:
        klov._lib = shipped
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="checkout whose package is timed")
    ap.add_argument("--only", choices=("k5", "lovasz", "k1-variants"),
                    help="time only the K5 kernels, the Lovász kernels or K1 beside its variants")
    args = ap.parse_args()
    cs = _load(args.root.resolve())
    smi = cs.phase_device()
    result = {"root": str(args.root), "device": smi}
    if args.only is None:
        cs.k4._library()
        cs.k3._library()
        result.update(k4=profile_k4(cs), k3=profile_k3(cs))
    if args.only in (None, "lovasz"):
        cs.klov._library()
        result["lovasz"] = profile_lovasz(cs)
    if args.only == "k1-variants":
        result["k1_variants"] = profile_k1_variants(cs)
    if args.only in (None, "k5"):
        cs.kc._library()
        result["k5"] = profile_k5(cs)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

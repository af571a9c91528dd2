"""What ``h100_bench/`` adds for ``segb5-train``: the attention's FLOPs
(``costs/attention.py``) against counts by hand, the step's FLOPs pinned,
and the new readers (``attn_ms.train``, ``attn_roofline``,
``dwconv_ms.train``, ``encoder_fwd_ms.train``, ``head_fwd_ms.train``) on
made-up traces and span records, and on a whole traced run on the CPU. No
card and no JAX."""

import json
import os
import subprocess
import sys

import pytest

from h100_bench.costs import attention
from h100_bench.costs.flops import serve_flops, train_step_flops
from h100_bench.costs.peaks import BF16_FLOPS
from h100_bench.lib import spans, spec
from h100_bench.lib.outcome import Outcome
from h100_bench.lib.trace import Trace

TINY = {"mit_embed_dims": [8, 16, 40, 64], "mit_depths": [1, 1, 2, 1], "mit_num_heads": [1, 2, 5, 8],
        "mit_sr_ratios": [8, 4, 2, 1], "mit_mlp_ratio": 4, "decoder_dim": 32}
NEW = ("attn_ms.train", "attn_roofline", "dwconv_ms.train", "encoder_fwd_ms.train", "head_fwd_ms.train")


def _cell():
    return spec.resolve(spec.benchmark(), "segb5-train")


def test_attention_flops_by_hand_tiny():
    """b2 64x128: grids 16x32, 8x16, 4x8, 2x4; keys 2x4 (r 8), 2x4 (r 4),
    2x4 (r 2), 2x4 (r 1); heads of 8."""
    assert attention.stages(TINY, (64, 128)) == [(1, 1, 8, 512, 8), (1, 2, 8, 128, 8), (2, 5, 8, 32, 8),
                                                 (1, 8, 8, 8, 8)]
    by_hand = 4 * 2 * 8 * (1 * 1 * 512 * 8 + 1 * 2 * 128 * 8 + 2 * 5 * 32 * 8 + 1 * 8 * 8 * 8)
    assert attention.forward_flops(TINY, 2, (64, 128)) == by_hand == 589_824


def test_attention_flops_by_hand_b5():
    """MiT-B5 at b8 512x1024: 32768, 8192, 2048 and 512 queries, 512 keys
    in every stage, widths 64/128/320/512 over 3/6/40/3 blocks."""
    model = _cell().config["model"]
    by_hand = 4 * 8 * 512 * (3 * 64 * 32768 + 6 * 128 * 8192 + 40 * 320 * 2048 + 3 * 512 * 512)
    assert attention.forward_flops(model, 8, (512, 1024)) == by_hand == 648_540_061_696
    assert attention.train_step_flops(_cell().config, _cell().traffic) == 3 * 648_540_061_696


def test_step_flops_pinned():
    """The step and the forward as ``FlopCounterMode`` counts them on the
    reference (convs and matrix products; the written-out depthwise taps
    count none): 11.45 TFLOP a b8 step, 0.477 TFLOP a frame forward."""
    c = _cell()
    assert train_step_flops(c.config, c.traffic) == 11_446_222_061_568
    assert serve_flops(c.config, {"batch": 8, "size": [512, 1024]}) == 3_817_051_521_024


FLASH = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 64, 4, false, false, "
         "cutlass::bfloat16_t>, false, false, false, false, false, true, false, false>(Flash_fwd_params)")
FLASH_BWD = "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<Flash_bwd_kernel_traits<64>>"
DW = "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<3, c10::BFloat16, int>"
DW_CUDNN = ("conv2d_c1_k1_nhwc_specialized", "dgrad2d_c1_k1_nhwc_specialized", "wgrad2d_c1_k1_nhwc",
            "wgrad2d_c1_k1_nhwc_reduce")


def _run(device, config=None, traffic=None, kind="train", units=2):
    c = _cell()
    trace = None if device is None else Trace((0.0, 1e4), device, [("cudaLaunchKernel", 0.0, 5.0)], units)
    return Outcome(kind=kind, end_to_end={}, attempted=units, failed=0, numbers={}, limits={}, units=units,
                   window_s=1.0, batch=8, setup_s=1.0, trace=trace, config=config or c.config,
                   traffic=traffic or c.traffic)


def _read(name, run):
    return spec.read_metric(name, run)


def test_kernel_readers_on_a_made_up_trace():
    device = [(FLASH, 0.0, 1000.0), (FLASH_BWD, 1000.0, 3000.0), ("void cudnn::conv_kernel", 3000.0, 3500.0),
              (DW, 3500.0, 3900.0), ("elementwise_kernel", 3900.0, 4000.0)]
    device += [(n, 4000.0 + 100 * i, 4050.0 + 100 * i) for i, n in enumerate(DW_CUDNN)]
    run = _run(device)
    assert _read("attn_ms.train", run) == pytest.approx(1.5)  # 3000 us over 2 steps
    assert _read("dwconv_ms.train", run) == pytest.approx(0.3)  # 400 + 4 x 50 us over 2 steps
    want = 100.0 * 3 * 648_540_061_696 / BF16_FLOPS / 1.5e-3
    assert _read("attn_roofline", run) == pytest.approx(want)


@pytest.mark.parametrize("name", ["attn_ms.train", "attn_roofline", "dwconv_ms.train"])
def test_kernel_readers_find_nothing(name):
    """No trace, no such kernel, a serve run, or (the roofline) a
    configuration without MiT: None, not an error."""
    other = [("void cudnn::conv_kernel", 0.0, 10.0)]
    assert _read(name, _run(None)) is None
    assert _read(name, _run(other)) is None
    assert _read(name, _run([(FLASH, 0.0, 10.0), (DW, 10.0, 20.0)], kind="serve")) is None
    if name == "attn_roofline":
        dlv2 = spec.resolve(spec.benchmark(), "dlv2-train")
        assert _read(name, _run([(FLASH, 0.0, 10.0)], dlv2.config, dlv2.traffic)) is None


# device ms a step of the attention's kernels (flash, forward and backward),
# read in segb5-train's traced runs on an NVIDIA H100 80GB HBM3 at 700 W
RECORDED_ATTN_MS = (15.706, 15.921)


@pytest.mark.parametrize("ms", (*RECORDED_ATTN_MS, 1e3 * 3 * 648_540_061_696 / BF16_FLOPS))
def test_attn_roofline_never_above_100(ms):
    """At the recorded kernel times, and at the least time the peak allows
    (where it reads exactly 100)."""
    run = _run([(FLASH, 0.0, 2e3 * ms)])
    share = _read("attn_roofline", run)
    assert 0 < share <= 100 + 1e-9
    if ms < min(RECORDED_ATTN_MS):
        assert share == pytest.approx(100.0)


def _rec(name, parent, t0_us, t1_us, device_ms, unit):
    return {"name": name, "parent": parent, "unit": unit, "t0_ns": int(t0_us * 1e3), "t1_ns": int(t1_us * 1e3),
            "host_ms": (t1_us - t0_us) * 1e-3, "device_ms": device_ms, "events": True, "profiled": True,
            "first": False, "setup": False}


def _steps(with_model_spans=True):
    recs = []
    for k in range(2):
        at = k * 1000.0
        root = len(recs)
        recs.append(_rec("train.step", None, at, at + 900, 0.9, k + 1))
        fwd = len(recs)
        recs.append(_rec("train.g_forward", root, at + 10, at + 400, 0.4, k + 1))
        if with_model_spans:
            recs.append(_rec("segformer.encoder", fwd, at + 20, at + 300, 0.3 + 0.1 * k, k + 1))
            recs.append(_rec("segformer.head", fwd, at + 300, at + 390, 0.08, k + 1))
        recs.append(_rec("train.g_backward", root, at + 400, at + 890, 0.45, k + 1))
    return recs


@pytest.mark.parametrize("name,want", [("encoder_fwd_ms.train", 0.35), ("head_fwd_ms.train", 0.08)])
def test_span_readers_on_made_up_records(monkeypatch, name, want):
    run = _run([("k", 0.0, 10.0)])
    monkeypatch.setattr(spans, "records", lambda: _steps())
    spans._said.clear()
    assert _read(name, run) == pytest.approx(want)
    monkeypatch.setattr(spans, "records", lambda: _steps(False))
    spans._said.clear()
    assert _read(name, _run([("k", 0.0, 10.0)])) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    spans._said.clear()
    assert _read(name, _run([("k", 0.0, 10.0)])) is None


RUN = """
import json, sys
from h100_bench.harness import main
sys.exit(main(["--workload", "segb5-train", "--seed", "2147483747", "--seconds", "0.3", "--trace", "1"],
              require_card=False, device="cpu", overrides=json.loads(sys.argv[1])))
"""


def test_traced_cpu_run_of_the_cell():
    """A whole ``--trace 1`` run of ``segb5-train`` on the CPU at the tiny
    MiT, in a process of its own (the harness refuses one that holds JAX):
    ``correct``, 5 attention calls a step, the two span metrics read and
    the kernel readers (no device trace on the CPU) leave theirs out."""
    cfg = _cell().config
    over = {"config": {"model": {**cfg["model"], **TINY, "compute_dtype": "float32"},
                       "augment": {**cfg["augment"], "aug_dtype": "float32"}},
            "traffic": {"batch": 2, "source": [64, 128], "first_steps": 2},
            "settings": {"trace_units": 2, "trace_warmup": 1}}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(over)], capture_output=True, text=True,
                          cwd=spec.ROOT, env={**env, "PYTHONPATH": str(spec.ROOT)}, timeout=300)
    out, err = proc.stdout, proc.stderr
    assert proc.returncode == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"], err[-2000:]
    assert {"encoder_fwd_ms.train", "head_fwd_ms.train"} <= set(result["metrics"])
    assert not {"attn_ms.train", "attn_roofline", "dwconv_ms.train"} & set(result["metrics"])
    assert "counter attention.calls" in out + err and "(5.000 a step)" in out + err


def test_new_metrics_are_the_cells_alone():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == ["segb5-train"] and m["moves"] == "train_img_s", m["name"]
    assert {m["name"] for m in _cell().per_layer} >= set(NEW)
    for other in ("r18-adv-train", "dlv2-train", "r18-serve-b8"):
        assert not {m["name"] for m in spec.resolve(bench, other).per_layer} & set(NEW)


# the LayerNorm's kernels as the profiler names them: PyTorch's (the parent's
# F.layer_norm) and the port's (csrc/layernorm.cu)
LN_TORCH = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float, false>(int)",
            "void at::native::(anonymous namespace)::layer_norm_grad_input_kernel_vectorized<c10::BFloat16, float>",
            "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernelTemplate<c10::BFloat16, float, 32u>",
            "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<c10::BFloat16, float>(long, float)")
LN_PORT = tuple(f"void (anonymous namespace)::{k}<__nv_bfloat16, 8, 5>((anonymous namespace)::LnArgs)"
                for k in ("layernorm_forward", "layernorm_backward")) + (
    "(anonymous namespace)::layernorm_finish((anonymous namespace)::LnArgs)",)


@pytest.mark.parametrize("names", [LN_TORCH, LN_PORT], ids=["pytorch", "port"])
def test_layernorm_reader_reads_either_programs_kernels(names):
    """``layernorm_ms.train`` sums the LayerNorm's kernels a step, PyTorch's
    or the port's, and nothing else; None without a trace, without such a
    kernel, or in a serve run."""
    device = [(n, 100.0 * i, 100.0 * i + 40.0) for i, n in enumerate(names)]
    device += [(FLASH, 1000.0, 1500.0), ("void cudnn::conv_kernel", 1500.0, 1600.0), (DW, 1600.0, 1700.0),
               ("elementwise_kernel", 1700.0, 1800.0)]
    assert _read("layernorm_ms.train", _run(device)) == pytest.approx(len(names) * 40e-3 / 2)
    assert _read("layernorm_ms.train", _run(None)) is None
    assert _read("layernorm_ms.train", _run(device[len(names):])) is None
    assert _read("layernorm_ms.train", _run(device, kind="serve")) is None


def test_port_layernorm_kernels_are_named_for_the_reader_alone():
    """Every kernel of ``csrc/layernorm.cu`` carries ``layernorm`` in its
    name and no word that a kernel group of ``lib/trace.py`` claims, so it
    falls in no other layer's group; the metric is ``segb5-train``'s
    alone, in the SegFormer model layer, moving ``train_img_s``."""
    import re

    from h100_bench.lib import trace

    src = (spec.ROOT / "rtda_semanticsegmentation_tpu_torch" / "csrc" / "layernorm.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\)\)?)?\s+(\w+)\(", src)
    assert sorted(kernels) == ["layernorm_backward", "layernorm_finish", "layernorm_forward"]
    for name in kernels + list(LN_PORT):
        assert "layernorm" in name and trace.group(name) == "elementwise", name
    bench = spec.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == "layernorm_ms.train")
    assert entry["workloads"] == ["segb5-train"] and entry["moves"] == "train_img_s" and entry["layer"] == "model"
    for other in ("r18-adv-train", "dlv2-train", "r18-serve-b8"):
        assert "layernorm_ms.train" not in {m["name"] for m in spec.resolve(bench, other).per_layer}

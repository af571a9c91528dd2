"""What each process loads: no JAX and no JAX package after a run of each
driver; nothing of the port, ``chip_smoke.py`` or ``profile_*.py`` in the
reference and the cost arithmetic. Module names are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

import json
import os
import subprocess
import sys

import pytest

from h100_bench.lib import spec

TINY = {
    "r18-adv-train": {"traffic": {"batch": 2, "source": [64, 96], "target": [64, 96]}},
    "r18-serve-b8": {"traffic": {"batch": 2, "size": [64, 96], "warmup_rounds": 1}},
}
RUN = """
import json, sys
from h100_bench.harness import banned_modules, main
rc = main(["--workload", sys.argv[1], "--seed", "3", "--seconds", "0.2", "--trace", "0"],
          require_card=False, device="cpu", overrides=json.loads(sys.argv[2]))
print(json.dumps({"rc": rc, "banned": banned_modules(), "port": "rtda_semanticsegmentation_tpu_torch" in sys.modules}))
"""
PLAIN = """
import json, sys
import h100_bench.reference.train, h100_bench.reference.serve, h100_bench.costs.flops, h100_bench.costs.lovasz
tops = {m.split(".", 1)[0] for m in sys.modules}
print(json.dumps(sorted(t for t in tops if t in ("rtda_semanticsegmentation_tpu_torch", "rtda_semanticsegmentation_tpu",
                                                 "chip_smoke", "jax") or t.startswith("profile_"))))
"""


def _python(code, *args):
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True, cwd=spec.ROOT,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_run_loads_no_jax(cell):
    got = _python(RUN, cell, json.dumps(TINY[cell]))
    assert got == {"rc": 0, "banned": [], "port": True}


def test_reference_loads_nothing_of_the_port():
    assert _python(PLAIN) == []


def test_banned_names_compare_whole():
    from h100_bench.harness import BANNED

    assert "rtda_semanticsegmentation_tpu_torch" not in BANNED and "rtda_semanticsegmentation_tpu" in BANNED


def test_benchmark_alone_prints_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    exits non-zero and prints no result."""
    import shutil

    shutil.copytree(spec.BENCH, tmp_path / "h100_bench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "r18-serve-b8", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout

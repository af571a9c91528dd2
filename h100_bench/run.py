#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result (JSON); the numbers that decided
``correct`` also end standard error. See ``h100_bench/harness.py``.
"""

import os
import sys
import time

STARTED = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub_dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
    os.environ[var] = os.path.join(ROOT, "build", "h100_bench_cache", sub_dir)
sys.path.insert(0, ROOT)

from h100_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], started=STARTED))

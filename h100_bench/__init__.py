"""The H100 benchmark of ``rtda_semanticsegmentation_tpu_torch``.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints its result as the last line of standard output. Everything the
benchmark measures with (traffic, weights, the plain reference, the FLOP
and byte counts, the trace readers, the correctness limits) lives in this
folder; from the port it takes only the system under test and its kernel
names and counters.
"""

"""Observability: metric logging (jsonl, W&B, null), performance profiling,
a timeline trace, the per-module parameter table and the per-module FLOP
table."""

from .logging import MetricLogger, make_logger
from .profiler import count_params, performance_metrics, trace
from .summary import flop_count_table, flops_and_params, model_summary_table

__all__ = [
    "MetricLogger",
    "make_logger",
    "count_params",
    "performance_metrics",
    "flops_and_params",
    "flop_count_table",
    "model_summary_table",
    "trace",
]

"""Observability: metric logging (jsonl, W&B, null), performance profiling
and the per-module FLOP table."""

from .logging import MetricLogger, make_logger
from .profiler import count_params, performance_metrics
from .summary import flop_count_table, flops_and_params

__all__ = [
    "MetricLogger",
    "make_logger",
    "count_params",
    "performance_metrics",
    "flops_and_params",
    "flop_count_table",
]

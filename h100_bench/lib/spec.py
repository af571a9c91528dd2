"""The cell's files, found by the names in ``BENCHMARK.json``.

- configuration: the entry's ``file`` (``configs/<config>.json``);
- traffic: ``traffic/<traffic>.json``, whose ``driver`` names
  ``drivers/<driver>.py``;
- the cell's own settings (the traced stretch, the correctness limits):
  ``workloads/<cell>.json``;
- a per-layer metric: ``metrics/<metric>.py``;
- the reference's network: ``reference/archs/<model name>.py``.

A later cell, configuration, traffic kind or metric is new files and
entries; nothing here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    settings: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` is the listed cells'; an end-to-end one
    without is every cell's, a per-layer one without is every cell's that
    reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = root / BENCH.name
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"], traffic_name=entry["traffic"],
        config=load_json(root / conf["file"]), traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        settings=load_json(bench_dir / "workloads" / f"{name}.json"), end_to_end=e2e, per_layer=layer,
    )


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT):
    return _module(root / BENCH.name / "drivers" / f"{kind}.py", f"h100_bench_driver_{kind}")


def reader(metric: str, root: Path = ROOT):
    return _module(root / BENCH.name / "metrics" / f"{metric}.py", f"h100_bench_metric_{metric.replace('.', '_')}")


@functools.lru_cache(maxsize=None)
def arch(name: str, root: Path = ROOT):
    """Loaded once a process for each name and root, so that its module
    state is shared by every step and count."""
    path = root / BENCH.name / "reference" / "archs" / f"{name}.py"
    return _module(path, f"h100_bench_arch_{name.replace('.', '_')}")


def read_metric(metric: str, run, root: Path = ROOT) -> Optional[float]:
    """The metric's reader applied to ``run``; None where it finds nothing."""
    value = reader(metric, root).read(run)
    return None if value is None else float(value)

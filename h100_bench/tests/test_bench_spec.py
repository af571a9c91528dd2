"""BENCHMARK.json against the benchmark's contract, and the cells' files
found by name."""

import json
import re
import shutil

import pytest

from h100_bench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"] and BENCH["command"][1].startswith("h100_bench/")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        entries = [e["name"] for e in BENCH[kind]]
        assert len(entries) == len(set(entries))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("h100_bench/") and (spec.ROOT / entry["file"]).is_file()
    assert _line(entry["source"]) and _line(entry["why"]) and entry["reduced"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.resolve(BENCH, cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1 and _line(entry["why"])
    assert hasattr(spec.driver(c.traffic["driver"]), "run")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names and callable(spec.reader(m["name"]).read)
    assert set(c.settings["limits"]) and c.settings["trace_units"] > 0 and c.settings["trace_warmup"] >= 1


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS) and _line(m["layer"])


def test_new_cell_needs_only_files(tmp_path):
    """A cell added as a traffic file, a settings file and an entry is
    found without editing any file the benchmark has."""
    shutil.copytree(spec.BENCH, tmp_path / "h100_bench")
    bench = json.loads(json.dumps(BENCH))
    traffic = dict(spec.load_json(spec.BENCH / "traffic" / "backlog_b8.json"), batch=4)
    (tmp_path / "h100_bench" / "traffic" / "backlog_b4.json").write_text(json.dumps(traffic))
    (tmp_path / "h100_bench" / "workloads" / "r18-serve-b4.json").write_text(
        (spec.BENCH / "workloads" / "r18-serve-b8.json").read_text())
    bench["workloads"].append({"name": "r18-serve-b4", "config": "bisenet-r18", "traffic": "backlog_b4",
                               "chips": 1, "why": "a later cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.resolve(spec.benchmark(tmp_path), "r18-serve-b4", tmp_path)
    assert c.traffic["batch"] == 4 and {m["name"] for m in c.end_to_end} == {"setup_s"}
    assert hasattr(spec.driver(c.traffic["driver"], tmp_path), "Program")


@pytest.mark.parametrize("name", ["bisenet-r18", "deeplabv2-r101"])
def test_config_is_the_preset(name):
    """The configuration file restates its preset: writing it over the
    preset changes nothing the port runs."""
    from rtda_semanticsegmentation_tpu_torch.config import get_preset

    from h100_bench.lib.port import experiment

    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    assert experiment(cfg) == get_preset(cfg["preset"])


@pytest.mark.parametrize("name,train", [("bisenet-r18", True), ("bisenet-r18", False), ("deeplabv2-r101", True)])
def test_reference_shapes_are_the_ports(name, train):
    from rtda_semanticsegmentation_tpu_torch.models import factory

    from h100_bench.lib.port import experiment
    from h100_bench.reference import nets

    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    exp = experiment(cfg)
    model = factory.build_model(exp.model, "cpu", train=train)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(nets.param_shapes(cfg["model"], train))
    if cfg["adversarial"]["enabled"]:
        d = factory.build_discriminator(exp.model, "cpu")
        assert {k: tuple(v.shape) for k, v in d.state_dict().items()} == dict(nets.discriminator_shapes(cfg["model"]))

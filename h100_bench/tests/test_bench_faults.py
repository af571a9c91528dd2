"""A whole run on the CPU, past the harness's look for a card, with the
timed path sound (``correct`` true) and with each fault a cell can have
planted underneath (``correct`` false). Float32 at a tiny size, against
the cells' own limits."""

import json

import pytest

from h100_bench import harness
from h100_bench.lib import faults, spec


def _f32(name):
    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    return {"model": {**cfg["model"], "compute_dtype": "float32"},
            "augment": {**cfg["augment"], "aug_dtype": "float32"}, "serve_precision": "f32"}


TINY = {
    "r18-adv-train": {"config": _f32("bisenet-r18"), "traffic": {"batch": 4, "source": [64, 96], "target": [64, 96]}},
    "dlv2-train": {"config": _f32("deeplabv2-r101"), "traffic": {"batch": 4, "source": [64, 96]}},
    "r18-serve-b8": {"config": _f32("bisenet-r18"), "traffic": {"batch": 2, "size": [64, 96], "warmup_rounds": 1}},
}
CASES = [(c, None) for c in TINY] + [
    ("r18-adv-train", "unchanged"), ("r18-adv-train", "half_batch"),
    ("dlv2-train", "unchanged"), ("dlv2-train", "half_batch"),
    ("r18-serve-b8", "altered_answer"),
]


@pytest.mark.parametrize("cell,fault", CASES, ids=lambda v: str(v))
def test_correct_only_when_sound(cell, fault, capsys):
    argv = ["--workload", cell, "--seed", "2147483711", "--seconds", "0.3", "--trace", "0"]
    if fault is None:
        rc = harness.main(argv, require_card=False, device="cpu", overrides=TINY[cell])
    else:
        with faults.FAULTS[fault]():
            rc = harness.main(argv, require_card=False, device="cpu", overrides=TINY[cell])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"

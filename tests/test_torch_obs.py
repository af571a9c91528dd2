"""The port's observability leftovers against the JAX package: the
per-module parameter table (``obs.model_summary_table``) of BiSeNet-R18
(eval form, 64 x 96) and of the FC-Discriminator, whose counts must equal
the JAX table's exactly (parameters and batch statistics), and the
``torch.profiler`` trace context manager."""

import json
import re

import flax
import jax
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.config import ModelConfig as JModelConfig
from rtda_semanticsegmentation_tpu.models.factory import build_discriminator as jbuild_discriminator
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.obs.summary import model_summary_table as jmodel_summary_table
from rtda_semanticsegmentation_tpu_torch.config import ModelConfig
from rtda_semanticsegmentation_tpu_torch.models.factory import build_discriminator, build_model
from rtda_semanticsegmentation_tpu_torch.obs import model_summary_table, trace


def _total(table: str) -> int:
    return int(re.search(r"Total Parameters: ([\d,]+)", table).group(1).replace(",", ""))


def _rows(table: str) -> dict:
    """path -> (#params, #batch stats) of the port's table."""
    out = {}
    for line in table.splitlines()[2:-2]:
        cells = [c.strip() for c in line.split("|")]
        out[cells[0]] = (int(cells[3].replace(",", "")), int(cells[4].replace(",", "")))
    return out


@pytest.mark.parametrize("what", ["bisenet_r18", "discriminator"])
def test_model_summary_counts_match_jax(what):
    if what == "bisenet_r18":
        jmodule, shape = jbuild_model(JModelConfig(compute_dtype="float32")), (1, 64, 96, 3)
        port = build_model(ModelConfig(compute_dtype="float32"), device="cpu")
    else:
        jmodule, shape = jbuild_discriminator(JModelConfig(compute_dtype="float32")), (1, 64, 96, 19)
        port = build_discriminator(ModelConfig(compute_dtype="float32"), device="cpu")
    jtable = jmodel_summary_table(jmodule, shape, depth=1)
    table = model_summary_table(port, depth=1)
    assert _total(table) == _total(jtable)
    x = jax.numpy.zeros(shape)
    variables = jmodule.init(jax.random.PRNGKey(0), x, False) if what == "bisenet_r18" else \
        jmodule.init(jax.random.PRNGKey(0), x)
    want = {}
    for kind, col in (("params", 0), ("batch_stats", 1)):
        for path, v in flax.traverse_util.flatten_dict(variables.get(kind, {}), sep="/").items():
            counts = want.setdefault(path.split("/")[0], [0, 0])
            counts[col] += int(np.size(v))
    rows = _rows(table)
    assert {k: list(v) for k, v in rows.items() if k != "(model)"} == want
    assert "Total" in table.splitlines()[-2]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    (path,) = (tmp_path / "t").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

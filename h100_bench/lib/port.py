"""The system under test, configured from a configuration file.

The file names one of the port's presets and, group by group, the values
the cell runs with; they are written over the preset, so the port runs
exactly what the file (and the reference, which reads the same file)
says. The port is imported here, inside functions, after the harness has
found a card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PACKAGE = "rtda_semanticsegmentation_tpu_torch"
GROUPS = ("model", "optimizer", "adversarial", "loss", "augment", "data")


def _value(v):
    return tuple(_value(x) for x in v) if isinstance(v, list) else v


def experiment(config: dict):
    from rtda_semanticsegmentation_tpu_torch.config import get_preset

    exp = get_preset(config["preset"])
    for group in GROUPS:
        fields = {k: _value(v) for k, v in config.get(group, {}).items()}
        if fields:
            exp = exp.replace(**{group: dataclasses.replace(getattr(exp, group), **fields)})
    return exp


def counters() -> Dict[str, int]:
    """Every counter the port's recorder keeps (``obs/spans.py``), by its
    own name: those its code has counted in this process."""
    from rtda_semanticsegmentation_tpu_torch.obs.spans import RECORDER

    return dict(RECORDER.counters)


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each counter's change since ``before`` (a :func:`counters`), by name."""
    now = counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in sorted({*before, *now})}

"""The port's own spans (``rtda_semanticsegmentation_tpu_torch/obs/spans.py``),
read from the process and laid on the traced stretch.

The recorder is read from ``sys.modules``, as ``drivers/train_step.py``
reads the launch counters; a port without it gives None everywhere. Its
spans of units record only while a profiler is active, so the units it
holds with ``profiled`` set are exactly the traced stretch's. Their device
ms come from the program's own CUDA events; their host times are on
``time.time_ns()``'s clock, which is the profiler's, up to an offset that
:func:`align` finds from anchors the trace itself holds:

- on the card, the ``cudaEventRecord`` runtime call of each span boundary
  (the recorder takes a boundary's host time just after recording its
  event, so the call ends just before it); other such calls in the trace,
  a pinned copy's among them, are left unmatched;
- on the CPU, each span's own profiler range (its start and its end).

The alignment holds only if every boundary then sits within
``TOLERANCE_US`` of its anchor; otherwise every reader that needs it
returns None. :func:`idle_by_span` puts each idle gap of the trace down to
the innermost span under way on the host at its start, or to
``OUTSIDE``. :func:`describe` says once a run, on standard error, how the
spans aligned and what each took.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from typing import Dict, List, Optional, Tuple

MODULE = "rtda_semanticsegmentation_tpu_torch.obs.spans"
ANCHORS = ("cudaEventRecord", "cudaEventRecordWithFlags")
TOLERANCE_US = 20.0
OUTSIDE = "outside the program"
ROOTS = {"train": "train.step", "serve": "serve.request"}  # a unit's root span by the run's kind

Boundary = Tuple[object, float]  # (key, host us)


def records() -> Optional[List[dict]]:
    """The recorder's spans, exported (None where the port has none)."""
    mod = sys.modules.get(MODULE)
    export = getattr(mod, "export", None)
    return None if export is None else export()


def traced_units(recs: List[dict], root: str) -> List[List[dict]]:
    """The traced stretch's units whose root span is ``root``: each a list
    of its spans, the root first."""
    by_unit: Dict[int, List[dict]] = {}
    for r in recs:
        if r["profiled"] and r["unit"] is not None:
            by_unit.setdefault(r["unit"], []).append(r)
    return [sorted(u, key=lambda r: r["t0_ns"]) for u in by_unit.values()
            if any(r["name"] == root and r["parent"] is None for r in u)]


def phase_ms(recs: Optional[List[dict]], root: str, name: str, kind: str = "device") -> Optional[float]:
    """Mean ms a unit in spans named ``name`` (``kind``: ``device`` or
    ``host`` ms), over the traced units of ``root``; None where no unit
    has such a span."""
    if recs is None:
        return None
    units = traced_units(recs, root)
    if not units or not any(r["name"] == name for u in units for r in u):
        return None
    return statistics.fmean(sum(r[f"{kind}_ms"] for r in u if r["name"] == name) for u in units)


def _boundaries(recs: List[dict], card: bool) -> List[Boundary]:
    """Each boundary of the traced spans with the key of the anchor it
    matches: on the card any event record, on the CPU its own range's start
    or end."""
    out = []
    for r in recs:
        if r["profiled"] and (r["events"] or not card):
            out.append((None if card else (r["name"], 0), r["t0_ns"] * 1e-3))
            out.append((None if card else (r["name"], 1), r["t1_ns"] * 1e-3))
    return sorted(out, key=lambda b: b[1])


def _anchors(host, card: bool, names) -> Dict[object, List[float]]:
    out: Dict[object, List[float]] = {}
    for name, start, end in host:
        if card and name in ANCHORS:
            out.setdefault(None, []).append(end)
        elif not card and name in names:
            out.setdefault((name, 0), []).append(start)
            out.setdefault((name, 1), []).append(end)
    return {k: sorted(v) for k, v in out.items()}


def match(bounds: List[Boundary], anchors: Dict[object, List[float]],
          tolerance: float = TOLERANCE_US) -> Optional[Tuple[float, float]]:
    """The offset (host us minus trace us) that puts every boundary on an
    anchor of its key, each anchor used once, and the largest distance left
    after it: (offset, residual). None where no offset leaves every
    boundary within ``tolerance``."""
    if not bounds:
        return None
    key0, t0 = bounds[0]
    best = None
    for a0 in anchors.get(key0, ()):
        shift = t0 - a0
        pairs = _pairs(bounds, anchors, shift, 3 * tolerance)
        if pairs is None:
            continue
        shift = statistics.median(t - a for t, a in pairs)
        residual = max(abs(t - a - shift) for t, a in pairs)
        if best is None or residual < best[1]:
            best = (shift, residual)
    return best if best is not None and best[1] <= tolerance else None


def _pairs(bounds, anchors, shift: float, within: float) -> Optional[List[Tuple[float, float]]]:
    """Each boundary with the nearest unused anchor of its key, at
    ``shift``; None where one has none within ``within``."""
    used = {k: -1 for k in anchors}
    pairs = []
    for key, t in bounds:
        times = anchors.get(key)
        if not times:
            return None
        i = bisect.bisect_left(times, t - shift)
        near = [j for j in (i - 1, i) if used[key] < j < len(times)]
        if not near:
            return None
        j = min(near, key=lambda j: abs(times[j] - (t - shift)))
        if abs(times[j] - (t - shift)) > within:
            return None
        used[key] = j
        pairs.append((t, times[j]))
    return pairs


def align(run, recs: Optional[List[dict]]) -> Optional[Tuple[float, float]]:
    """(offset us, residual us) of the traced spans against ``run.trace``,
    or None (no trace, no spans, or an anchor farther than the
    tolerance)."""
    if recs is None or run.trace is None:
        return None
    card = any(r["events"] for r in recs if r["profiled"])
    names = {r["name"] for r in recs if r["profiled"]}
    return match(_boundaries(recs, card), _anchors(run.trace.host, card, names))


def _depth(recs: List[dict], i: int) -> int:
    d = 0
    while recs[i]["parent"] is not None:
        i, d = recs[i]["parent"], d + 1
    return d


def _placed(run, recs: Optional[List[dict]]):
    """The traced spans on the trace's clock, as (start us, end us, depth,
    name), or None where they cannot be aligned."""
    found = align(run, recs)
    if found is None:
        return None
    shift = found[0]
    card = any(r["events"] for r in recs if r["profiled"])
    return [(r["t0_ns"] * 1e-3 - shift, r["t1_ns"] * 1e-3 - shift, _depth(recs, i), r["name"])
            for i, r in enumerate(recs) if r["profiled"] and (r["events"] or not card)]


def _innermost(placed, t: float) -> str:
    under = [sp for sp in placed if sp[0] <= t < sp[1]]
    return max(under, key=lambda sp: sp[2])[3] if under else OUTSIDE


def idle_by_span(run, recs: Optional[List[dict]]) -> Optional[Dict[str, float]]:
    """Device idle us of the traced stretch by the innermost span under way
    on the host at each gap's start (``OUTSIDE`` where none is), or None
    where the spans cannot be aligned."""
    placed = _placed(run, recs)
    if placed is None:
        return None
    out: Dict[str, float] = {}
    for s, e in run.trace.gaps():
        name = _innermost(placed, s)
        out[name] = out.get(name, 0.0) + (e - s)
    return out


_said: Dict[int, object] = {}


def describe(run) -> Optional[List[dict]]:
    """The recorder's spans, read once a run; the first read also says on
    standard error how the spans aligned with the trace and, by span name,
    their device, host and idle ms a unit (the tables of PERF.md §5)."""
    held = _said.get(id(run))
    if held is not None and held[0] is run:
        return held[1]
    recs = records()
    _said.clear()
    _said[id(run)] = (run, recs)
    if recs is None or run.trace is None:
        return recs
    card = any(r["events"] for r in recs if r["profiled"])
    bounds = _boundaries(recs, card)
    found = align(run, recs)
    names = {r["name"] for r in recs if r["profiled"]}
    n_anchors = sum(len(v) for v in _anchors(run.trace.host, card, names).values())
    what = "no alignment within" if found is None else f"residual {found[1]:.2f} us of"
    _note(f"spans: {len(bounds)} span boundaries against {n_anchors} anchors; {what} {TOLERANCE_US:.0f} us")
    units = traced_units(recs, ROOTS.get(run.kind, ""))
    idle = idle_by_span(run, recs) or {}
    rows = []
    for name in dict.fromkeys(r["name"] for u in units for r in u):
        dev, host = (statistics.fmean(sum(r[k] for r in u if r["name"] == name) for u in units)
                     for k in ("device_ms", "host_ms"))
        rows.append(f"{name} {dev:.3f} {host:.3f} {idle.get(name, 0.0) * 1e-3 / run.trace.units:.3f}")
    rows.append(f"{OUTSIDE} idle {idle.get(OUTSIDE, 0.0) * 1e-3 / run.trace.units:.3f}")
    _note(f"spans a unit over {len(units)} units, name device host idle ms: " + "; ".join(rows)
          + f"; traced wall {run.trace.window_s * 1e3 / run.trace.units:.3f} ms a unit"
          + f"; upsample group {run.trace.group_ms('upsample'):.3f} ms a unit")
    placed = _placed(run, recs)
    if placed is not None:
        longest = sorted(run.trace.gaps(), key=lambda g: g[0] - g[1])[:8]
        _note("spans: longest gaps (host call, span, ms): " + "; ".join(
            f"{run.trace.host_at(a)}, {_innermost(placed, a)}, {(b - a) * 1e-3:.3f}" for a, b in longest))
    return recs


def _note(msg: str) -> None:
    print(f"[h100_bench] {msg}", file=sys.stderr, flush=True)


def idle_ms(run, name: str) -> Optional[float]:
    """Device idle ms a unit put down to spans named ``name``."""
    if run.trace is None:
        return None
    idle = idle_by_span(run, describe(run))
    return None if idle is None else idle.get(name, 0.0) * 1e-3 / run.trace.units


def _outermost(recs: List[dict], name: str, within: Optional[int] = None) -> List[int]:
    """Indices of the spans named ``name`` with no ancestor of that name
    (and, with ``within``, that descend from record ``within``)."""
    out = []
    for i, r in enumerate(recs):
        if r["name"] != name:
            continue
        j, inside, nested = r["parent"], within is None, False
        while j is not None:
            nested = nested or recs[j]["name"] == name
            inside = inside or j == within
            j = recs[j]["parent"]
        if inside and not nested:
            out.append(i)
    return out


def build_s(recs: Optional[List[dict]]) -> Optional[float]:
    """Host seconds in the process's ``setup.build`` spans (nested ones
    counted once)."""
    if recs is None:
        return None
    found = _outermost(recs, "setup.build")
    return sum(recs[i]["host_ms"] for i in found) * 1e-3 if found else None


def first_unit_s(recs: Optional[List[dict]]) -> Optional[float]:
    """Host seconds of the process's first step or request (its lazy
    initialisation), the ``kernels.build`` spans inside it left out."""
    if recs is None:
        return None
    firsts = [i for i, r in enumerate(recs) if r["first"] and r["parent"] is None and r["name"] in ROOTS.values()]
    if not firsts:
        return None
    i = min(firsts, key=lambda k: recs[k]["t0_ns"])
    builds = sum(recs[k]["host_ms"] for k in _outermost(recs, "kernels.build", within=i))
    return (recs[i]["host_ms"] - builds) * 1e-3

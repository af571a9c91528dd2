"""Spans and counters recorded inside the port: where a train step, a
serving request and set-up spend their time, and how often the kernels
launch.

A span is a named block (``with span("train.loss"):``). It records its
parent span, the unit it belongs to (a step or a request: one id shared by
every span of that unit, given by the unit's root span), its host start
and end on ``time.time_ns()``'s clock (the clock ``torch.profiler`` puts
its events on) and, on a CUDA device, a timing event recorded on the
unit's stream at each boundary: the span's device ms are the events'
``elapsed_time``, read once the stream has passed them. On the CPU the
device ms are the host ms. The host time of a boundary is taken after its
event is recorded, so the ``cudaEventRecord`` runtime call that a device
trace shows for it ends just before that time (the anchor the benchmark
aligns the spans with its trace by).

The switch: a span of a unit records only while a torch profiler is
active (``torch._C._autograd._profiler_enabled()``, true only in a
profiler schedule's active phase). Off, a span site costs that check and
nothing else. These record whatever the profiler: spans opened with
``always=True`` (set-up, the loop's step clock, a timed block) and every
span of a :class:`Unit`'s first call, which carries the function's lazy
initialisation. While a profiler runs, each span also opens a profiler
range of its own name (``record_function``), so a trace that records the
host shows the spans natively.

Spans stay in memory, in a bounded store, until :func:`export` is asked
for them. :func:`count` keeps integer counters in the same recorder (the
kernel wrappers' launches and operand copies).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import torch

_enabled = torch._C._autograd._profiler_enabled
# a profiler range at ~1.5 us a span, where ``record_function`` takes ~14
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.autograd.profiler.record_function)

MAX_SPANS = 1 << 16  # spans of units kept, newest last
MAX_SETUP_SPANS = 1 << 12  # set-up spans and first calls' spans kept


class Span:
    """One recorded block; open it with ``with`` or :meth:`open` /
    :meth:`close`."""

    __slots__ = ("recorder", "name", "parent", "unit", "setup", "first", "profiled", "stream", "t0", "t1",
                 "e0", "e1", "_new_unit", "_device", "_range")

    def __init__(self, recorder: "Recorder", name: str, device=None, unit: bool = False, setup: bool = False,
                 first: bool = False):
        self.recorder, self.name, self.setup, self.first = recorder, name, setup, first
        self._new_unit, self._device = unit, device
        self.parent = self.unit = self.stream = self.e0 = self.e1 = self._range = None
        self.t0 = self.t1 = 0

    def open(self) -> "Span":
        local = self.recorder._local
        stack = local.stack
        parent = stack[-1] if stack else None
        self.parent = parent
        if parent is not None and parent.unit is not None:
            self.unit = parent.unit  # a step inside the loop's step clock is the clock's unit
        elif self._new_unit:
            self.unit = self.recorder._next_unit()
        if self._device is not None:
            device = torch.device(self._device)
            if device.type == "cuda":
                self.stream = torch.cuda.current_stream(device)
        elif parent is not None:
            self.stream = parent.stream
        self.first = self.first or (parent is not None and parent.first)
        self.profiled = _enabled()
        if self.profiled:
            self._range = _Range(self.name)
            self._range.__enter__()
        if self.stream is not None:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record(self.stream)
        self.t0 = time.time_ns()
        stack.append(self)
        if self.first:
            local.forced += 1
        return self

    def close(self) -> None:
        if self.stream is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record(self.stream)
        self.t1 = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        local = self.recorder._local
        if local.stack and local.stack[-1] is self:
            local.stack.pop()
        else:  # closed out of order: an exception unwound past a child
            local.stack.remove(self)
        if self.first:
            local.forced -= 1
        self.recorder._keep(self)

    def __enter__(self) -> "Span":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def device_ms(self) -> float:
        """Milliseconds on the device's timeline (waits for the end event);
        the host ms on the CPU."""
        if self.e1 is None:
            return self.host_ms
        self.e1.synchronize()
        return self.e0.elapsed_time(self.e1)


class _Off:
    """What a span site gets while nothing records: no clock, no event."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []
        self.forced = 0  # open first-call units: their spans record without a profiler


class Recorder:
    """A process's spans and counters (the module's functions use
    :data:`RECORDER`)."""

    def __init__(self):
        self._local = _Local()
        self._units: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self._setup: collections.deque = collections.deque(maxlen=MAX_SETUP_SPANS)
        self._lock = threading.Lock()
        self._unit_ids = 0
        self.counters: Dict[str, int] = collections.defaultdict(int)

    def span(self, name: str, device=None, *, always: bool = False, unit: bool = False, setup: bool = False):
        """A span of ``name`` (a context manager), or :data:`OFF` where it
        would not record. ``device``: where the span's events go (a CUDA
        device records them on its current stream); a nested span takes
        its parent's. ``unit``: the span starts a unit. ``setup``: a
        once-per-process set-up span (kept apart from the units)."""
        if not (_enabled() or always or self._local.forced):
            return OFF
        return Span(self, name, device, unit=unit, setup=setup)

    def _next_unit(self) -> int:
        with self._lock:
            self._unit_ids += 1
            return self._unit_ids

    def _keep(self, span: Span) -> None:
        (self._setup if span.setup or span.first else self._units).append(span)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def set_counter(self, name: str, value: int = 0) -> None:
        with self._lock:
            self.counters[name] = value

    def export(self, since_ns: int = 0) -> List[dict]:
        """The kept spans that opened at or after ``since_ns``, by start
        time, as plain records (``parent``: the index of the parent's
        record, or None), device ms read from their events."""
        kept = sorted((s for s in (*self._setup, *self._units) if s.t0 >= since_ns), key=lambda s: s.t0)
        index = {id(s): i for i, s in enumerate(kept)}
        out = [{
            "name": s.name, "parent": index.get(id(s.parent)) if s.parent is not None else None, "unit": s.unit,
            "t0_ns": s.t0, "t1_ns": s.t1, "host_ms": s.host_ms, "device_ms": s.device_ms,
            "events": s.e0 is not None, "profiled": s.profiled, "first": s.first, "setup": s.setup,
        } for s in kept]
        return out

    def clear(self) -> None:
        self._units.clear()
        self._setup.clear()


RECORDER = Recorder()


# the process's recorder, as module functions (bound methods: a span site
# that does not record costs one call and the profiler check)
span = RECORDER.span
count = RECORDER.count
counter = RECORDER.counter
set_counter = RECORDER.set_counter
export = RECORDER.export


def setup_span(name: str):
    """A set-up span: recorded always, kept apart from the units."""
    return RECORDER.span(name, always=True, setup=True)


class Unit:
    """The root span of a step or a request, made once per function: its
    first call records, children included, whatever the profiler."""

    __slots__ = ("name", "_first")

    def __init__(self, name: str):
        self.name, self._first = name, True

    def __call__(self, device=None):
        if self._first:
            self._first = False
            return Span(RECORDER, self.name, device, unit=True, first=True)
        return RECORDER.span(self.name, device, unit=True)


def module_counters(prefix: str, names: tuple):
    """A module's ``__getattr__`` that reads counter ``<prefix>.<name>`` as
    the module attribute ``name``, for each of ``names`` (the kernel
    wrappers' ``launches`` and ``copies``)."""

    def __getattr__(attr: str) -> int:
        if attr in names:
            return RECORDER.counter(f"{prefix}.{attr}")
        raise AttributeError(f"module has no attribute {attr!r}")

    return __getattr__

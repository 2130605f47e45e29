"""The port's tracer: host spans, device stages and work counters, off by
default and turned on in code (:func:`enable`, :func:`disable`).

- **Host spans** (:func:`span`): name, start and end on
  ``time.perf_counter_ns()``, the enclosing span, and the id of the request
  or step the span belongs to (a request's id is its predict function's
  call count, a step's ``state.step``). Each open span also opens a
  ``torch.profiler.record_function`` of its name, so a profiled stretch
  carries the program's spans on the profiler's clock beside the device's
  activity, and an idle gap of the device can be put down to the span the
  host was in.
- **Device stages** (:func:`stages`, :func:`stage`): the boundaries a body
  of work marks between its stages. On the card each boundary records one
  timing CUDA event, shared by the stage that ends there and the one that
  starts there. Recorded while a CUDA graph is captured, the events are
  ``external``: the capture turns them into event-record nodes of the
  graph, and for each replay (:func:`replaying`) the tracer reads the
  elapsed time between consecutive events, each stage's device ms inside
  the replayed graph. Eagerly the same boundaries record ordinary events on
  the card, and host time on the CPU. A stage that repeats within one body
  (micro-batches) is summed.
- **Work counters** (:func:`count`): ``tensor.sum()`` (or a host number)
  added into an int64 slot of a buffer on the tensor's device, with no
  wait for the device; under capture the addition becomes part of the
  graph. Read once, by :func:`summary`. :func:`count_first` adds 1 the
  first time a key is seen, outside captures only.

With tracing off a span, a stage mark and a count are a flag check, and a
graph captured then holds no event node and no counter kernel: the
graphed paths keep the traced and the untraced graph apart.
:func:`summary` is the only reader.
"""

from __future__ import annotations

import statistics
import time
from typing import NamedTuple

import torch

COUNTER_SLOTS = 32


class SpanRecord(NamedTuple):
    id: int  # in opening order, from 0 after the last reset
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int  # the enclosing span's id, -1 for none
    unit: int | None  # the request's or step's id


class _Noop:
    """What a span or a recorder is with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("tracer", "name", "unit", "id", "parent", "start", "profiled")

    def __init__(self, tracer, name, unit):
        self.tracer, self.name, self.unit = tracer, name, unit

    def __enter__(self):
        t = self.tracer
        self.parent = t.open[-1] if t.open else None
        if self.unit is None and self.parent is not None:
            self.unit = self.parent.unit
        self.id = t.next_id
        t.next_id += 1
        t.open.append(self)
        self.profiled = torch.profiler.record_function(self.name)
        self.profiled.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.profiled.__exit__(None, None, None)
        t = self.tracer
        t.open.pop()
        t.spans.append(SpanRecord(self.id, self.name, self.start, end,
                                  -1 if self.parent is None else self.parent.id,
                                  self.unit))
        return False


class Timed:
    """A span timed whatever the switch says (a graph's capture: rare, and
    its seconds are kept by the graph). ``seconds`` once it closed."""

    def __init__(self, tracer, name, device):
        self.tracer, self.name, self.device = tracer, name, device
        self.seconds = None

    def __enter__(self):
        if self.tracer.on and self.device.type == "cuda":
            # a counter's slot must exist before a capture adds into it
            self.tracer.buffer(self.device)
        self.span = self.tracer.span(self.name)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return self.span.__exit__(*exc)


class Recorder:
    """The stage boundaries of one body of work: names in order and, at
    each, a CUDA event (``kind`` "graph" under capture, "eager" on the
    card) or a host time in ns ("host")."""

    def __init__(self, tracer, device):
        self.tracer, self.device = tracer, device
        capturing = (device.type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
        self.kind = ("graph" if capturing else "eager") if device.type == "cuda" else "host"
        self.names, self.marks = [], []
        self.counted = set()  # the counters this body adds to
        self.unit = None

    def mark(self, name: str | None):
        if self.kind == "host":
            self.marks.append(time.perf_counter_ns())
        else:
            event = torch.cuda.Event(enable_timing=True,
                                     external=self.kind == "graph")
            event.record(torch.cuda.current_stream(self.device))
            self.marks.append(event)
        if name is not None:
            self.names.append(name)

    def __enter__(self):
        t = self.tracer
        self.unit = t.open[-1].unit if t.open else None
        t.recorders.append(self)
        return self

    def __exit__(self, exc_type, *exc):
        t = self.tracer
        t.recorders.pop()
        if exc_type is None and self.names:
            self.mark(None)
            if self.kind != "graph":  # a capture ran nothing: replays read it
                t.pending.append((self, self.unit))
                t.read_ready()
        return False

    def ready(self) -> bool:
        return self.kind == "host" or self.marks[-1].query()

    def read(self) -> dict:
        """Each stage's ms in this body's last run (waits for it)."""
        if self.kind == "host":
            ms = [(b - a) / 1e6 for a, b in zip(self.marks, self.marks[1:])]
        else:
            self.marks[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        out = {}
        for name, v in zip(self.names, ms):
            out[name] = out.get(name, 0.0) + v
        return out


class Tracer:
    def __init__(self):
        self.on = False
        self.slots: dict[str, int] = {}  # counter name → slot, kept by reset
        self.buffers: dict[torch.device, torch.Tensor] = {}  # kept by reset:
        #   captured graphs add into them
        self.open: list[_Span] = []  # the spans and recorders open now
        self.recorders: list[Recorder] = []
        self.seen: set = set()  # count_first's keys, kept by reset: each
        #   marks a first of the process (a convolution problem whose engine
        #   cuDNN chose), which a reset does not undo
        self.reset()

    def reset(self):
        """Forget every span, stage reading and count (the counter buffers
        are zeroed in place, behind the work queued before)."""
        self.spans: list[SpanRecord] = []
        self.next_id = 0
        self.pending: list[tuple[Recorder, int | None]] = []
        self.readings: list[tuple[int | None, str, dict]] = []
        self.counted: set[str] = set()  # counters added to since the reset
        for buf in self.buffers.values():
            buf.zero_()

    # ----- host spans
    def span(self, name: str, unit: int | None = None):
        """A context that records a span, ``unit`` its request or step id
        (else the enclosing span's); :data:`NOOP` with tracing off."""
        if not self.on:
            return NOOP
        return _Span(self, name, unit)

    def timed(self, name: str, device) -> Timed:
        return Timed(self, name, torch.device(device))

    # ----- device stages
    def stages(self, device):
        """A context around one body of work whose :meth:`stage` marks it
        records; the request or step is the innermost open span's.
        :data:`NOOP` with tracing off. Under capture the recorder it yields
        is what :meth:`replaying` reads for each replay."""
        if not self.on:
            return NOOP
        return Recorder(self, torch.device(device))

    def stage(self, name: str):
        """The boundary where stage ``name`` starts (and the last one
        ends)."""
        if self.on and self.recorders:
            self.recorders[-1].mark(name)

    def replaying(self, recorder):
        """A graph captured with ``recorder`` is about to be replayed for
        the innermost open span's request or step. Each replay records the
        same events again, so the last replay's reading is taken first
        (waiting for that replay, if it has not run yet: on the card a
        traced chain of replays waits for each step before it launches the
        next) and this replay's is queued."""
        if not (self.on and isinstance(recorder, Recorder)):
            return
        self.counted |= recorder.counted
        for i, (rec, unit) in enumerate(self.pending):
            if rec is recorder:
                self.readings.append((unit, rec.kind, rec.read()))
                del self.pending[i]
                break
        self.pending.append((recorder, self.open[-1].unit if self.open else None))

    def read_ready(self):
        """Take the readings whose last event has run, without waiting."""
        keep = []
        for rec, unit in self.pending:
            if rec.kind != "graph" and rec.ready():
                self.readings.append((unit, rec.kind, rec.read()))
            else:
                keep.append((rec, unit))
        self.pending = keep

    # ----- counters
    def buffer(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self.buffers:
            with torch.inference_mode(False):  # zeroed again outside it
                self.buffers[device] = torch.zeros(COUNTER_SLOTS, dtype=torch.int64,
                                                   device=device)
        return self.buffers[device]

    def count(self, name: str, value, device=None):
        """Add ``value`` (a tensor's sum, or a host number of slots on
        ``device``) to counter ``name``, on the device, without waiting."""
        if not self.on:
            return
        slot = self.slots.get(name)
        if slot is None:
            if len(self.slots) == COUNTER_SLOTS:
                raise RuntimeError(f"tracing: no counter slot left for {name!r}")
            slot = self.slots[name] = len(self.slots)
        self.counted.add(name)
        if self.recorders:
            self.recorders[-1].counted.add(name)
        if isinstance(value, torch.Tensor):
            self.buffer(value.device)[slot].add_(value.sum())
        else:
            self.buffer(device)[slot].add_(int(value))

    def count_first(self, name: str, key, device):
        """Add 1 to counter ``name`` on ``device`` the first time ``key`` is
        seen with tracing on (under whichever name it first came; a reset
        forgets the count, not the key).
        A sighting is the host's: none is taken while the current stream
        captures, so no graph gains the counter's kernel."""
        device = torch.device(device)
        if (not self.on or key in self.seen
                or (device.type == "cuda" and torch.cuda.is_current_stream_capturing())):
            return
        self.seen.add(key)
        self.count(name, 1, device)

    # ----- the reader
    def summary(self) -> dict:
        """What was traced since the last reset (waits for the device):

        - ``units``: the requests or steps whose stages were read;
        - ``stages_ms``: each stage's median ms a unit, and ``stage_kinds``,
          how they were read ("graph", "eager" or "host");
        - ``spans_ms``: each span name's count, median and p95 ms;
        - ``counters``: each counter's total, and ``counters_per_unit``.
        """
        for rec, unit in self.pending:
            self.readings.append((unit, rec.kind, rec.read()))
        self.pending = []
        per_unit, kinds = {}, set()
        for i, (unit, kind, ms) in enumerate(self.readings):
            kinds.add(kind)
            row = per_unit.setdefault(("unit", unit) if unit is not None else ("run", i), {})
            for name, v in ms.items():
                row[name] = row.get(name, 0.0) + v
        names = []
        for row in per_unit.values():
            names.extend(n for n in row if n not in names)
        stages = {n: statistics.median([row[n] for row in per_unit.values() if n in row])
                  for n in names}
        by_name = {}
        for s in self.spans:
            by_name.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
        spans = {n: {"n": len(v), "p50": statistics.median(v), "p95": percentile(v, 95)}
                 for n, v in by_name.items()}
        totals = {}
        for buf in self.buffers.values():
            values = buf.tolist()
            for name, slot in self.slots.items():
                if name in self.counted:
                    totals[name] = totals.get(name, 0) + values[slot]
        units = len(per_unit)
        return {"units": units, "stages_ms": stages, "stage_kinds": sorted(kinds),
                "spans_ms": spans, "counters": totals,
                "counters_per_unit": {n: v / units for n, v in totals.items()} if units else {}}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) by linear interpolation between the
    closest ranks (numpy's default)."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


TRACER = Tracer()


def enable():
    TRACER.on = True


def disable():
    TRACER.on = False


def is_on() -> bool:
    return TRACER.on


span = TRACER.span
timed = TRACER.timed
stages = TRACER.stages
stage = TRACER.stage
replaying = TRACER.replaying
count = TRACER.count
count_first = TRACER.count_first
reset = TRACER.reset
summary = TRACER.summary

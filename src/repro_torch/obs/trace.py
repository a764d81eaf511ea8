"""Bounded-ring tracer with Chrome-trace-event (Perfetto) export.

The paper's evaluation is *measured*: per-decision scheduling latency,
tasks/sec, latency breakdowns under dynamically arriving workloads
(Section VI).  This module is the event side of reproducing those numbers:
a :class:`Tracer` records span / instant / counter events into a bounded
ring buffer and exports them as Chrome trace-event JSON, loadable directly
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Design constraints, in order:

* **Near-zero cost when off.**  A disabled tracer (``Tracer(enabled=False)``
  or the shared :data:`NULL_TRACER`) allocates nothing per call: ``span``
  returns a module-level singleton no-op context manager and the record
  paths return before touching the ring.  Instrumentation sites guard with
  ``if tracer is not None`` so the *default* runtime path is byte-identical
  to the uninstrumented code.
* **Bounded memory.**  Events land in a preallocated ring
  (``capacity`` slots); wraparound drops the oldest events.  A steady-state
  serving loop can stay instrumented forever without growing the heap.
* **Two clocks.**  Wall-clock events take their timestamp from
  ``time.perf_counter`` relative to the tracer's epoch; simulators pass
  explicit ``ts_us`` values so simulated timelines export on their own
  axis (the discrete-event serving simulator's queue-depth counters).
* **The device trace's clock.**  While a ``torch.profiler`` is recording,
  a :meth:`Tracer.span` also opens a ``record_function`` range of its name,
  so the program's phases appear among the profiler's host ranges beside
  the kernels they launched.  Whether one is recording is read from
  ``torch.autograd.profiler._is_profiler_enabled`` once a span, a module
  global; with no profiler recording a span opens no range.  Records made
  after the fact (:meth:`Tracer.complete`) are not mirrored.

Timestamps are microseconds (the Chrome trace-event unit).
"""

from __future__ import annotations

import io
import json
import time

import torch.autograd.profiler as _profiler

_PH_KNOWN = frozenset({"X", "i", "I", "C", "B", "E", "M"})


class TraceEvent:
    """One trace event (Chrome trace-event phases: X=span, i=instant,
    C=counter).  ``ts``/``dur`` are microseconds; ``args`` is the free-form
    payload dict."""

    __slots__ = ("name", "ph", "ts", "dur", "args", "tid")

    def __init__(self, name: str, ph: str, ts: float, dur: float = 0.0,
                 args: dict | None = None, tid: int = 0):
        self.name = name
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.args = args
        self.tid = tid

    def to_json(self) -> dict:
        ev = {"name": self.name, "ph": self.ph, "ts": self.ts,
              "pid": 0, "tid": self.tid, "cat": "repro_torch"}
        if self.ph == "X":
            ev["dur"] = self.dur
        if self.args:
            ev["args"] = self.args
        return ev


class _NullSpan:
    """No-op context manager; a single module-level instance is reused so
    the disabled-tracer span path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """Nothing to add to."""


NULL_SPAN = _NullSpan()


class _Span:
    """Live span: records one complete ("X") event on exit, and mirrors
    itself as a profiler range while a ``torch.profiler`` records."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._append(TraceEvent(self._name, "X", (self._t0 - tr._epoch) * 1e6,
                              (t1 - self._t0) * 1e6, self._args))
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def set(self, **args) -> None:
        """Add arguments known only once the span's work is done."""
        self._args = {**(self._args or {}), **args}


class Tracer:
    """Span/instant/counter events into a bounded ring buffer.

    Parameters
    ----------
    capacity:
        Ring size in events; wraparound drops the oldest.
    enabled:
        ``False`` turns every record call into a no-op (``span`` returns the
        shared :data:`NULL_SPAN`, nothing is allocated or stored).
    """

    def __init__(self, capacity: int = 65536, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ring: list[TraceEvent | None] = [None] * self.capacity
        self._head = 0          # next write slot
        self._count = 0         # total events ever recorded
        self._epoch = time.perf_counter()

    # -- recording -----------------------------------------------------------

    def _append(self, ev: TraceEvent) -> None:
        self._ring[self._head] = ev
        self._head = (self._head + 1) % self.capacity
        self._count += 1

    def record(self, ev: TraceEvent) -> None:
        """Append a pre-built event (structured-event producers, e.g. the
        fleet controller's decision log, mirror into a shared tracer)."""
        if self.enabled:
            self._append(ev)

    def now_us(self) -> float:
        """Current wall-clock timestamp on this tracer's axis (µs)."""
        return (time.perf_counter() - self._epoch) * 1e6

    def span(self, name: str, **args):
        """Context manager recording a complete ("X") event on exit."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, start_s: float, dur_s: float, **args) -> None:
        """Record a complete event from caller-held wall-clock readings —
        the hot-path alternative to :meth:`span` (one call, no context
        manager).  ``start_s`` is a ``time.perf_counter`` reading."""
        if self.enabled:
            self._append(TraceEvent(name, "X", (start_s - self._epoch) * 1e6,
                                    dur_s * 1e6, args or None))

    def instant(self, name: str, ts_us: float | None = None, **args) -> None:
        """Instant event, at ``ts_us`` (simulated time) or now."""
        if self.enabled:
            ts = self.now_us() if ts_us is None else ts_us
            self._append(TraceEvent(name, "i", ts, 0.0, args or None))

    def counter(self, name: str, ts_us: float | None = None, **values) -> None:
        """Counter ("C") event — Perfetto renders these as track timelines
        (queue depth, backlog, occupancy).  Values must be numeric."""
        if self.enabled:
            ts = self.now_us() if ts_us is None else ts_us
            self._append(TraceEvent(name, "C", ts, 0.0, values))

    # -- inspection / export -------------------------------------------------

    def __len__(self) -> int:
        return min(self._count, self.capacity)

    @property
    def dropped(self) -> int:
        """Events lost to ring wraparound."""
        return max(0, self._count - self.capacity)

    def events(self) -> list[TraceEvent]:
        """Buffered events, oldest first."""
        n = len(self)
        if self._count <= self.capacity:
            return [e for e in self._ring[:n]]
        # wrapped: head points at the oldest slot
        return [self._ring[(self._head + i) % self.capacity]
                for i in range(self.capacity)]

    def clear(self) -> None:
        self._ring = [None] * self.capacity
        self._head = 0
        self._count = 0

    def to_chrome(self, *, metrics=None) -> dict:
        """Chrome trace-event JSON object format.

        ``metrics`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry` or a
        plain snapshot dict) is embedded under a top-level ``"metrics"``
        key — Perfetto ignores unknown top-level keys, so the artifact
        carries the latency-histogram snapshot next to the timeline.
        """
        out = {
            "traceEvents": sorted((e.to_json() for e in self.events()),
                                  key=lambda ev: ev["ts"]),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs", "dropped": self.dropped},
        }
        if metrics is not None:
            snap = metrics.snapshot() if hasattr(metrics, "snapshot") else metrics
            out["metrics"] = snap
        return out

    def export(self, path: str, *, metrics=None) -> str:
        """Write the Chrome trace JSON to ``path`` and return it."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(metrics=metrics), f, indent=1)
        return path


NULL_TRACER = Tracer(capacity=1, enabled=False)


# ---------------------------------------------------------------------------
# Artifact validation (CI gates the --trace output through this)
# ---------------------------------------------------------------------------

def validate_chrome_trace(obj, *, require_names=()) -> int:
    """Validate a Chrome trace artifact; returns the event count.

    ``obj``: a path, a file-like, or an already-parsed dict.  Checks the
    schema Perfetto's JSON importer relies on — a ``traceEvents`` list whose
    entries carry ``name``/``ph``/numeric ``ts``, known phase codes, and
    ``dur`` on complete events — and that every substring in
    ``require_names`` matches at least one event name.  Raises
    ``ValueError`` on any violation.
    """
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    elif isinstance(obj, io.IOBase):
        obj = json.load(obj)
    if not isinstance(obj, dict):
        raise ValueError(f"trace root must be a JSON object, got {type(obj)}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no 'traceEvents' list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("name", "ph", "ts"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing {key!r}: {ev}")
        if ev["ph"] not in _PH_KNOWN:
            raise ValueError(f"traceEvents[{i}] unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"traceEvents[{i}] non-numeric ts: {ev['ts']!r}")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}] complete event without dur")
    names = {ev["name"] for ev in events}
    for want in require_names:
        if not any(want in n for n in names):
            raise ValueError(
                f"trace has no event matching {want!r} "
                f"(saw {sorted(names)[:20]})")
    return len(events)


if __name__ == "__main__":   # CLI lives in repro_torch.obs.check
    from repro_torch.obs.check import main
    main()

"""Counters, gauges, and log-bucketed latency histograms + a registry.

The paper's headline numbers are distributional: per-decision scheduling
latency averaged over millions of decisions (9.144 ns), latency CDFs under
load (Figs 5/6).  :class:`Histogram` makes that axis reproducible in
software: log2-spaced buckets spanning **1 ns → ~1000 s**, so one histogram
covers the paper's hardware-scale decisions (ns), our jit dispatch (µs),
and end-to-end request latencies (s) without re-binning.

Everything is plain-Python and allocation-light on the hot path (one
``dict`` lookup + integer math per ``record``); the registry's
:meth:`~MetricsRegistry.snapshot` is the JSON export consumed by the
benchmark harness and embedded into Chrome trace artifacts by
``Tracer.export``.

Timing helpers (:func:`time_s`, :class:`Stopwatch`) are the single wall-
clock idiom the runtime layers share — ``runtime/overhead.py``'s measured
model and the serve engine's per-request timing are deduped onto these.
"""

from __future__ import annotations

import json
import math
import time


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (queue depth, utilization, pool size)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


# Histogram bucket i covers [HIST_MIN * 2**i, HIST_MIN * 2**(i+1)); 40 log2
# buckets span 1 ns → ~1100 s, the ns→s latency axis of the paper's CDFs.
HIST_MIN_S = 1e-9
HIST_BUCKETS = 40


class Histogram:
    """Log2-bucketed latency histogram over seconds.

    Values below ``HIST_MIN_S`` clamp into bucket 0 and values beyond the
    top edge clamp into the last bucket (count and sum stay exact either
    way).  ``record(v, n=k)`` is a weighted record — one measured duration
    standing for ``k`` identical decisions, how per-decision latency is
    derived from a batched mapping event without k distinct clock reads.
    """

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @staticmethod
    def bucket_edges() -> list[float]:
        """The HIST_BUCKETS+1 bucket edges in seconds."""
        return [HIST_MIN_S * 2.0 ** i for i in range(HIST_BUCKETS + 1)]

    @staticmethod
    def bucket_index(v: float) -> int:
        """Index of the bucket containing ``v`` (clamped at both ends).

        ``log2`` rounding at exact power-of-two edges is corrected against
        the edge values themselves, so ``edge[i] <= v < edge[i+1]`` holds
        exactly for every in-range value (property-tested).
        """
        if v <= HIST_MIN_S:
            return 0
        i = int(math.log2(v / HIST_MIN_S))
        if v < HIST_MIN_S * 2.0 ** i:
            i -= 1
        elif v >= HIST_MIN_S * 2.0 ** (i + 1):
            i += 1
        return min(max(i, 0), HIST_BUCKETS - 1)

    def record(self, v: float, n: int = 1) -> None:
        self.buckets[self.bucket_index(v)] += n
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Approximate percentile (0..100) by log-interpolating inside the
        covering bucket, clamped to the observed [min, max] (interpolation
        alone could overshoot a bucket's true extreme values)."""
        if self.count == 0:
            return math.nan
        target = self.count * q / 100.0
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= target:
                lo = HIST_MIN_S * 2.0 ** i
                frac = (target - cum) / c
                est = lo * 2.0 ** frac           # log-linear within bucket
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "count": self.count,
            "sum_s": self.sum,
            "mean_s": (self.sum / self.count) if self.count else math.nan,
            "min_s": self.min if self.count else math.nan,
            "max_s": self.max if self.count else math.nan,
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
            "buckets": {str(i): c for i, c in enumerate(self.buckets) if c},
        }


def _fullname(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Name+labels → metric, with get-or-create accessors and JSON export.

    Labels are part of the metric identity (``fabric.map_batch_s{backend=
    jit,bucket=64}``), so one registry holds the whole per-backend /
    per-bucket breakdown the Fig. 4 latency-vs-queue analysis needs.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _fullname(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls()
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {key!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def snapshot(self) -> dict:
        """JSON-able view: scalars for counters/gauges, the bucket snapshot
        for histograms, sorted by metric name."""
        out = {}
        for key in sorted(self._metrics):
            m = self._metrics[key]
            out[key] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out

    def export_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


# ---------------------------------------------------------------------------
# Shared timing idiom
# ---------------------------------------------------------------------------

def time_s(fn, *args, **kw):
    """Call ``fn`` and return ``(result, elapsed_seconds)`` — the one
    wall-clock measurement helper the runtime layers share."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


class Stopwatch:
    """Context manager: ``elapsed_s`` on exit, optionally recorded into a
    :class:`Histogram` (``n`` weights the record, e.g. decisions/batch)."""

    __slots__ = ("histogram", "n", "elapsed_s", "start_s")

    def __init__(self, histogram: Histogram | None = None, n: int = 1):
        self.histogram = histogram
        self.n = n
        self.elapsed_s = 0.0
        self.start_s = 0.0

    def __enter__(self):
        self.start_s = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self.start_s
        if self.histogram is not None:
            self.histogram.record(self.elapsed_s / max(self.n, 1), n=self.n)
        return False

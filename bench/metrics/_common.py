"""Shared pieces of the metric readers: the window's samples, by name."""

from __future__ import annotations

from bench import stats


def window(run) -> tuple[float, float]:
    return run.window_start, run.window_end


def span_ms(run, name: str, keep=lambda args: True) -> list[float]:
    """Durations (ms) of the program's ``name`` spans that ended inside the
    window."""
    s, e = window(run)
    return [d * 1e3 for t0, d, args in run.spans.get(name, [])
            if stats.in_window(t0 + d, s, e) and keep(args)]


def admit_ms(run) -> list[float]:
    """Durations (ms) of the program's ``engine.admit`` spans of the
    admissions that took a request (a refused one, the pool full, returns
    at once), ended inside the window: the spans zipped with the harness's
    record of each call, one a call in the same order."""
    spans = run.spans.get("engine.admit", [])
    if len(spans) != len(run.admit_calls):
        raise RuntimeError(f"{len(spans)} admit spans for "
                           f"{len(run.admit_calls)} calls")
    s, e = window(run)
    return [d * 1e3 for (t0, d, _), ok in zip(spans, run.admit_calls)
            if ok and stats.in_window(t0 + d, s, e)]


def ticks_with_spans(run) -> list[tuple]:
    """Each tick of the window that produced tokens, as (tokens, keys
    attended, span seconds): the harness's tick records zipped with the
    program's ``engine.decode_tick`` spans, one a call in the same order."""
    spans = run.spans.get("engine.decode_tick", [])
    if len(spans) != len(run.ticks):
        raise RuntimeError(f"{len(spans)} decode_tick spans for "
                           f"{len(run.ticks)} ticks")
    s, e = window(run)
    return [(n, keys, d) for (_, _, t1, n, keys), (_, d, _)
            in zip(run.ticks, spans) if n > 0 and stats.in_window(t1, s, e)]

"""Median, over the window's decode ticks with active lanes, of the
program's ``engine.decode_tick`` span less its ``tick.wait`` child (ms):
the host's time to issue a tick (inputs, gather, decode step, scatter, the
in-tick decision, the bookkeeping), without its wait on the device at the
tick's one device-to-host copy.  Beside ``tick_ms`` it says whether a tick
waits on the host or on the device.

Also the readers' shared pieces for the spans inside the program's served
loop: whether the trace is whole, and a span's children by time."""

import bisect

from bench import stats
from bench.metrics._common import window


def whole(run) -> bool:
    """The timed call's trace lost nothing that ended in the window.  The
    tracer's ring drops its oldest events first, and every span that ends
    in the window was recorded after iteration 0's ``frontend.iteration``
    span: so the iterations' spans, numbered from 0 without a gap, show
    that it dropped none of them.  False where the program records no such
    span."""
    its = [a.get("it") for _, _, a in run.spans.get("frontend.iteration", [])]
    return bool(its) and its == list(range(len(its)))


def in_window(spans, run, keep=lambda args: True) -> list:
    """The spans (host start, seconds, args) that ended in the window."""
    s, e = window(run)
    return [sp for sp in spans
            if stats.in_window(sp[0] + sp[1], s, e) and keep(sp[2])]


def children(run, parents, names) -> list[list]:
    """For each parent span, the spans named in ``names`` that start inside
    it, as (host start, seconds, args, name) in order of start."""
    kids = sorted(((*sp, n) for n in names for sp in run.spans.get(n, [])),
                  key=lambda k: k[0])
    starts = [k[0] for k in kids]
    return [kids[bisect.bisect_left(starts, t0):
                 bisect.bisect_right(starts, t0 + d)]
            for t0, d, _ in parents]


def issue_ms(parent, kids, wait: str) -> float | None:
    """A span's milliseconds less those of its one ``wait`` child; None
    where that child is missing."""
    waits = [k[1] for k in kids if k[3] == wait]
    if len(waits) != 1:
        return None
    return (parent[1] - waits[0]) * 1e3


def read(run):
    if not whole(run):
        return None
    ticks = in_window(run.spans.get("engine.decode_tick", []), run,
                      lambda a: a.get("active", 0) > 0)
    out = [issue_ms(t, kids, "tick.wait")
           for t, kids in zip(ticks, children(run, ticks, ["tick.wait"]))]
    if None in out:
        return None
    return stats.percentile(out, 50)

"""Median of the program's ``engine.decode_tick`` spans with active lanes,
inside the window (ms): gather, decode step, scatter, argmax, the in-tick
decision, one device-to-host copy."""

from bench import stats
from bench.metrics._common import span_ms


def read(run):
    return stats.percentile(
        span_ms(run, "engine.decode_tick", lambda a: a.get("active", 0) > 0),
        50)

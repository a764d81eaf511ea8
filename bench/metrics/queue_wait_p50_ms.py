"""Median of the program's ``request.queue`` records of the requests
admitted in the window (ms): from the start of the loop iteration at which
a request became visible to the start of the ``admit`` call that took it.
A request's first token is this wait plus its ``engine.admit``."""

from bench import stats
from bench.metrics._common import span_ms
from bench.metrics.tick_issue_ms import whole


def read(run):
    if not whole(run):
        return None
    return stats.percentile(span_ms(run, "request.queue"), 50)

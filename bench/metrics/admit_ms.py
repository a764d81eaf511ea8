"""Median of the program's ``engine.admit`` spans of the admissions that
took a request, inside the window (ms): a prefill and the pool write.  An
admission runs inside an iteration, so it lengthens the gap of every lane
that iteration."""

from bench import stats
from bench.metrics._common import admit_ms


def read(run):
    return stats.percentile(admit_ms(run), 50)

"""Exact percentiles and rates over a run's host-clock readings.

Every percentile is taken over all the samples of the window at once
(numpy's linear interpolation between order statistics), never from
summaries of pieces, and never from a log-bucketed histogram.
"""

from __future__ import annotations

import numpy as np


def percentile(samples, q: float) -> float | None:
    """The q-th percentile (0-100) of the samples; None without any."""
    a = np.asarray(list(samples), dtype=np.float64)
    if a.size == 0:
        return None
    return float(np.percentile(a, q))


def in_window(t: float, start: float, end: float) -> bool:
    return start < t <= end


def tokens_in_window(token_times: dict, start: float, end: float) -> int:
    """Tokens whose host time falls in (start, end]; ``token_times`` maps a
    request to its [(time, token)] in order."""
    return sum(in_window(t, start, end)
               for seq in token_times.values() for t, _ in seq)


def token_gaps(token_times: dict, start: float, end: float) -> list[float]:
    """Seconds between successive tokens of one request, for every gap
    that ends in (start, end], over all requests."""
    gaps = []
    for seq in token_times.values():
        for (a, _), (b, _) in zip(seq, seq[1:]):
            if in_window(b, start, end):
                gaps.append(b - a)
    return gaps


def rate(count: int, start: float, end: float) -> float:
    return count / (end - start)

"""95th percentile of the gaps between successive tokens of one request,
over every request's gaps that end inside the window (ms)."""

from bench import stats


def read(run):
    p = stats.percentile(stats.token_gaps(run.token_times, run.window_start,
                                          run.window_end), 95)
    return None if p is None else p * 1e3

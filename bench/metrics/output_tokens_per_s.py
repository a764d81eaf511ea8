"""Every token generated inside the window (first tokens from admissions,
then one a lane a decode tick), over the window's seconds."""

from bench import stats


def read(run):
    s, e = run.window_start, run.window_end
    return stats.rate(stats.tokens_in_window(run.token_times, s, e), s, e)

"""Median, over the window's admissions that took a request, of the
program's ``engine.admit`` span less its ``admit.wait`` child (ms): the
host's time to issue the prefill and the pool write, without its wait on
the device for the first token's copy.  A refused admission (the pool
full) returns before any of its phases, so it has none of them."""

from bench import stats
from bench.metrics.tick_issue_ms import children, in_window, issue_ms, whole

PHASES = ("admit.prefill", "admit.write", "admit.wait")


def read(run):
    if not whole(run):
        return None
    admits = in_window(run.spans.get("engine.admit", []), run)
    out = []
    for adm, kids in zip(admits, children(run, admits, PHASES)):
        if not kids:
            continue
        if sorted(k[3] for k in kids) != sorted(PHASES):
            return None
        out.append(issue_ms(adm, kids, "admit.wait"))
    return stats.percentile(out, 50)

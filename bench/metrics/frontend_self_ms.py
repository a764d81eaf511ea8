"""Median, over the window's iterations of the front end's loop, of the
program's ``frontend.iteration`` span less the time its ``engine.admit``,
``engine.decode_tick`` and ``engine.retire`` children cover (ms): the front
end's own Python an iteration (arrivals, queues, the mapping event's
staging and adoption).  Each iteration's span names how many admissions
and retires it ran, so a child lost from the trace shows."""

from bench import stats
from bench.metrics.tick_issue_ms import children, in_window, whole

CALLS = ("engine.admit", "engine.decode_tick", "engine.retire")


def read(run):
    if not whole(run):
        return None
    iters = in_window(run.spans.get("frontend.iteration", []), run)
    out = []
    for (_, d, args), kids in zip(iters, children(run, iters, CALLS)):
        names = [k[3] for k in kids]
        if (names.count("engine.admit") != args["admitted"] + args["refused"]
                or names.count("engine.retire") != args["retired"]
                or "engine.decode_tick" not in names):
            return None
        out.append((d - sum(k[1] for k in kids)) * 1e3)
    return stats.percentile(out, 50)

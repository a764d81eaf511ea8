"""The host's time a HEFT_RT decision on the served path (us): the summed
``map.*`` spans of the mapping events that completed in the window, over
the requests those events mapped.  An event's spans share its ``event``
number: ``map.stage`` (the Exec_TID estimates, with ``n``, the event's
requests) and ``map.adopt`` in the front end, and between them either
``map.inputs`` (twice: staging, upload), ``map.launch`` and ``map.commit``
inside the carrier's decode tick, or ``map.event``, the host path on a cold
or idle fleet.  The paper's per-decision scheduling latency, as the
program pays it on the host."""

from collections import defaultdict

from bench import stats
from bench.metrics._common import window
from bench.metrics.tick_issue_ms import whole

IN_TICK = ["map.adopt", "map.commit", "map.inputs", "map.inputs",
           "map.launch", "map.stage"]
ON_HOST = ["map.adopt", "map.event", "map.stage"]
NAMES = sorted(set(IN_TICK + ON_HOST))


def read(run):
    if not whole(run):
        return None
    events = defaultdict(list)
    for name in NAMES:
        for t0, d, args in run.spans.get(name, []):
            events[args.get("event")].append((t0, d, args, name))
    s, e = window(run)
    host_s, requests = 0.0, 0
    for spans in events.values():
        if not stats.in_window(max(t0 + d for t0, d, _, _ in spans), s, e):
            continue
        if sorted(sp[3] for sp in spans) not in (IN_TICK, ON_HOST):
            return None
        host_s += sum(sp[1] for sp in spans)
        requests += next(a["n"] for _, _, a, n in spans if n == "map.stage")
    if not requests:
        return None
    return host_s / requests * 1e6

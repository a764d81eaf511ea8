"""The readers of the spans inside the program's served loop, on a traced
smoke cell on the CPU: each reads a value, a tick's or an admission's host
issue is no longer than the whole call, and the program's own
``request.queue`` records agree with the harness's reading from outside."""

import time

import pytest
import torch

from bench import harness, result
from bench.tests.smoke import cell, references

SECONDS = 2.0
NEW = ("tick_issue_ms", "admit_issue_ms", "queue_wait_p50_ms",
       "frontend_self_ms", "decision_host_us")


@pytest.mark.parametrize("reference", references())
def test_program_span_readers_on_a_traced_smoke_cell(reference):
    torch.set_num_threads(1)
    run, _ = harness.execute(cell(reference, trace=True), 2 ** 31 + 11,
                             SECONDS, True, "cpu", time.perf_counter())
    m = result.metrics_of(run)
    for name in NEW:
        assert m[name]["value"] > 0, name
    assert m["decision_host_us"]["unit"] == "us"
    assert m["tick_issue_ms"]["value"] <= m["tick_ms"]["value"]
    assert m["admit_issue_ms"]["value"] <= m["admit_ms"]["value"]

    # each request's queue wait: the program's record against the harness's
    # reading, from the start of its arrival iteration (the end of the one
    # before) to the wrapped admit's start
    waits = {a["req"]: d for _, d, a in run.spans["request.queue"]}
    assert len(waits) == len(run.admits)
    checked = 0
    for req, _, t0, _, _ in run.admits:
        k = run.arrival_ticks[req]
        if k == 0:
            continue       # iteration 0's start is not the harness's
        outside = t0 - run.iter_end[k - 1]
        assert abs(waits[req] - outside) <= 2e-3, (req, waits[req], outside)
        checked += 1
    assert checked >= 10

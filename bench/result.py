"""A run's result line: its metrics, its device, and the comparison that
decides ``correct``, each number compared beside its limit."""

from __future__ import annotations

import gc

import torch

from bench import check, harness
from bench.spec import metric_reader


def metrics_of(run) -> dict:
    """Every metric of the run's list whose reader found something."""
    out = {}
    for m in run.spec.metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(spec, seed: int, seconds: float, trace: bool, device: str,
            t_process: float) -> dict:
    run, weights = harness.execute(spec, seed, seconds, trace, device,
                                   t_process)
    metrics = metrics_of(run)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    limits = spec.cell["limits"]
    gap = check.logit_gap(run, weights, device)
    dec = check.decisions_differing(run)
    harness.log(run, "reference checked")
    checks = {
        "logit_gap": {"value": gap["value"], "limit": limits["logit_gap"]},
        "decisions_differing": {"value": dec["value"],
                                "limit": limits["decisions_differing"]},
    }
    over = [r for r, g in gap.get("per_request", {}).items()
            if g > limits["logit_gap"]]
    correct = (gap["value"] is not None and not over
               and dec["decisions"] > 0
               and dec["value"] <= limits["decisions_differing"])
    s, e = run.window_start, run.window_end
    attempted = sum(s < t1 <= e for _, _, _, t1, _ in run.admits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": device, "count": spec.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": len(over) + dec["value"], "metrics": metrics,
            "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    if dec["first"] is not None:
        line["first_differing_decision"] = dec["first"]
    line["checked"] = {"requests": gap["requests"], "tokens": gap["tokens"],
                       "decisions": dec["decisions"]}
    line["checks"] = checks
    return line

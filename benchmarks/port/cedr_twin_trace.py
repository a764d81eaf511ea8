#!/usr/bin/env python3
"""Where the CEDR twin's time goes on the card.

    python3 benchmarks/port/cedr_twin_trace.py [--out FILE]

Runs the port's CEDR runtime twin (the paper's 3x A53 + FFT SoC, the
oversubscribed high-latency workload at 600 frames/s, as ``chip_smoke.py``
does) with its mapping events on the card through
``make_dispatch_fabric("cuda")``: once to warm up, once
timed, once under ``torch.profiler`` (CPU and CUDA activities).  Prints the
timed run's wall time per mapping event, the device time by kernel name
from the trace, the device's busy and idle share of the traced run's wall
time, and the host ops that take the most time, then one JSON line.  Fails
without a card, or if the trace holds no device activity.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

RATE = 600.0        # frames/s: the Fig. 6 regime whose queues reach 223
BACKEND = "cuda"    # the fused kernel, the fabric's default on the card


def run_twin():
    from repro_torch.runtime import (CedrSimulator, high_latency_arrivals,
                                     make_dispatch_fabric,
                                     paper_soc_pe_types)
    sim = CedrSimulator(paper_soc_pe_types(),
                        dispatch=make_dispatch_fabric(BACKEND), seed=7)
    return sim.run(high_latency_arrivals(RATE, seed=1))


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the summary to FILE (JSON)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("cedr_twin_trace: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    import repro_torch.kernels as K
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    K.build_kernels()
    run_twin()  # warm-up

    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_twin()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = len(res.mapping_events)
    launches = K.launch_counts()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_twin()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0

    device = defaultdict(float)
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.end - ev.time_range.start
            device[ev.name] += dur
            intervals.append((ev.time_range.start, ev.time_range.end))
    if not intervals:
        print("cedr_twin_trace: the trace holds no device activity",
              file=sys.stderr)
        return 1
    busy = busy_us(intervals) / 1e6
    host = sorted(((e.key, e.self_cpu_time_total) for e in
                   prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])[:12]

    print(f"[card] {card} | torch {torch.__version__}")
    print(f"[twin] backend={BACKEND} rate={RATE} frames/s: "
          f"{events} mapping events, max queue {res.max_queue_size}, wall "
          f"{wall:.6f} s = {wall / events * 1e6:.3f} us/event, launches "
          f"{launches}")
    print(f"[trace] traced wall {traced_wall:.6f} s, device busy "
          f"{busy:.6f} s, idle share {1 - busy / traced_wall:.6f}")
    for name, us in sorted(device.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[device] {us / 1e3:12.3f} ms  {name[:100]}")
    for name, us in host:
        print(f"[host]   {us / 1e3:12.3f} ms  {name[:100]}")
    summary = {
        "card": card, "backend": BACKEND, "rate": RATE,
        "mapping_events": events, "max_queue": res.max_queue_size,
        "wall_s": wall, "us_per_event": wall / events * 1e6,
        "launches": launches, "traced_wall_s": traced_wall,
        "device_busy_s": busy, "idle_share": 1 - busy / traced_wall,
        "device_ms_by_name": {k: v / 1e3 for k, v in device.items()},
        "host_ms_top": {k: v / 1e3 for k, v in host},
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in (
        "card", "backend", "mapping_events", "wall_s", "us_per_event",
        "device_busy_s", "idle_share")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

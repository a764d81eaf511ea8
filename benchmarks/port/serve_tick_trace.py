#!/usr/bin/env python3
"""Where a paged decode tick's time goes on the card, at full width.

    python3 benchmarks/port/serve_tick_trace.py [--arch A] [--out FILE] [--seed N]

Builds ``--arch`` (default deepseek-7b; falcon-mamba-7b is the other one
``chip_smoke.py`` serves whole) at its published widths and depth (bf16,
random weights from a seeded generator, as ``chip_smoke.py``'s serve phases
do), one ``ServeEngine`` with four decode lanes and a paged pool, and admits
four requests of 32 prompt tokens.  Then it times ten plain decode ticks with
CUDA events and traces five more under ``torch.profiler`` (CPU and CUDA
activities).  Prints the tick's wall time, the device's busy time and idle
share per tick, the device kernels and host ops per tick, the device time
by kernel name and the host ops that take the most time, then one JSON
line.  Fails without a card, or if the trace holds no device activity.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

LANES, PROMPT, NEW_TOKENS = 4, 32, 64
TIMED, TRACED = 10, 5


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="deepseek_7b")
    args = ap.parse_args()
    arch = args.arch

    import torch
    if not torch.cuda.is_available():
        print("serve_tick_trace: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(arch)
    params = init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    eng = ServeEngine(cfg, params, max_len=128, lanes=LANES)
    eng.start_paged(max_batch=LANES, page_size=16)
    rng = np.random.default_rng(args.seed)
    for _ in range(LANES):
        prompt = rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
        if eng.admit(prompt, NEW_TOKENS) is None:
            raise RuntimeError("admit refused")
    for _ in range(3):
        eng.decode_tick()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED):
        eng.decode_tick()
    end.record()
    torch.cuda.synchronize()
    tick_ms = start.elapsed_time(end) / TIMED

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            eng.decode_tick()
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
        print("serve_tick_trace: the trace holds no device activity",
              file=sys.stderr)
        return 1
    busy = busy_us(intervals) / 1e6
    top_level = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name.startswith("aten::") and e.cpu_parent is None]
    host = sorted(((e.key, e.self_cpu_time_total) for e in
                   prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])[:12]

    per_tick = {
        "wall_ms": traced_wall / TRACED * 1e3,
        "device_busy_ms": busy / TRACED * 1e3,
        "device_kernels": len(intervals) / TRACED,
        "host_aten_ops": len(top_level) / TRACED,
    }
    print(f"[card] {card} | torch {torch.__version__}")
    print(f"[tick] {arch} {cfg.num_layers} layers, {LANES} lanes: "
          f"{tick_ms:.6f} ms a plain tick (CUDA events, {TIMED} ticks); "
          f"traced {per_tick['wall_ms']:.6f} ms, device busy "
          f"{per_tick['device_busy_ms']:.6f} ms (idle share "
          f"{1 - busy / traced_wall:.6f}), {per_tick['device_kernels']} "
          f"device kernels and {per_tick['host_aten_ops']} top-level aten "
          f"ops a tick")
    for name, us in sorted(device.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[device] {us / TRACED / 1e3:10.4f} ms/tick  {name[:100]}")
    for name, us in host:
        print(f"[host]   {us / TRACED / 1e3:10.4f} ms/tick  {name[:100]}")
    summary = {
        "card": card, "arch": arch, "lanes": LANES, "tick_ms": tick_ms,
        "traced_wall_s": traced_wall, "device_busy_s": busy,
        "idle_share": 1 - busy / traced_wall, "per_tick": per_tick,
        "device_ms_per_tick_by_name": {k: v / TRACED / 1e3
                                       for k, v in device.items()},
        "host_ms_per_tick_top": {k: v / TRACED / 1e3 for k, v in host},
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in (
        "card", "arch", "lanes", "tick_ms", "idle_share", "per_tick")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a paged decode tick's time goes on the card, at full width.

    python3 benchmarks/port/serve_tick_trace.py [--arch A] [--mesh] [--out FILE] [--seed N]
        [--lanes N] [--max-len N] [--prompt N]

Builds ``--arch`` (default deepseek-7b; falcon-mamba-7b is the other one
``chip_smoke.py`` serves whole) at its published widths and depth (bf16,
random weights from a seeded generator, as ``chip_smoke.py``'s serve phases
do), one ``ServeEngine`` with ``--lanes`` decode lanes (default 4) of
``--max-len`` slots (default 128) and a paged pool, and admits one request
of ``--prompt`` tokens (default 32) a lane.  Then it times ticks with CUDA
events, eager and graphed in turns (eager, graphed, graphed, eager; ten
ticks each), beside ``chip_smoke.tick_bound``, and traces five of each
under ``torch.profiler`` (CPU and CUDA activities).  Prints each kind's
wall time, the device's busy time and idle share per tick, the device
kernels and host ops per tick, the device time by kernel name and the host
ops that take the most time (of the graphed ticks), the peak memory
allocated and reserved, then one JSON line.  Fails without a card, or if
the trace holds no device activity.

``--mesh`` backs the engine with a ``(1, 1)`` mesh slice (an ``nccl``
world of this one process): the replica's parameters, pools and steps are
``DTensor``s under its hint policy, so the trace shows what DTensor
dispatch adds to the tick; the DTensor redistributions a tick (calls of
``redistribute_local_tensor``) are counted and printed too.  A meshed
tick is never graphed: both kinds are then the eager tick.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

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
    ap.add_argument("--mesh", action="store_true",
                    help="a (1, 1) mesh-backed engine (DTensor steps)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt", type=int, default=32)
    args = ap.parse_args()
    arch = args.arch
    lanes = args.lanes

    import torch
    if not torch.cuda.is_available():
        print("serve_tick_trace: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(root))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import counted_redistributions, tick_bound

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
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import init_world, make_debug_mesh
        init_world("nccl", device="cuda")
        mesh = make_debug_mesh((1, 1), device="cuda")
    eng = ServeEngine(cfg, params, max_len=args.max_len, lanes=lanes,
                      mesh=mesh)
    rt = eng.start_paged(max_batch=lanes, page_size=16)
    graphable = rt._graphed
    rng = np.random.default_rng(args.seed)
    for _ in range(lanes):
        prompt = rng.integers(0, cfg.vocab_size, args.prompt).astype(np.int32)
        if eng.admit(prompt, args.max_len - args.prompt) is None:
            raise RuntimeError("admit refused")
    torch.cuda.reset_peak_memory_stats()
    for graphed in (False, True, True):
        rt._graphed = graphed and graphable
        eng.decode_tick()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = {False: [], True: []}
    kv_tokens = []
    for graphed in (False, True, True, False):
        rt._graphed = graphed and graphable
        kv_tokens.append(sum(rt.slots[s].write_pos + 1
                             for s in rt.active_slots()))
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMED):
            eng.decode_tick()
        end.record()
        torch.cuda.synchronize()
        times[graphed].append(start.elapsed_time(end) / TIMED)
    eager_ms, graph_ms = (sum(times[k]) / 2 for k in (False, True))
    # the positions advance by one a tick: the mean over the timed ticks
    kv_mean = sum(kv_tokens) / len(kv_tokens) + lanes * (TIMED - 1) / 2
    per_token = cfg.param_count() - cfg.vocab_size * cfg.d_model + \
        lanes * cfg.d_model
    bound_ms, bound_by = tick_bound(cfg, per_token, kv_mean, lanes)

    per_kind = {}
    for graphed in (False, True):
        rt._graphed = graphed and graphable
        counting = (counted_redistributions() if args.mesh
                    else contextlib.nullcontext([0]))
        with counting as redist, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACED):
                eng.decode_tick()
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        per_kind[graphed] = (prof, traced_wall, redist[0])
    memory = {"max_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
              "max_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}

    per_tick = {}
    for graphed, (prof, traced_wall, redist) in per_kind.items():
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
        per_tick["graph" if graphed else "eager"] = {
            "wall_ms": traced_wall / TRACED * 1e3,
            "device_busy_ms": busy / TRACED * 1e3,
            "idle_share": 1 - busy / traced_wall,
            "device_kernels": len(intervals) / TRACED,
            "host_aten_ops": len(top_level) / TRACED,
            "dtensor_redistributions": redist / TRACED,
        }
    host = sorted(((e.key, e.self_cpu_time_total) for e in
                   prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])[:12]

    print(f"[card] {card} | torch {torch.__version__}")
    print(f"[tick] {arch} {cfg.num_layers} layers, {lanes} lanes of "
          f"{args.max_len} slots{', (1, 1) mesh' if args.mesh else ''}: "
          f"eager {eager_ms:.6f} ms, graphed {graph_ms:.6f} ms a tick (CUDA "
          f"events, {TIMED} ticks, eager {times[False]}, graphed "
          f"{times[True]}); bound {bound_ms:.6f} ms ({bound_by}, "
          f"{kv_mean:.1f} keys); peak {memory['max_allocated_gib']:.3f} GiB "
          f"allocated, {memory['max_reserved_gib']:.3f} GiB reserved")
    for kind, t in per_tick.items():
        print(f"[{kind}] traced {t['wall_ms']:.6f} ms, device busy "
              f"{t['device_busy_ms']:.6f} ms (idle share "
              f"{t['idle_share']:.6f}), {t['device_kernels']} device kernels "
              f"and {t['host_aten_ops']} top-level aten ops a tick, "
              f"{t['dtensor_redistributions']} DTensor redistributions a "
              f"tick")
    for name, us in sorted(device.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[device] {us / TRACED / 1e3:10.4f} ms/tick  {name[:100]}")
    for name, us in host:
        print(f"[host]   {us / TRACED / 1e3:10.4f} ms/tick  {name[:100]}")
    summary = {
        "card": card, "arch": arch, "mesh": args.mesh, "lanes": lanes,
        "max_len": args.max_len, "graphed": graphable,
        "tick_ms": graph_ms, "eager_tick_ms": eager_ms,
        "tick_ms_blocks": {"eager": times[False], "graph": times[True]},
        "bound_ms": bound_ms, "bound_by": bound_by, "kv_tokens_mean": kv_mean,
        "memory": memory, "per_tick": per_tick,
        "device_ms_per_tick_by_name": {k: v / TRACED / 1e3
                                       for k, v in device.items()},
        "host_ms_per_tick_top": {k: v / TRACED / 1e3 for k, v in host},
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in (
        "card", "arch", "mesh", "lanes", "max_len", "tick_ms",
        "eager_tick_ms", "bound_ms", "memory", "per_tick")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

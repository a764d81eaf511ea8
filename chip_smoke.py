#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--seed N]

Builds the port's four CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
one process per source, all at once), then runs five phases and fails on the
first disagreement:

* kernels — each kernel against its plain PyTorch version, run on CPU copies
  of the same inputs, bitwise: B = 256 events, D in {5, 1330, 2048}, P in
  {4, 8, 40}, plus edge cases (duplicate keys, all-inf rows, NaN and -inf
  keys, subnormal registers and exec times, the sort's scratch path up to
  the fabric's largest bucket, masks all-False and partial);
* fabric — ``MappingFabric(4)`` with the ``cuda`` and ``fused`` backends on
  the card against the same backends on the CPU (their plain versions):
  resident-register event streams with queues up to 1330 slots,
  ``map_batch`` at B = 256, resizes, PE masks and counter drains
  interleaved;
* runtime — the CEDR twin (``CedrSimulator`` on the paper's 3x A53 + FFT
  SoC, the oversubscribed high-latency workload at 600 frames/s, cut to
  five instances each of PD and TX to keep the run's time) with
  ``make_dispatch_fabric("cuda")`` and ``("fused")`` on the card, against
  the same run on the CPU plain path: identical ``SimResult``;
* queue — the priority queue (``kernels.oddeven_sort``) and the EFT
  selector (``kernels.eft_select``) against their plain versions, bitwise:
  sorts of B = 256 rows at D in {5, 1330, 2048, 65536} with f32, bf16 and
  i32 keys (duplicates, NaN, -inf, +-0.0, a band around 2**24), drains at
  the same D with P in {4, 8, 40, 1024} (all-inf rows, subnormal
  registers; B shrinks as D * P grows); then the two-phase event, sort ->
  gather -> select, through the public entry points at B = 256, P = 4,
  equal to ``heft_fused`` on the card;
* serving — ``simulate_serving`` over ``default_fleet()`` at 1600 requests/s
  for 3 s (the ``bench_serve_scheduler`` cell), with a replica-loss and
  straggler timeline, and over ``mesh_fleet()`` with a split / grow / merge
  timeline, each with ``make_policy_fabric("cuda")`` and ``("fused")`` on
  the card, against the same run with the float32 plain path (``torch`` on
  the CPU): identical ``ServeResult``.

The fabric, runtime, queue-event and serving runs are the main path: the
kernels' launch counters are zeroed just before each and read just after,
and each kernel must have launched on its path.  Then each kernel is timed
with CUDA events at the fabric-batched shape (B = 256, D = 2048, P = 4)
beside its plain version, its bound and, for the sort, ``torch.sort``.  The
last two lines are the ``kernels`` JSON record and ``{"ok": true,
"device": {...}}``.  Exits non-zero without a card, without the port's
sources next to it, or on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TIMED_SHAPE = (256, 2048, 4)  # B, D, P of the fabric-batched pipeline


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors (float lanes compared as integers of
    their width)."""
    import torch
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over lanes finite in both (0.0 when bitwise equal)."""
    import torch
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare_results(got, want, what: str) -> float:
    """Field by field, bitwise; returns the max abs error (0.0)."""
    err = 0.0
    for name, g, w in zip(got._fields, got, want):
        require(bits_equal(g, w), f"{what}: {name} differs from the plain "
                                  f"version")
        err = max(err, max_abs_err(g, w))
    return err


# ---------------------------------------------------------------------------
# phase: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_event(rng, B, D, P, *, kind="ints"):
    """Seeded inputs (f32): keys (B, D), exec (B, D, P), avail (B, P)."""
    keys = rng.integers(0, max(2, D // 4), (B, D)).astype(np.float32)
    ex = rng.integers(1, 64, (B, D, P)).astype(np.float32)
    ex[rng.random((B, D, P)) < 0.1] = np.inf          # unsupported pairs
    ex[rng.random((B, D)) < 0.05] = np.inf            # all-inf rows
    avail = rng.integers(0, 32, (B, P)).astype(np.float32)
    if kind == "special":
        r = rng.random((B, D))
        keys[r < 0.05] = np.nan
        keys[(r >= 0.05) & (r < 0.1)] = -np.inf
        keys[(r >= 0.1) & (r < 0.12)] = -0.0
        keys[(r >= 0.12) & (r < 0.14)] = np.inf
    if kind == "subnormal":
        tiny = np.float32(1e-45)                       # smallest subnormal
        ex = np.where(np.isfinite(ex), ex * tiny, ex).astype(np.float32)
        avail = (avail * tiny).astype(np.float32)
        keys = (keys * tiny).astype(np.float32)
    return keys, ex, avail


def phase_kernels(torch, seed: int) -> dict:
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf
    from repro_torch.kernels.ref import heft_fused_ref
    from repro_torch.core.heft_rt import ScheduleResult

    rng = np.random.default_rng(seed)
    cases = [(256, D, P, "ints") for D in (5, 1330, 2048) for P in (4, 8, 40)]
    cases += [(64, 300, 4, "special"), (64, 300, 40, "subnormal"),
              (4, 8192, 4, "ints"), (1, 65536, 4, "ints")]
    errs = {"heft_fused": 0.0, "fused_decision": 0.0}
    for B, D, P, kind in cases:
        keys, ex, av = make_event(rng, B, D, P, kind=kind)
        cpu = [torch.from_numpy(x) for x in (keys, ex, av)]
        dev = [t.cuda() for t in cpu]
        masks = [np.zeros(P, bool), rng.random(P) < 0.4]
        want = ScheduleResult(*heft_fused_ref(*cpu))
        got = hf.heft_fused(*dev)
        torch.cuda.synchronize()
        what = f"heft_fused B={B} D={D} P={P} {kind}"
        errs["heft_fused"] = max(errs["heft_fused"],
                                 compare_results(got, want, what))
        # in place into the input registers, as the fabric runs it
        av_dev = dev[2].clone()
        got_inplace = hf.heft_fused(dev[0], dev[1], av_dev, out_avail=av_dev)
        require(bits_equal(got_inplace.new_avail, want.new_avail),
                f"{what}: in-place new_avail differs")
        for m in masks:
            m_cpu = torch.from_numpy(m)
            want_d = fd.decision_ref(*cpu, None, m_cpu)
            got_d = fd.fused_decision(*dev, m_cpu.cuda())
            torch.cuda.synchronize()
            what = (f"fused_decision B={B} D={D} P={P} {kind} "
                    f"mask={int(m.sum())}/{P}")
            errs["fused_decision"] = max(errs["fused_decision"],
                                         compare_results(got_d, want_d, what))
            if not m.any():   # all-False mask == the unmasked kernel
                compare_results(got_d, got, what + " vs heft_fused")
        log(f"[kernels] B={B} D={D} P={P} {kind}: bitwise equal")
    return errs


# ---------------------------------------------------------------------------
# phase: the fabric (main path, part 1)
# ---------------------------------------------------------------------------

def fabric_event(rng, n, p):
    avg = rng.integers(0, 50, n).astype(np.float32)
    avg[rng.random(n) < 0.03] = np.nan
    ex = rng.integers(1, 64, (n, p)).astype(np.float32)
    ex[rng.random((n, p)) < 0.1] = np.inf
    ex[rng.random(n) < 0.05] = np.inf
    return avg, ex


def phase_fabric(torch, seed: int) -> None:
    from repro_torch.sched_integration import MappingFabric

    for backend, kw in (("cuda", {}), ("fused", {"device_counters": True})):
        rng = np.random.default_rng(seed)
        dev = MappingFabric(4, backend=backend, device="cuda", **kw)
        ref = MappingFabric(4, backend=backend, device="cpu", **kw)
        require(dev.backend_effective == backend,
                f"{backend} fabric runs {dev.backend_effective}")
        queue_lengths = [1330, 1, 7, 200, 1024, 1025, 513, 64, 999, 3]
        for step, n in enumerate(queue_lengths):
            avg, ex = fabric_event(rng, n, dev.num_pes)
            outs = [f.map_event(avg, ex) for f in (dev, ref)]
            for g, w in zip(*outs):
                require(np.array_equal(np.asarray(g).view(np.int32),
                                       np.asarray(w).view(np.int32)),
                        f"{backend} map_event n={n} differs")
            require(np.array_equal(dev.avail, ref.avail),
                    f"{backend} resident registers differ after n={n}")
            # explicit registers leave the resident ones alone
            explicit = rng.integers(0, 16, dev.num_pes).astype(np.float32)
            before = dev.avail.copy()
            g = dev.map_event(avg, ex, explicit, update=False)
            w = ref.map_event(avg, ex, explicit, update=False)
            require(all(np.array_equal(a, b) for a, b in zip(g, w)),
                    f"{backend} explicit-avail event differs")
            require(np.array_equal(dev.avail, before),
                    f"{backend} update=False touched the registers")
            if step == 2:
                for f in (dev, ref):
                    f.grow(f.num_pes + 2, avail=3.0)
            elif step == 4:
                mask = np.zeros(dev.num_pes, bool)
                mask[1] = True
                for f in (dev, ref):
                    f.set_pe_mask(mask)
            elif step == 6:
                keep = np.array([0, 2, 3, 5])
                for f in (dev, ref):
                    f.shrink(keep)
            elif step == 8 and backend == "fused":
                require(dev.drain_counters() == ref.drain_counters(),
                        "drained counters differ")
        B, D = 256, 1330
        avg = rng.integers(0, 50, (B, D)).astype(np.float32)
        ex = rng.integers(1, 64, (B, D, dev.num_pes)).astype(np.float32)
        ex[rng.random((B, D)) < 0.05] = np.inf
        av = rng.integers(0, 16, (B, dev.num_pes)).astype(np.float32)
        g, w = dev.map_batch(avg, ex, av), ref.map_batch(avg, ex, av)
        torch.cuda.synchronize()
        compare_results(g, w, f"{backend} map_batch B={B} D={D}")
        if backend == "fused":
            require(dev.drain_counters() == ref.drain_counters(),
                    "final counters differ")
        log(f"[fabric] {backend}: {len(queue_lengths)} resident + explicit "
            f"events (queues up to {max(queue_lengths)}), map_batch B={B} "
            f"D={D}, grow/set_pe_mask/shrink/drain: equal to the CPU plain "
            f"path")


# ---------------------------------------------------------------------------
# phase: the CEDR runtime twin (main path, part 2)
# ---------------------------------------------------------------------------

TWIN_APPS = 10    # the first 10 of the workload's 20 frames (5 PD, 5 TX)


def run_twin(backend: str, device: str):
    from repro_torch.runtime import (CedrSimulator, high_latency_workload,
                                     make_arrivals, make_dispatch_fabric,
                                     paper_soc_pe_types)
    sim = CedrSimulator(paper_soc_pe_types(),
                        dispatch=make_dispatch_fabric(backend, device=device),
                        seed=7)
    return sim.run(make_arrivals(high_latency_workload()[:TWIN_APPS], 600,
                                 seed=1))


def same_sim_result(a, b) -> bool:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


def phase_runtime(torch, K) -> dict:
    t0 = time.perf_counter()
    ref = run_twin("cuda", "cpu")
    log(f"[runtime] CPU plain reference run: {time.perf_counter() - t0:.3f} s")
    counts = {}
    for backend in ("cuda", "fused"):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_twin(backend, "cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[backend] = K.launch_counts()
        require(same_sim_result(res, ref),
                f"CEDR twin on the {backend} backend differs from the CPU "
                f"plain run")
        require(np.isfinite(res.achieved_frame_rate)
                and res.completed_apps == res.num_apps,
                f"CEDR twin on {backend} did not complete")
        log(f"[runtime] {backend}: frame rate {res.achieved_frame_rate} "
            f"frames/s, max queue {res.max_queue_size}, mapping events "
            f"{len(res.mapping_events)}, launches {counts[backend]}, wall "
            f"{dt:.3f} s: SimResult identical to the CPU plain run")
    return counts


# ---------------------------------------------------------------------------
# phase: the priority queue and the EFT selector as standalone kernels
# ---------------------------------------------------------------------------

SORT_D = (5, 1330, 2048, 65536)
SELECT_P = (4, 8, 40, 1024)
MAX_SELECT_LANES = 1 << 24    # B * D * P per drain check (64 MB of exec)


def sort_keys(rng, B, D, dtype):
    """Seeded keys with duplicates and the special values of each type."""
    import torch
    if dtype == "i32":
        k = rng.integers(-50, 50, (B, D)).astype(np.int32)
        k[rng.random((B, D)) < 0.3] += 2**24           # exact above 2**24
        k[rng.random((B, D)) < 0.01] = np.iinfo(np.int32).min
        return torch.from_numpy(k)
    k = rng.integers(-8, max(8, D // 8), (B, D)).astype(np.float32)
    r = rng.random((B, D))
    k[r < 0.04] = np.nan
    k[(r >= 0.04) & (r < 0.08)] = -np.inf
    k[(r >= 0.08) & (r < 0.10)] = np.inf
    k[(r >= 0.10) & (r < 0.14)] = -0.0
    k[(r >= 0.14) & (r < 0.18)] = 0.0
    t = torch.from_numpy(k)
    return t.bfloat16() if dtype == "bf16" else t


def phase_queue_checks(torch, seed: int) -> dict:
    from repro_torch.kernels import eft_select, oddeven_sort, ops
    from repro_torch.kernels.ref import eft_select_ref

    rng = np.random.default_rng(seed)
    errs = {"oddeven_sort": 0.0, "eft_select": 0.0}
    for D in SORT_D:
        for dtype in ("f32", "bf16", "i32"):
            keys = sort_keys(rng, 256, D, dtype)
            payload = torch.from_numpy(
                rng.integers(-2**31, 2**31 - 1, (256, D)).astype(np.int32))
            want = ops._sort.sort_plain(keys, payload)
            got = oddeven_sort(keys.cuda(), payload.cuda())
            torch.cuda.synchronize()
            what = f"oddeven_sort B=256 D={D} {dtype}"
            for g, w, name in zip(got, want, ("keys", "payload")):
                require(bits_equal(g, w), f"{what}: {name} differ")
            errs["oddeven_sort"] = max(errs["oddeven_sort"],
                                       max_abs_err(got[0], want[0]))
            log(f"[queue] {what}: bitwise equal")
    for D in SORT_D:
        for P in SELECT_P:
            B = max(1, min(256, MAX_SELECT_LANES // (D * P)))
            # subnormal registers wherever the plain drain stays quick
            kinds = (("ints", "subnormal") if D * P <= SORT_D[-1] * 4
                     else ("ints",))
            for kind in kinds:
                _, ex, av = make_event(rng, B, D, P, kind=kind)
                cpu = [torch.from_numpy(x) for x in (ex, av)]
                want = eft_select_ref(*cpu)
                regs = cpu[1].cuda()
                got = eft_select(cpu[0].cuda(), regs, out_avail=regs)
                torch.cuda.synchronize()
                what = f"eft_select B={B} D={D} P={P} {kind}"
                for g, w, name in zip(got, want, ("assignment", "start",
                                                  "finish", "new_avail")):
                    require(bits_equal(g, w), f"{what}: {name} differ")
                    errs["eft_select"] = max(errs["eft_select"],
                                             max_abs_err(g, w))
            log(f"[queue] eft_select B={B} D={D} P={P} {'+'.join(kinds)}: "
                f"bitwise equal")
    return errs


def two_phase_event(torch, keys, ex, av):
    """The mapping event through the two standalone kernels' entry points:
    sort the queue carrying the QIDs, gather the exec rows, drain."""
    from repro_torch.kernels import eft_select, oddeven_sort
    B, D, P = ex.shape
    qids = torch.arange(D, dtype=torch.int32, device=keys.device)
    _, order = oddeven_sort(keys, qids.expand(B, D))
    exec_sorted = torch.gather(ex, 1, order.long()[..., None].expand(B, D, P))
    return (order, *eft_select(exec_sorted, av))


def phase_queue_path(torch, K, seed: int) -> dict:
    """Main path of the two kernels: the two-phase event at the
    fabric-batched shape, held against heft_fused on the card."""
    from repro_torch.kernels import heft_fused as hf

    rng = np.random.default_rng(seed + 1)
    events = [(256, D, 4) for D in (5, 1330, 2048)] + [(4, 65536, 4)]
    inputs = [[torch.from_numpy(x).cuda()
               for x in make_event(rng, B, D, P, kind="special")]
              for B, D, P in events]
    K.reset_launch_counts()
    got = [two_phase_event(torch, *x) for x in inputs]
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for (B, D, P), x, g in zip(events, inputs, got):
        want = hf.heft_fused(*x)
        torch.cuda.synchronize()
        compare_results(type(want)(*g), want,
                        f"sort -> gather -> select B={B} D={D} P={P}")
        log(f"[queue] two-phase event B={B} D={D} P={P}: equal to "
            f"heft_fused")
    require(counts["oddeven_sort"] == counts["eft_select"] == len(events),
            f"two-phase event launches {counts}")
    log(f"[queue] launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase: the serving scheduler over the fabric (main path, part 3)
# ---------------------------------------------------------------------------

SERVE_RATE_RPS, SERVE_DURATION_S, SERVE_ACTIVE_PARAMS = 1600, 3.0, 7e9


def serving_runs(S):
    """(name, fleet, simulate_serving keywords) of the serving phase."""
    fleet = S.default_fleet()
    chaos = [S.FailureEvent(0.5, "straggler", "v4-128", duration_s=1.0,
                            factor=4.0),
             S.FailureEvent(1.0, "replica_loss", "v5e-256b")]
    mesh = S.mesh_fleet()
    se = S.split_event(0.5, mesh[1], [(8, 16), (8, 16)])
    grow = S.ResizeEvent(1.0, add=(S.mesh_fleet("deepseek-7b",
                                                ((4, 16),))[0],))
    me = S.merge_event(2.0, se.add, (16, 16))
    return [("default_fleet", fleet, {}),
            ("loss+straggler", fleet, {"failure_events": chaos}),
            ("split/grow/merge", mesh, {"fleet_events": [se, grow, me]})]


def same_serve_result(a, b) -> bool:
    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            return False
    return True


def phase_serving(torch, K) -> dict:
    import repro_torch.sched_integration as S

    reqs = S.make_requests(rate_rps=SERVE_RATE_RPS,
                           duration_s=SERVE_DURATION_S, seed=0)
    counts = {}
    for name, fleet, kw in serving_runs(S):
        t0 = time.perf_counter()
        ref = S.simulate_serving(fleet, reqs,
                                 S.make_policy_fabric("torch", device="cpu"),
                                 active_params=SERVE_ACTIVE_PARAMS, **kw)
        ref_s = time.perf_counter() - t0
        for backend in ("cuda", "fused"):
            pol = S.make_policy_fabric(backend, device="cuda")
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res = S.simulate_serving(fleet, reqs, pol,
                                     active_params=SERVE_ACTIVE_PARAMS, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c = K.launch_counts()
            counts[f"{name}/{backend}"] = c
            fab = pol.fabric()
            require(fab.backend_effective == backend,
                    f"serving {name}: the {backend} policy ran "
                    f"{fab.backend_effective}")
            kernel = "heft_fused" if backend == "cuda" else "fused_decision"
            require(c[kernel] == fab.events > 0,
                    f"serving {name}/{backend}: {c[kernel]} {kernel} launches "
                    f"for {fab.events} mapping events")
            require(same_serve_result(res, ref),
                    f"serving {name} on the {backend} backend differs from "
                    f"the float32 CPU plain run")
            require(res.served_mask.all() and np.isfinite(res.p99_latency),
                    f"serving {name}/{backend}: not every request served")
            log(f"[serving] {name} {backend}: {len(reqs)} requests, "
                f"{fab.events} mapping events, mean latency "
                f"{res.mean_latency} s, p99 {res.p99_latency} s, achieved "
                f"{res.achieved_rps} req/s, requeued {int(res.requeued.sum())}"
                f", launches {c}, wall {dt:.3f} s (CPU plain {ref_s:.3f} s): "
                f"ServeResult identical to the CPU plain run")
    return counts


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes moved (inputs once, outputs once) over
    the memory rate vs operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def event_bound(B: int, D: int, P: int, masked: bool) -> tuple[float, str]:
    """A mapping event: keys, exec, avail (and the mask) in; order,
    assignment, start, finish and avail out; an add and a compare per lane
    per step."""
    nbytes = 4 * B * D + 4 * B * D * P + 4 * B * P + (P if masked else 0)
    nbytes += 16 * B * D + 4 * B * P
    return bound(nbytes, 2 * B * D * P)


def sort_bound(B: int, D: int, key_bytes: int) -> tuple[float, str]:
    """A sort: keys and payload in and out; D log2 D compares a row."""
    return bound(2 * B * D * (key_bytes + 4), B * D * max(np.log2(D), 1.0))


def select_bound(B: int, D: int, P: int) -> tuple[float, str]:
    """A drain: exec and avail in; assignment, start, finish and avail out;
    an add and a compare per lane per step."""
    return bound(4 * B * D * P + 4 * B * P + 12 * B * D + 4 * B * P,
                 2 * B * D * P)


def phase_timing(torch, seed: int) -> dict:
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf
    from repro_torch.kernels.ref import heft_fused_ref

    rng = np.random.default_rng(seed)
    B, D, P = TIMED_SHAPE
    keys, ex, av = (torch.from_numpy(x).cuda()
                    for x in make_event(rng, B, D, P))
    mask = torch.zeros(P, dtype=torch.bool, device="cuda")
    mask[1] = True
    out = {}
    for name, kern, plain in (
            ("heft_fused", lambda: hf.heft_fused(keys, ex, av),
             lambda: heft_fused_ref(keys, ex, av)),
            ("fused_decision", lambda: fd.fused_decision(keys, ex, av, mask),
             lambda: fd.decision_ref(keys, ex, av, None, mask))):
        ms = cuda_time_ms(torch, kern, iters=20)
        plain_ms = cuda_time_ms(torch, plain, iters=1, warmup=1)
        k1, e1, a1 = keys[:1, :256].contiguous(), ex[:1, :256].contiguous(), av[:1]
        one = ((lambda: hf.heft_fused(k1, e1, a1)) if name == "heft_fused"
               else (lambda: fd.fused_decision(k1, e1, a1, mask)))
        single = cuda_time_ms(torch, one, iters=50)
        b_ms, b_by = event_bound(B, D, P, name == "fused_decision")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "single_event_D256_ms": single}
        log(f"[timing] {name} B={B} D={D} P={P}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}); one event "
            f"D=256 P=4: {single:.6f} ms")
    out.update(time_queue_kernels(torch, keys, ex, av))
    return out


def time_queue_kernels(torch, keys, ex, av) -> dict:
    """The two standalone kernels on the timed shape's event: the sort of
    its keys carrying the QIDs, and the drain of its exec rows in that
    order (both their own inputs, as the two-phase event hands them)."""
    from repro_torch.kernels import eft_select, oddeven_sort, ops
    from repro_torch.kernels.ref import eft_select_ref

    B, D, P = TIMED_SHAPE
    qids = torch.arange(D, dtype=torch.int32,
                        device="cuda").expand(B, D).contiguous()
    _, order = oddeven_sort(keys, qids)
    exec_sorted = torch.gather(
        ex, 1, order.long()[..., None].expand(B, D, P)).contiguous()

    def library_sort():
        # the one PyTorch call for the same function (keys without NaN
        # here), plus the payload gather
        k, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
        return k, qids.gather(1, idx)

    out = {}
    for name, kern, plain, library, (b_ms, b_by) in (
            ("oddeven_sort", lambda: oddeven_sort(keys, qids),
             lambda: ops._sort.sort_plain(keys, qids), library_sort,
             sort_bound(B, D, 4)),
            ("eft_select", lambda: eft_select(exec_sorted, av),
             lambda: eft_select_ref(exec_sorted, av), None,
             select_bound(B, D, P))):
        ms = cuda_time_ms(torch, kern, iters=20)
        plain_ms = cuda_time_ms(torch, plain, iters=1, warmup=1)
        lib_ms = (cuda_time_ms(torch, library, iters=20) if library
                  else None)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms}
        lib = (f"torch.sort + gather {lib_ms:.6f} ms" if lib_ms is not None
               else "no PyTorch call computes it")
        log(f"[timing] {name} B={B} D={D} P={P}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the measurements to FILE (JSON)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels as K
    from repro_torch.kernels import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    walls = {}

    t0 = time.perf_counter()
    K.build_kernels()
    walls["build"] = time.perf_counter() - t0
    for kern in ops.KERNELS:
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kern.name}: {line.strip()}")
    log(f"[build] nvcc, {len(ops.KERNELS)} kernels in parallel: "
        f"{walls['build']:.3f} s")

    t0 = time.perf_counter()
    errs = phase_kernels(torch, args.seed)
    walls["kernels"] = time.perf_counter() - t0
    log(f"[kernels] wall {walls['kernels']:.3f} s")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    phase_fabric(torch, args.seed)
    walls["fabric"] = time.perf_counter() - t0
    fabric_counts = K.launch_counts()
    log(f"[fabric] launches {fabric_counts}, wall {walls['fabric']:.3f} s")

    t0 = time.perf_counter()
    runtime_counts = phase_runtime(torch, K)
    walls["runtime"] = time.perf_counter() - t0
    log(f"[runtime] wall {walls['runtime']:.3f} s")

    t0 = time.perf_counter()
    queue_errs = phase_queue_checks(torch, args.seed)
    errs.update(queue_errs)
    queue_counts = phase_queue_path(torch, K, args.seed)
    walls["queue"] = time.perf_counter() - t0
    log(f"[queue] wall {walls['queue']:.3f} s")

    t0 = time.perf_counter()
    serving_counts = phase_serving(torch, K)
    walls["serving"] = time.perf_counter() - t0
    log(f"[serving] wall {walls['serving']:.3f} s")

    launches = {}
    for name in ("heft_fused", "fused_decision"):
        per_phase = ([fabric_counts[name]]
                     + [c[name] for c in runtime_counts.values()]
                     + [c[name] for c in serving_counts.values()])
        require(fabric_counts[name] > 0,
                f"{name} never launched in the fabric phase")
        require(sum(c[name] for c in runtime_counts.values()) > 0,
                f"{name} never launched in the runtime phase")
        require(sum(c[name] for c in serving_counts.values()) > 0,
                f"{name} never launched in the serving phase")
        launches[name] = sum(per_phase)
    for name in ("oddeven_sort", "eft_select"):
        require(queue_counts[name] > 0,
                f"{name} never launched on the two-phase event path")
        launches[name] = queue_counts[name]

    t0 = time.perf_counter()
    timing = phase_timing(torch, args.seed)
    walls["timing"] = time.perf_counter() - t0
    log(f"[timing] wall {walls['timing']:.3f} s")

    sources = {"heft_fused": ("src/repro_torch/csrc/heft_fused.cu",
                              "src/repro/kernels/heft_fused.py:28"),
               "fused_decision": ("src/repro_torch/csrc/fused_decision.cu",
                                  "src/repro/kernels/fused_decision.py:118"),
               "oddeven_sort": ("src/repro_torch/csrc/oddeven_sort.cu",
                                "src/repro/kernels/oddeven_sort.py:38"),
               "eft_select": ("src/repro_torch/csrc/eft_select.cu",
                              "src/repro/kernels/eft_select.py:29")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": dict(zip("BDP", TIMED_SHAPE)),
        }
        if "single_event_D256_ms" in t:
            entry["single_event_D256_ms"] = t["single_event_D256_ms"]
        kernels.append(entry)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "walls_s": walls, "kernels": kernels,
            "launches_fabric": fabric_counts,
            "launches_runtime": runtime_counts,
            "launches_queue": queue_counts,
            "launches_serving": serving_counts}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

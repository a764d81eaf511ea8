#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--seed N]

Builds the port's four CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
one process per source, all at once), then runs these phases and fails on
the first disagreement:

* kernels — each kernel against its plain PyTorch version, run on CPU copies
  of the same inputs, bitwise: B = 256 events, D in {5, 1330, 2048}, P in
  {4, 8, 40}, plus edge cases (duplicate keys, all-inf rows, NaN and -inf
  keys, subnormal registers and exec times, the sort's scratch path up to
  the fabric's largest bucket, masks all-False and partial), and the
  staged drain's paths: the ring of row tiles (D = 8192 and 65536 at P =
  4, D = 1330 at P = 200, D = 300 at P = 1024), every step width (P = 1,
  3, 13), events of no-op rows only, rows made no-ops by the mask alone,
  -inf registers beside all-inf rows, and the fabric's padding (130 and
  223 real slots in the 256 bucket);
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
  sorts of B = 256 rows at D in {2, 5, 8, 33, 1330, 2048, 4097, 8192,
  65536} (one warp, the shared-memory path, the chunked scratch path) with
  f32, bf16, f16 and i32 keys (duplicates, NaN, -inf, +-0.0, a band around
  2**24), drains at D in {5, 1330, 2048, 65536} with P in {4, 8, 40, 1024}
  (all-inf rows, subnormal and -inf registers, events of no-op rows only,
  the ring of row tiles at D = 65536 and at P = 1024, the registers
  updated in place; B shrinks as D * P grows); then the two-phase event,
  sort -> gather -> select, through the public entry points at B = 256, P
  = 4, equal to ``heft_fused`` on the card;
* serving — ``simulate_serving`` over ``default_fleet()`` at 1600 requests/s
  for 3 s (the ``bench_serve_scheduler`` cell), with a replica-loss and
  straggler timeline, and over ``mesh_fleet()`` with a split / grow / merge
  timeline, each with ``make_policy_fabric("cuda")`` and ``("fused")`` on
  the card, against the same run with the float32 plain path (``torch`` on
  the CPU): identical ``ServeResult``;
* serve — deepseek-7b at its published widths and depth (30 layers,
  d_model 4096, vocab 102400, bf16, random weights from a seeded
  generator on the card) shared by three replicas (speeds 1.0 / 0.7 / 1.4)
  behind ``HeftFrontEnd.run_continuous(fused=True)`` on a
  ``MappingFabric(3, backend="fused", device_counters=True)``: 8 requests
  of 8-47 prompt tokens and 16 new tokens, staggered arrivals, four lanes,
  16-token pages.  Every request's tokens must equal the dense
  ``generate`` on the card bitwise, every in-tick decision the plain
  ``decision_ref`` on CPU copies of its staged operands, the
  ``fused_decision`` launches the decision ticks plus the host events, and
  the pages allocated those freed.  Then the decode tick (plain and
  carrying a decision), the decision kernel, a prefill and a one-lane
  tick are timed beside the tick's bytes bound;
* mamba — falcon-mamba-7b at its published widths and depth (64 Mamba
  layers, d_model 4096, d_inner 8192, d_state 16, vocab 65024, bf16) the
  same way, on prompts of 8, 12, 16, 32 and 48 tokens (a Mamba prefill
  takes at most its scan chunk of 16 or a multiple of it), with the state
  slots allocated == freed as well; the tick and a 48-token prefill are
  timed beside the tick's bound (the weights once, each lane's conv and
  ssm state read and written once);
* jamba-v0.1-52b with one period of its pattern (8 of 32 layers: 7 Mamba,
  1 attention, MoE on every second) and deepseek-v2-236b with its dense
  first layer and one MLA + MoE layer (2 of 60) at their published widths:
  three requests each through the same serve run, paged == dense bitwise
  at four lanes.  Each model is freed before the next is built (the whole
  of jamba, ~103 GB, or deepseek-v2, ~471 GB, does not fit the card's 80
  GB).  arctic-480b is not run here: one of its layers alone holds 13.4 B
  expert parameters (26.8 GB); the CPU tests cover it.

The fabric, runtime, queue-event, serving and the serve runs are the main
path: the kernels' launch counters are zeroed just before each and read
just after, and each kernel must have launched on its path.  Then each kernel is timed
with CUDA events at the fabric-batched shape (B = 256, D = 2048, P = 4)
and at the main path's one-event shapes (D = 256, 223 real slots in the
256 bucket, bucket 8), back to back and from a CUDA graph
(``time_event_shapes``, ``time_queue_shapes``, printed and in ``--out``),
beside its plain version, its bound and, for the sort, ``torch.sort`` +
gather timed the same ways.  The
last two lines are the ``kernels`` JSON record and ``{"ok": true,
"device": {...}}``.  Exits non-zero without a card, without the port's
sources next to it, or on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
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


def kernel_label(mangled: str) -> str:
    """A kernel function's name and template arguments from its mangled
    name, e.g. ``event_kernel<SmallStep<4>, masked>``."""
    m = re.search(r"(event_kernel|eft_kernel|sort_kernel)I(.*?)E+v", mangled)
    if not m:
        return mangled
    args = [f"{a}<{n}>" for a, n in re.findall(r"(SmallStep|WideStep)ILi(\d+)",
                                                m.group(2))]
    args += ["masked" if b == "1" else "unmasked"
             for b in re.findall(r"Lb([01])", m.group(2))]
    args += re.findall(r"Bf16Bits|F16Bits", m.group(2))
    return f"{m.group(1)}<{', '.join(args) or m.group(2).lstrip('L')}>"


def ptxas_report(log: str) -> list[str]:
    """One line per kernel function of nvcc's ``-Xptxas -v`` output: its
    name, registers, stack frame and spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


# ---------------------------------------------------------------------------
# phase: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_event(rng, B, D, P, *, kind="ints", mask=None):
    """Seeded inputs (f32): keys (B, D), exec (B, D, P), avail (B, P).

    Kinds beyond the integer grid: ``special`` keys (NaN, +-inf, -0.0),
    ``subnormal`` registers, exec times and keys, ``noop`` (every row +inf),
    ``maskonly`` (a fifth of the rows finite only on the lanes of ``mask``,
    so the mask alone makes them no-ops), ``neginf`` (-inf registers beside
    a fifth of all-inf rows) and ``padN`` (N real slots padded to D as the
    fabric pads them)."""
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
    if kind == "noop":
        ex[:] = np.inf
    if kind == "maskonly":
        rows = rng.random((B, D)) < 0.2
        ex[rows[..., None] & ~mask] = np.inf
    if kind == "neginf":
        avail[rng.random((B, P)) < 0.3] = -np.inf
        ex[rng.random((B, D)) < 0.2] = np.inf
    if kind.startswith("pad"):
        n = int(kind[3:])
        keys, ex = pad_event(keys[:, :n], ex[:, :n], D)
    return keys, ex, avail


def pad_event(keys, ex, D):
    """Pad (B, n) keys and (B, n, P) exec to D slots as the fabric's
    ``_pad_event`` does: NaN keys to -inf, -inf keys and +inf exec rows in
    the padding."""
    B, n, P = ex.shape
    k = np.full((B, D), -np.inf, np.float32)
    k[:, :n] = np.where(np.isnan(keys), -np.inf, keys)
    e = np.full((B, D, P), np.inf, np.float32)
    e[:, :n] = ex
    return k, e


def phase_kernels(torch, seed: int) -> dict:
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf
    from repro_torch.kernels.ref import heft_fused_ref
    from repro_torch.core.heft_rt import ScheduleResult

    rng = np.random.default_rng(seed)
    cases = [(256, D, P, "ints") for D in (5, 1330, 2048) for P in (4, 8, 40)]
    cases += [(64, 300, 4, "special"), (64, 300, 40, "subnormal"),
              (4, 8192, 4, "ints"), (1, 65536, 4, "ints")]
    # the staged drain: the ring at large P, every step width (P = 1, 3,
    # 13), no-op rows of every kind, the fabric's padding
    cases += [(8, 1330, 200, "ints"), (2, 300, 1024, "ints"),
              (64, 97, 1, "ints"), (64, 300, 3, "ints"),
              (64, 300, 13, "neginf"), (64, 300, 4, "neginf"),
              (64, 300, 40, "neginf"), (64, 300, 4, "noop"),
              (64, 300, 40, "noop"), (2, 8192, 4, "noop"),
              (64, 300, 4, "maskonly"), (64, 300, 8, "maskonly"),
              (64, 300, 40, "maskonly"), (8, 1330, 200, "maskonly"),
              (256, 256, 4, "pad130"), (256, 256, 4, "pad223")]
    errs = {"heft_fused": 0.0, "fused_decision": 0.0}
    for B, D, P, kind in cases:
        partial = rng.random(P) < 0.4
        partial[rng.integers(P)] = True
        keys, ex, av = make_event(rng, B, D, P, kind=kind, mask=partial)
        cpu = [torch.from_numpy(x) for x in (keys, ex, av)]
        dev = [t.cuda() for t in cpu]
        masks = [np.zeros(P, bool), partial]
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

SORT_D = (2, 5, 8, 33, 1330, 2048, 4097, 8192, 65536)
SORT_DTYPES = ("f32", "bf16", "f16", "i32")
SELECT_D = (5, 1330, 2048, 65536)
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
    if dtype == "bf16":
        return t.bfloat16()
    return t.half() if dtype == "f16" else t


def phase_queue_checks(torch, seed: int) -> dict:
    from repro_torch.kernels import eft_select, oddeven_sort, ops
    from repro_torch.kernels.ref import eft_select_ref

    rng = np.random.default_rng(seed)
    errs = {"oddeven_sort": 0.0, "eft_select": 0.0}
    for D in SORT_D:
        for dtype in SORT_DTYPES:
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
    for D in SELECT_D:
        for P in SELECT_P:
            B = max(1, min(256, MAX_SELECT_LANES // (D * P)))
            # subnormal and -inf registers, and events of no-op rows only,
            # wherever the plain drain stays quick
            kinds = (("ints", "subnormal", "neginf", "noop")
                     if D * P <= SELECT_D[-1] * 4 else ("ints",))
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


def graph_time_ms(torch, fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn`` with the host's share taken out:
    ``launches`` calls captured in one CUDA graph, replayed ``replays``
    times between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def timed_shapes(rng) -> dict:
    """The main path's shapes, by name, as (keys, exec, avail) arrays: the
    fabric-batched B = 256, D = 2048, P = 4; one event of D = 256; one
    CEDR-twin event (223 real slots padded to the 256 bucket as the fabric
    pads them); one serving event (8 real slots, bucket 8)."""
    B, D, P = TIMED_SHAPE
    batch = make_event(rng, B, D, P)
    return {
        f"B{B}_D{D}_P{P}": batch,
        "D256": tuple(np.ascontiguousarray(x[:1, :256]) for x in batch),
        "pad223_of_256": make_event(rng, 1, 256, P, kind="pad223"),
        "bucket8": make_event(rng, 1, 8, P),
    }


def time_both(torch, fn, shape: str) -> dict:
    """``fn`` back to back through its wrapper (``ms``, host included
    where it is the longer) and replayed from a CUDA graph (``graph_ms``,
    the device's time)."""
    iters = 20 if shape.startswith("B") else 50
    return {"ms": cuda_time_ms(torch, fn, iters=iters),
            "graph_ms": graph_time_ms(torch, fn)}


def time_event_shapes(torch, seed: int) -> dict:
    """The two event kernels at the main path's shapes (``timed_shapes``),
    each timed by ``time_both``.  Uses only the wrappers' public
    signatures, so it times any tree of the port."""
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf

    rng = np.random.default_rng(seed)
    P = TIMED_SHAPE[2]
    mask = torch.zeros(P, dtype=torch.bool, device="cuda")
    mask[1] = True
    out = {"heft_fused": {}, "fused_decision": {}}
    for shape, arrays in timed_shapes(rng).items():
        keys, ex, av = (torch.from_numpy(x).cuda() for x in arrays)
        for name, fn in (
                ("heft_fused", lambda: hf.heft_fused(keys, ex, av)),
                ("fused_decision",
                 lambda: fd.fused_decision(keys, ex, av, mask))):
            t = out[name][shape] = time_both(torch, fn, shape)
            log(f"[timing] {name} {shape} {tuple(keys.shape)}x{P}: "
                f"{t['ms']:.6f} ms back to back, {t['graph_ms']:.6f} ms "
                f"from a CUDA graph")
    return out


def queue_operands(torch, keys, ex):
    """The two standalone kernels' inputs for one event batch, as the
    two-phase event hands them: the QIDs to sort by ``keys``, and the exec
    rows gathered into that order."""
    from repro_torch.kernels import oddeven_sort
    B, D, P = ex.shape
    qids = torch.arange(D, dtype=torch.int32,
                        device=keys.device).expand(B, D).contiguous()
    _, order = oddeven_sort(keys, qids)
    exec_sorted = torch.gather(
        ex, 1, order.long()[..., None].expand(B, D, P)).contiguous()
    return qids, exec_sorted


def library_sort(torch, keys, qids):
    """The one PyTorch call for the sort's function (on keys without NaN,
    as ``make_event`` makes them), plus the payload gather."""
    k, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    return k, qids.gather(1, idx)


def time_queue_shapes(torch, seed: int) -> dict:
    """``oddeven_sort`` (the keys carrying the QIDs), ``eft_select`` (the
    exec rows in that order) and ``torch.sort`` + gather at the shapes of
    ``time_event_shapes`` (the same inputs: same seed), each timed by
    ``time_both``.  Uses only the public signatures, so it times any tree
    of the port."""
    from repro_torch.kernels import eft_select, oddeven_sort

    rng = np.random.default_rng(seed)
    out = {"oddeven_sort": {}, "eft_select": {}, "torch_sort_gather": {}}
    for shape, arrays in timed_shapes(rng).items():
        keys, ex, av = (torch.from_numpy(x).cuda() for x in arrays)
        qids, exec_sorted = queue_operands(torch, keys, ex)
        for name, fn in (
                ("oddeven_sort", lambda: oddeven_sort(keys, qids)),
                ("eft_select", lambda: eft_select(exec_sorted, av)),
                ("torch_sort_gather",
                 lambda: library_sort(torch, keys, qids))):
            t = out[name][shape] = time_both(torch, fn, shape)
            log(f"[timing] {name} {shape} {tuple(ex.shape)}: "
                f"{t['ms']:.6f} ms back to back, {t['graph_ms']:.6f} ms "
                f"from a CUDA graph")
    return out


def phase_timing(torch, seed: int) -> dict:
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import eft_select_ref, heft_fused_ref

    shapes = time_event_shapes(torch, seed)
    queue = time_queue_shapes(torch, seed)
    rng = np.random.default_rng(seed)
    B, D, P = TIMED_SHAPE
    timed = f"B{B}_D{D}_P{P}"
    keys, ex, av = (torch.from_numpy(x).cuda()
                    for x in make_event(rng, B, D, P))
    mask = torch.zeros(P, dtype=torch.bool, device="cuda")
    mask[1] = True
    qids, exec_sorted = queue_operands(torch, keys, ex)
    out = {"event_shapes": shapes, "queue_shapes": queue}
    for name, plain, (b_ms, b_by), times in (
            ("heft_fused", lambda: heft_fused_ref(keys, ex, av),
             event_bound(B, D, P, False), shapes["heft_fused"]),
            ("fused_decision",
             lambda: fd.decision_ref(keys, ex, av, None, mask),
             event_bound(B, D, P, True), shapes["fused_decision"]),
            ("oddeven_sort", lambda: ops._sort.sort_plain(keys, qids),
             sort_bound(B, D, 4), queue["oddeven_sort"]),
            ("eft_select", lambda: eft_select_ref(exec_sorted, av),
             select_bound(B, D, P), queue["eft_select"])):
        plain_ms = cuda_time_ms(torch, plain, iters=1, warmup=1)
        lib = (queue["torch_sort_gather"][timed]
               if name == "oddeven_sort" else None)
        out[name] = {"ms": times[timed]["ms"],
                     "graph_ms": times[timed]["graph_ms"],
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by,
                     "library_ms": lib["ms"] if lib else None,
                     "library_graph_ms": lib["graph_ms"] if lib else None,
                     "one_event_graph_ms": {
                         s: t["graph_ms"] for s, t in times.items()
                         if s != timed}}
        log(f"[timing] {name} B={B} D={D} P={P}: kernel "
            f"{times[timed]['ms']:.6f} ms ({times[timed]['graph_ms']:.6f} "
            f"ms from a graph), plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})" +
            (f", torch.sort + gather {lib['ms']:.6f} ms "
             f"({lib['graph_ms']:.6f} ms from a graph)" if lib else ""))
    return out


# ---------------------------------------------------------------------------
# phase: the serving path at full width (main path, part 4)
# ---------------------------------------------------------------------------

SERVE_ARCH = "deepseek_7b"          # 30 layers, d_model 4096, vocab 102400
SERVE_SPEEDS = (1.0, 0.7, 1.4)      # the launcher's three replicas
SERVE_REQUESTS, SERVE_NEW_TOKENS = 8, 16
SERVE_MAX_BATCH, SERVE_PAGE_SIZE, SERVE_MAX_LEN = 4, 16, 128
BF16_OPS_PER_S = 989e12             # H100 SXM bf16 tensor cores, dense
DEVICE = "cuda"
# Prompt lengths a Mamba prefill accepts at full width (at most the scan
# chunk of 16, or a multiple of it), used in turn.
MAMBA_PROMPTS = (8, 12, 16, 32, 48)
# Published widths of the served configurations, checked before a run:
# (layers, d_model, heads, kv heads, d_ff, vocab, param dtype, and the
# Mamba layers' d_inner, d_state and scan chunk).
PUBLISHED = {
    "deepseek_7b": (30, 4096, 32, 32, 11008, 102400, "bfloat16", None),
    "falcon_mamba_7b": (64, 4096, 1, 1, 0, 65024, "bfloat16", (8192, 16, 16)),
    "jamba_v0_1_52b": (32, 4096, 32, 8, 14336, 65536, "bfloat16",
                       (8192, 16, 16)),
    "deepseek_v2_236b": (60, 5120, 128, 128, 12288, 102400, "bfloat16",
                         None),
}
# Layers kept where the whole model does not fit the card, with why:
# jamba one period of its 1:7 pattern (7 Mamba + 1 attention layer, MoE on
# every second), deepseek-v2 its dense first layer and one MLA + MoE layer.
CUT_LAYERS = {"jamba_v0_1_52b": 8, "deepseek_v2_236b": 2}
CUT_REQUESTS = 3


def serve_requests(rng, vocab: int, lengths=None, n: int = SERVE_REQUESTS):
    """The launcher's recipe: prompts of 8-47 tokens (or ``lengths`` in
    turn), 16 new tokens each."""
    return [(rng.integers(0, vocab, lengths[i % len(lengths)] if lengths
                          else rng.integers(8, 48)).astype(np.int32),
             SERVE_NEW_TOKENS) for i in range(n)]


def check_widths(cfg, arch: str) -> None:
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.param_dtype,
           cfg.ssm and (cfg.ssm.d_inner, cfg.ssm.d_state, cfg.ssm.chunk))
    require(got == PUBLISHED[arch],
            f"{arch} is not at its published widths: {cfg}")


def free_card(torch) -> None:
    """Let the last model's memory go before the next one is built."""
    import gc
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def record_decisions(fab):
    """Wrap a fused fabric so every in-tick decision is kept with CPU copies
    of the operands it was staged with (taken before the tick's kernel
    writes the registers), and host-path events are counted."""
    staged, decided, host = [], [], []
    stage, commit, map_event = (fab.tick_decision_inputs,
                                fab.commit_tick_decision, fab.map_event)

    def stage_rec(avg, exec_times):
        ops = stage(avg, exec_times)
        a_p, ex_p, _, avail, mask, _, _ = ops
        staged.append((a_p.copy(), ex_p.copy(), avail.cpu().clone(),
                       mask.cpu().clone(), len(avg)))
        return ops

    def commit_rec(n, buf, new_avail, counters=None):
        out = commit(n, buf, new_avail, counters)
        decided.append(out)
        return out

    def map_rec(*args, **kw):
        host.append(1)
        return map_event(*args, **kw)

    fab.tick_decision_inputs = stage_rec
    fab.commit_tick_decision = commit_rec
    fab.map_event = map_rec
    return staged, decided, host


def unwrap(fab) -> None:
    """Undo :func:`record_decisions` (the class's methods again)."""
    for name in ("tick_decision_inputs", "commit_tick_decision", "map_event"):
        delattr(fab, name)


def check_decisions(torch, staged, decided, num_pes: int) -> None:
    """Each in-tick decision, bitwise, against ``decision_ref`` (the plain
    version) on the CPU copies of its staged operands."""
    from repro_torch.kernels import decision_ref
    require(len(staged) == len(decided) > 0,
            f"{len(staged)} staged / {len(decided)} committed decisions")
    for k, ((a_p, ex_p, avail, mask, n), got) in enumerate(zip(staged,
                                                               decided)):
        want = decision_ref(torch.from_numpy(a_p), torch.from_numpy(ex_p),
                            avail, None, mask)
        want = (want.order[:n], want.assignment[:n], want.start_time[:n],
                want.finish_time[:n], want.new_avail[:num_pes])
        for name, g, w in zip(("order", "assignment", "start", "finish",
                               "new_avail"), got, want):
            require(bits_equal(torch.from_numpy(np.ascontiguousarray(g)), w),
                    f"serve: in-tick decision {k} {name} differs from the "
                    f"plain version")


def tick_bound(cfg, params_per_token: int, kv_tokens: int,
               lanes: int) -> tuple[float, str]:
    """Least time for one decode tick: the weights read once (the embedding
    table only at the lanes' rows), each lane's cached tokens (K and V, or
    MLA's latent) up to its position read once and its new token's written
    once, each lane's Mamba state (conv and ssm rows) read and written
    once, the int32 tokens in and out; 2 operations a weight a lane, in
    bf16."""
    from repro_torch.models import cache_specs
    from repro_torch.serve.paging import STATE_LEAVES
    per_token = per_lane = 0
    for name, s in cache_specs(cfg, 1, 1).items():
        n = int(np.prod(s.shape)) * s.dtype.itemsize
        if name in STATE_LEAVES:
            per_lane += 2 * n
        else:
            per_token += n
    nbytes = (2 * params_per_token + per_token * (kv_tokens + lanes)
              + per_lane * lanes + 8 * lanes)
    ops = 2.0 * params_per_token * lanes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_serve_tick(torch, eng, fab, rng, cfg, seed: int,
                    prefill_len: int) -> dict:
    """Decode ticks at the full lane width, plain and carrying a decision,
    the decision kernel alone at the tick's event shape, and a prefill of
    ``prefill_len`` tokens, each timed with CUDA events."""
    from repro_torch.kernels import decision_hw
    rt = eng.paged
    for _ in range(eng.lanes):
        prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
        require(eng.admit(prompt, 64) is not None, "timing: admit refused")
    for _ in range(2):
        eng.decode_tick()
    kv_tokens = sum(rt.slots[s].write_pos + 1 for s in rt.active_slots())
    iters = 10
    plain_ms = cuda_time_ms(torch, eng.decode_tick, iters=iters, warmup=0)
    # the positions advance by one a tick: the mean over the timed ticks
    kv_tokens += eng.lanes * (iters - 1) // 2
    avg = rng.integers(1, 8, eng.lanes).astype(np.float64)
    ex = rng.integers(1, 64, (eng.lanes, fab.num_pes)).astype(np.float64)
    fused_ms = cuda_time_ms(torch, lambda: eng.decode_tick((avg, ex, fab)),
                            iters=iters, warmup=0)
    a_p, ex_p, _, avail, mask, _, _ = fab.tick_decision_inputs(avg, ex)
    a_d = torch.from_numpy(a_p).to(DEVICE)
    ex_d = torch.from_numpy(ex_p).to(DEVICE)
    regs = avail.clone()
    decision_ms = graph_time_ms(
        torch, lambda: decision_hw(a_d, ex_d, regs, mask, out_avail=regs))
    prompt = rng.integers(0, cfg.vocab_size,
                          (1, prefill_len)).astype(np.int32)
    prefill_ms = cuda_time_ms(torch, lambda: eng.start(prompt), iters=5)
    # what the fixed lane width costs a lone request: one lane, unpadded
    one = type(eng)(cfg, eng.params, max_len=eng.max_len, lanes=1)
    one.start_paged(max_batch=1, page_size=SERVE_PAGE_SIZE)
    one.admit(prompt[0, :32], 64)
    one_lane_ms = cuda_time_ms(torch, one.decode_tick, iters=iters)
    per_token = cfg.param_count() - cfg.vocab_size * cfg.d_model + \
        eng.lanes * cfg.d_model
    b_ms, b_by = tick_bound(cfg, per_token, kv_tokens, eng.lanes)
    return {"lanes": eng.lanes, "tick_ms": plain_ms, "fused_tick_ms": fused_ms,
            "decision_graph_ms": decision_ms,
            "decision_share": decision_ms / fused_ms,
            "tokens_per_s": eng.lanes * 1e3 / plain_ms,
            "prefill_tokens": prefill_len, "prefill_ms": prefill_ms,
            "one_lane_tick_ms": one_lane_ms, "bound_ms": b_ms,
            "bound_by": b_by, "kv_tokens_mean": kv_tokens,
            "weights_read_per_tick": per_token}


def log_tick(tag: str, t: dict) -> None:
    log(f"[{tag}] decode tick at {t['lanes']} lanes: {t['tick_ms']:.6f} ms "
        f"({t['tokens_per_s']:.1f} tokens/s), carrying a decision "
        f"{t['fused_tick_ms']:.6f} ms; fused_decision alone "
        f"{t['decision_graph_ms']:.6f} ms from a graph "
        f"({100 * t['decision_share']:.3f}% of the tick); prefill of "
        f"{t['prefill_tokens']} tokens {t['prefill_ms']:.6f} ms; one request "
        f"alone at one lane {t['one_lane_tick_ms']:.6f} ms a tick; tick "
        f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
        f"{t['weights_read_per_tick']} weights, {t['kv_tokens_mean']} cached "
        f"tokens)")


def build_model(torch, cfg, seed: int, tag: str):
    """Random bf16 weights from a seeded generator, on the card."""
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                         device=DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "layers": cfg.num_layers,
           "param_count": cfg.param_count(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters())}
    log(f"[{tag}] {cfg.name}, {cfg.num_layers} layers: "
        f"{out['param_count']} parameters ({out['param_bytes']} bytes) on "
        f"the card in {out['init_s']:.3f} s")
    return params, out


def run_served(torch, K, cfg, params, requests, tag: str):
    """Three replicas sharing ``params`` (speeds 1.0 / 0.7 / 1.4) serve
    ``requests`` through ``HeftFrontEnd.run_continuous(fused=True)`` on a
    ``MappingFabric(3, backend="fused", device_counters=True)``, four lanes,
    16-token pages, staggered arrivals.  The launch counts are zeroed just
    before the run and read just after.  Checks: every request's tokens
    bitwise the dense ``generate``, every in-tick decision bitwise the plain
    version, ``fused_decision`` launched once a decision tick and once a
    host event, pages and state slots allocated == freed.  Returns (record,
    fleet, fabric)."""
    from repro_torch.sched_integration import MappingFabric
    from repro_torch.serve import HeftFrontEnd, ReplicaHandle, ServeEngine

    fleet = [ReplicaHandle(f"replica{i}(x{s})",
                           ServeEngine(cfg, params, max_len=SERVE_MAX_LEN,
                                       lanes=SERVE_MAX_BATCH), speed=s)
             for i, s in enumerate(SERVE_SPEEDS)]
    fab = MappingFabric(len(fleet), backend="fused", device=DEVICE,
                        device_counters=True)
    require(DEVICE != "cuda" or fab.backend_effective == "fused",
            f"{tag} fabric runs {fab.backend_effective}")
    front = HeftFrontEnd(fleet, fabric=fab)
    arrivals = [min(i, 2 * SERVE_NEW_TOKENS // 3)
                for i in range(len(requests))]
    staged, decided, host = record_decisions(fab)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    outs, stats = front.run_continuous(
        requests, arrival_ticks=arrivals, max_batch=SERVE_MAX_BATCH,
        page_size=SERVE_PAGE_SIZE, fused=True)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()

    require(stats["fused_decisions"] > 0, f"{tag}: no in-tick decision {stats}")
    require(counts["fused_decision"] == len(decided) + len(host) > 0,
            f"{tag}: {counts['fused_decision']} fused_decision launches for "
            f"{len(decided)} decision ticks + {len(host)} host events")
    require(stats["allocated"] == stats["freed"] > 0,
            f"{tag}: {stats['allocated']} pages allocated, "
            f"{stats['freed']} freed")
    require(stats["slots_allocated"] == stats["slots_freed"] == len(requests),
            f"{tag}: {stats['slots_allocated']} state slots allocated, "
            f"{stats['slots_freed']} freed, {len(requests)} requests")
    check_decisions(torch, staged, decided, fab.num_pes)
    for i, (prompt, nt) in enumerate(requests):
        dense = fleet[0].engine.generate(prompt[None, :], nt)[0]
        require(np.array_equal(outs[i], dense),
                f"{tag}: request {i} paged tokens differ from the dense "
                f"generate on the card")
    new = sum(nt for _, nt in requests)
    log(f"[{tag}] run_continuous: {len(requests)} requests (prompts "
        f"{[len(p) for p, _ in requests]}), {new} new tokens in {wall:.3f} s "
        f"({new / wall:.1f} tokens/s), {stats['ticks']} ticks x "
        f"{len(fleet)} replicas, decisions {stats['fused_decisions']} "
        f"in-tick / {stats['host_decisions']} host, launches {counts}, "
        f"pages {stats['allocated']} == {stats['freed']}, state slots "
        f"{stats['slots_allocated']} == {stats['slots_freed']}; every "
        f"request bitwise the dense generate, every in-tick decision "
        f"bitwise the plain version")
    unwrap(fab)
    record = dict(wall_s=wall, new_tokens=new, ticks=stats["ticks"],
                  prompt_lens=[len(p) for p, _ in requests],
                  decision_ticks=len(decided), host_events=len(host),
                  launches=counts, latency_s=stats["latency_s"],
                  fused_decisions=stats["fused_decisions"],
                  host_decisions=stats["host_decisions"],
                  pages=stats["allocated"], slots=stats["slots_allocated"])
    return record, fleet, fab


def phase_serve(torch, K, seed: int) -> dict:
    """deepseek-7b at its published widths and depth, bf16, random weights
    from a seeded generator, served by three replicas through the port's
    ``HeftFrontEnd.run_continuous(fused=True)`` on a fused fabric."""
    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH)
    check_widths(cfg, SERVE_ARCH)
    params, out = build_model(torch, cfg, seed, "serve")
    rng = np.random.default_rng(seed)
    requests = serve_requests(rng, cfg.vocab_size)
    record, fleet, fab = run_served(torch, K, cfg, params, requests, "serve")
    out.update(record)
    t = time_serve_tick(torch, fleet[0].engine, fab, rng, cfg, seed,
                        prefill_len=47)
    out["timing"] = t
    log_tick("serve", t)
    return out


def phase_serve_mamba(torch, K, seed: int) -> dict:
    """falcon-mamba-7b at its published widths and depth (64 Mamba layers,
    d_inner 8192, d_state 16, vocab 65024, bf16): the same serve run as
    deepseek-7b's, on prompts a Mamba prefill accepts, then the tick and a
    48-token prefill timed beside the tick's bound (the weights once, each
    lane's conv and ssm state read and written once)."""
    from repro_torch.configs import get_config

    arch = "falcon_mamba_7b"
    cfg = get_config(arch)
    check_widths(cfg, arch)
    params, out = build_model(torch, cfg, seed, "mamba")
    rng = np.random.default_rng(seed)
    requests = serve_requests(rng, cfg.vocab_size, MAMBA_PROMPTS)
    record, fleet, fab = run_served(torch, K, cfg, params, requests, "mamba")
    out.update(record)
    t = time_serve_tick(torch, fleet[0].engine, fab, rng, cfg, seed,
                        prefill_len=48)
    out["timing"] = t
    log_tick("mamba", t)
    return out


def phase_serve_cut(torch, K, arch: str, seed: int) -> dict:
    """``arch`` at its published widths with ``CUT_LAYERS[arch]`` layers
    (the whole model does not fit the card): three requests through the
    same serve run, paged == dense bitwise at four lanes."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    check_widths(full, arch)
    cfg = full.with_(num_layers=CUT_LAYERS[arch])
    params, out = build_model(torch, cfg, seed, arch)
    out["published_layers"] = full.num_layers
    rng = np.random.default_rng(seed)
    requests = serve_requests(rng, cfg.vocab_size, MAMBA_PROMPTS,
                              n=CUT_REQUESTS)
    record, _, _ = run_served(torch, K, cfg, params, requests, arch)
    out.update(record)
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
        for line in ptxas_report(kern.build_log):
            log(f"[build] {kern.name}: {line}")
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
    serve = phase_serve(torch, K, args.seed)
    walls["serve"] = time.perf_counter() - t0
    log(f"[serve] wall {walls['serve']:.3f} s")
    launches["fused_decision"] += serve["launches"]["fused_decision"]
    free_card(torch)

    t0 = time.perf_counter()
    mamba = phase_serve_mamba(torch, K, args.seed)
    walls["mamba"] = time.perf_counter() - t0
    log(f"[mamba] wall {walls['mamba']:.3f} s")
    launches["fused_decision"] += mamba["launches"]["fused_decision"]
    free_card(torch)

    cut = {}
    for arch in CUT_LAYERS:
        t0 = time.perf_counter()
        cut[arch] = phase_serve_cut(torch, K, arch, args.seed)
        walls[arch] = time.perf_counter() - t0
        log(f"[{arch}] wall {walls[arch]:.3f} s")
        launches["fused_decision"] += cut[arch]["launches"]["fused_decision"]
        free_card(torch)

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
            "graph_ms": t["graph_ms"],
            "library_graph_ms": t["library_graph_ms"],
            "shape": dict(zip("BDP", TIMED_SHAPE)),
            "one_event_graph_ms": t["one_event_graph_ms"],
        }
        kernels.append(entry)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "walls_s": walls, "kernels": kernels,
            "launches_fabric": fabric_counts,
            "launches_runtime": runtime_counts,
            "launches_queue": queue_counts,
            "launches_serving": serving_counts,
            "serve": serve, "serve_mamba": mamba, "serve_cut": cut,
            "event_shapes": timing["event_shapes"],
            "queue_shapes": timing["queue_shapes"]}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

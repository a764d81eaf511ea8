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
  expert parameters (26.8 GB); the CPU tests cover it;
* train — (a) the deepseek-7b, falcon-mamba-7b and jamba smoke configs in
  float32, the same weights (from a numpy seed) on the card and on the
  CPU: 3 steps of ``make_train_step`` at microbatches 1 and 2, the
  losses, metrics and parameters on the card within 4x what one float32
  rounding of the weights does on the CPU alone (a third CPU run measures
  that spread); then the ``Trainer`` on the card fails at step 3, resumes
  to step 6 and ends bitwise equal to a clean 6-step run (deterministic
  algorithms on).  (b) deepseek-7b trained at its published widths and
  depth (bf16, 6910365696 parameters), AdamW with int8 moments and
  ``warmup_cosine(3e-3, 10, 4)``, remat on, ``TokenPipeline`` batches of
  4 x 512 tokens, 4 steps: loss, ce and grad_norm finite at every step,
  step 1's ce equal to a plain f32 cross-entropy of ``logits_fn`` within
  2**-8 relative, every parameter moved, the optimizer at step 4; the
  step time (median of steps 2-4), tokens/s, the model-FLOP share of 989
  TFLOP/s (6·N·T, and 8·N·T with remat's extra forward) and the peak
  memory beside the 41.5 GB reckoned resident are printed with the card's
  name and power limit.  No kernel of the four is on this path;
* dist-serve (right after serve, on its weights) — deepseek-7b at full
  width served by one ``(1, 1)`` mesh-backed replica
  (``mesh_backed_fleet`` over an ``nccl`` world of this one process; its
  parameters, caches and pools ``DTensor``s, every step under its hint
  policy) and two meshless replicas on the same weights, behind
  ``run_continuous(fused=True)`` on a fused ``MappingFabric(3)``: 8
  requests of 8-47 tokens, 16 new tokens, four lanes.  Every request
  bitwise the dense meshless ``generate``, every in-tick decision bitwise
  ``decision_ref``, ``fused_decision`` launched inside the meshed
  replica's ticks, pages allocated == freed, the parameters ``DTensor``s
  on the mesh, and a ``reshard(None)`` and back to ``(1, 1)`` in
  mid-generation bitwise.  The meshed tick is timed beside the meshless
  one, with each tick's dispatched aten ops and DTensor redistributions;
* chaos (after dist-serve has freed its weights) — the serve launcher as a
  user runs it, ``repro_torch.launch.serve.main`` with ``--arch
  deepseek-7b --full-width --paged --fused-scheduler``, 8 requests and
  ``--chaos`` on a timeline of a replica loss (a unique name prefix), a 2x
  straggler and a degraded spine link, ``--min-goodput 90``: no
  ``SystemExit`` (the launcher checks request 0 against the dense oracle
  and the failover re-serve token for token), ``fused_decision`` launched
  in the ticks and ``heft_fused`` by the twin's policy, and the twin's
  goodput, re-queued and unserved counts on the card equal to the same
  twin on the CPU, float32 and float64;
* examples — each of ``examples/port/`` as a subprocess on the card and
  twice with ``--device cpu`` (the float32 plain version under
  ``REPRO_TORCH_FABRIC_BACKEND=torch``, and the float64 host path), six
  at once: every run exits 0, and the numbers the card run prints (its
  decisions and SimResults) equal the float32 CPU run's; lines where the
  float64 run differs are printed;
* dryrun — ``python -m repro_torch.launch.dryrun`` for deepseek-7b at
  ``decode_32k`` and ``train_4k`` (16x16 and 2x16x16) and ``prefill_32k``
  (16x16), yi-34b ``decode_32k`` (its 56 / 8 heads padded to 64 / 16) and
  deepseek-v2-236b ``decode_32k`` (MLA, the batch over data), all 16x16,
  one process a cell at once (a fake world needs a process of its own):
  no cell with an error, rank 0's FLOPs within the dry run's
  ``flop_bounds`` for the config the cell ran, the cells covering a
  (deepseek-7b, 16x16)
  replica in ``CostModelRegistry``; then the recorder around one
  real full-width ``decode_step`` on the card (4 lanes, a 2048-token
  cache) counts the FLOPs, bytes and ops it counts on ``meta`` tensors at
  those shapes, and the step is timed;
* tp-train (after train) — deepseek-7b at full width and depth trained two
  steps by the tensor-parallel ``make_train_step(pod_axis="pod", mesh=)``
  on a (pod, data, model) = (1, 1, 1) mesh over the ``nccl`` world of this
  one process (every op a ``DTensor`` op, no collective that moves data):
  step 1's loss / ce / grad_norm and every parameter after step 2 bitwise
  the train phase's meshless run (host copies of its parameters); the
  step's seconds beside the meshless step, a step's aten ops and
  ``DTensor`` redistributions, the peak memory;
* dist-train (after train) — two spawned processes on the one card over a
  ``gloo`` group as two pods (NCCL refuses two ranks on one card; gloo
  runs all_reduce and broadcast on its tensors through the host):
  deepseek-7b at its published widths cut to 4 of 30 layers, bf16, int8
  moments, remat, ``TokenPipeline`` batches of 4 x 512 split over the
  pods, two steps each of the exact and the int8 error-feedback pod step.
  The reductions are held on each rank's real gradients of its half of
  the first batch: ``psum_mean`` within one bf16 rounding of the exact
  mean of the two ranks' gradients, ``compressed_psum_mean`` within half an
  int8 step of the group absmax (plus its bf16 rounding), and that mean
  within 4x the spread one bf16 rounding of the weights causes in the
  whole-batch gradient, leaf by leaf.  Both ranks' parameters bitwise
  equal after every step; the residual finite and non-zero; a smoke-width
  ``Trainer``'s residual saved at pod 2 and restored here at pod 1 keeps
  Σe/n.  Step times and the reductions' alone are printed.

The fabric, runtime, queue-event, serving, the serve runs, dist-serve and
chaos are the main path of the four kernels: the kernels' launch counters are zeroed just before each and read
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
import contextlib
import dataclasses
import json
import math
import os
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


def phase_serve(torch, K, seed: int):
    """deepseek-7b at its published widths and depth, bf16, random weights
    from a seeded generator, served by three replicas through the port's
    ``HeftFrontEnd.run_continuous(fused=True)`` on a fused fabric.  Returns
    the record and the weights (the dist-serve phase reuses them)."""
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
    return out, params


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
# phase: dist-serve (a mesh-backed replica at full width, world size 1)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_redistributions():
    """Counts the calls of DTensor's ``redistribute_local_tensor`` (each
    placement change of an operand) while the block runs; yields a list
    whose one entry is the count."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dsp
    import torch.distributed.tensor._redistribute as red

    n = [0]
    orig = red.redistribute_local_tensor

    def counted(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)

    mods = [m for m in (api, dsp, red)
            if getattr(m, "redistribute_local_tensor", None) is orig]
    for m in mods:
        m.redistribute_local_tensor = counted
    try:
        yield n
    finally:
        for m in mods:
            m.redistribute_local_tensor = orig


def count_dispatch(torch, fn) -> tuple[int, int]:
    """(aten ops dispatched, DTensor redistributions) while ``fn`` runs: a
    ``TorchDispatchMode`` counts the ops (on a ``DTensor`` the op itself,
    not the local ops it becomes), :func:`counted_redistributions` the
    placement changes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[0] += 1
            return func(*args, **(kwargs or {}))

    with counted_redistributions() as redist, Count():
        fn()
    return ops[0], redist[0]


def time_mesh_ticks(torch, engines: dict, fab, rng, cfg) -> dict:
    """Each engine (by tag) filled to its lanes with 32-token prompts, then
    its decode tick timed with CUDA events (10 ticks, plain and carrying a
    decision) and one tick's aten ops and DTensor redistributions
    counted."""
    out = {}
    for tag, eng in engines.items():
        for _ in range(eng.lanes):
            prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
            require(eng.admit(prompt, 64) is not None,
                    f"dist-serve timing: {tag} refused an admission")
        for _ in range(2):
            eng.decode_tick()
        tick_ms = cuda_time_ms(torch, eng.decode_tick, iters=10, warmup=0)
        avg = rng.integers(1, 8, eng.lanes).astype(np.float64)
        ex = rng.integers(1, 64, (eng.lanes, fab.num_pes)).astype(np.float64)
        fused_ms = cuda_time_ms(torch, lambda: eng.decode_tick((avg, ex, fab)),
                                iters=10, warmup=0)
        ops, redist = count_dispatch(torch, eng.decode_tick)
        out[tag] = {"lanes": eng.lanes, "tick_ms": tick_ms,
                    "fused_tick_ms": fused_ms, "aten_ops_per_tick": ops,
                    "redistributions_per_tick": redist}
    return out


def phase_dist_serve(torch, K, cfg, params, seed: int, card: str) -> dict:
    """deepseek-7b at full width served by a (1, 1) mesh-backed replica
    (``mesh_backed_fleet`` over an ``nccl`` world of one process) and two
    meshless replicas on the same weights, behind ``HeftFrontEnd
    .run_continuous(fused=True)`` on ``MappingFabric(3, backend="fused")``:
    8 requests of 8-47 tokens, 16 new tokens, four lanes.  Checks: every
    request bitwise the dense meshless ``generate``, every in-tick decision
    bitwise ``decision_ref``, ``fused_decision`` launched inside the meshed
    replica's ticks, pages allocated == freed, the replica's parameters
    ``DTensor``s on its mesh, and a ``reshard(None)`` and back to (1, 1) in
    mid-generation leaving the tokens bitwise unchanged.  Then the meshed
    tick is timed beside the meshless one."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import init_world
    from repro_torch.sched_integration import MappingFabric
    from repro_torch.serve import (HeftFrontEnd, ReplicaHandle, ServeEngine,
                                   mesh_backed_fleet)

    rank, world = init_world("nccl" if DEVICE == "cuda" else "gloo",
                             device=DEVICE)
    require(world == 1, f"dist-serve runs at world size 1, got {world}")
    meshed = mesh_backed_fleet(cfg, params, [(1, 1)], max_len=SERVE_MAX_LEN,
                               lanes=SERVE_MAX_BATCH, device=DEVICE)[0]
    eng = meshed.engine
    require(all(isinstance(p, DTensor) and p.device_mesh is eng.mesh
                for p in eng.params.parameters()),
            "dist-serve: the replica's parameters are not DTensors on its "
            "mesh")
    fleet = [meshed] + [
        ReplicaHandle(f"replica{i}(x{s})",
                      ServeEngine(cfg, params, max_len=SERVE_MAX_LEN,
                                  lanes=SERVE_MAX_BATCH), speed=s)
        for i, s in enumerate(SERVE_SPEEDS[1:], start=1)]
    fab = MappingFabric(len(fleet), backend="fused", device=DEVICE,
                        device_counters=True)
    front = HeftFrontEnd(fleet, fabric=fab)
    rng = np.random.default_rng(seed)
    requests = serve_requests(rng, cfg.vocab_size)
    arrivals = [min(i, 2 * SERVE_NEW_TOKENS // 3)
                for i in range(len(requests))]
    staged, decided, host = record_decisions(fab)
    in_mesh = [0, 0]                      # meshed ticks, their launches
    tick = eng.decode_tick

    def meshed_tick(sched=None):
        before = K.launch_counts()["fused_decision"]
        out = tick(sched)
        in_mesh[0] += 1
        in_mesh[1] += K.launch_counts()["fused_decision"] - before
        return out

    eng.decode_tick = meshed_tick
    K.reset_launch_counts()
    t0 = time.perf_counter()
    outs, stats = front.run_continuous(
        requests, arrival_ticks=arrivals, max_batch=SERVE_MAX_BATCH,
        page_size=SERVE_PAGE_SIZE, fused=True)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    del eng.decode_tick
    unwrap(fab)
    require(in_mesh[1] > 0, f"dist-serve: fused_decision never launched in "
                            f"the meshed replica's {in_mesh[0]} ticks")
    require(counts["fused_decision"] == len(decided) + len(host),
            f"dist-serve: {counts['fused_decision']} launches for "
            f"{len(decided)} decision ticks + {len(host)} host events")
    require(stats["allocated"] == stats["freed"] > 0,
            f"dist-serve: pages {stats['allocated']} != {stats['freed']}")
    check_decisions(torch, staged, decided, fab.num_pes)
    dense = fleet[1].engine
    for i, (prompt, nt) in enumerate(requests):
        require(np.array_equal(outs[i], dense.generate(prompt[None, :],
                                                       nt)[0]),
                f"dist-serve: request {i} differs from the dense meshless "
                f"generate")
    # a live migration off the mesh and back, mid-generation
    prompt, nt = requests[0]
    slot = eng.admit(prompt, nt)
    for _ in range(5):
        eng.decode_tick()
    mesh = eng.mesh
    eng.reshard(None)
    require(not any(isinstance(p, DTensor) for p in eng.params.parameters()),
            "dist-serve: reshard(None) left DTensor parameters")
    for _ in range(3):
        eng.decode_tick()
    eng.reshard(mesh)
    meshed.sync_mesh_identity()
    while not eng.finished_slots():
        eng.decode_tick()
    require(np.array_equal(eng.retire(slot), outs[0]),
            "dist-serve: tokens changed across reshard(None) and back")
    require(meshed.mesh_shape == (1, 1), "dist-serve: mesh identity")
    new = sum(n for _, n in requests)
    log(f"[dist-serve] {card} | run_continuous over a (1, 1) mesh-backed "
        f"replica + 2 meshless: {len(requests)} requests, {new} new tokens "
        f"in {wall:.3f} s ({new / wall:.1f} tokens/s), {stats['ticks']} "
        f"ticks, decisions {stats['fused_decisions']} in-tick / "
        f"{stats['host_decisions']} host, fused_decision {in_mesh[1]} "
        f"launches in {in_mesh[0]} meshed ticks, pages {stats['allocated']} "
        f"== {stats['freed']}; every request bitwise the dense generate, "
        f"every decision bitwise decision_ref, reshard(None) and back "
        f"bitwise")
    timing = time_mesh_ticks(torch, {"meshed": eng, "meshless":
                                     fleet[1].engine}, fab, rng, cfg)
    m, p = timing["meshed"], timing["meshless"]
    log(f"[dist-serve] {card} | decode tick at {m['lanes']} lanes: meshed "
        f"{m['tick_ms']:.6f} ms ({m['aten_ops_per_tick']} aten ops, "
        f"{m['redistributions_per_tick']} DTensor redistributions a tick), "
        f"meshless {p['tick_ms']:.6f} ms ({p['aten_ops_per_tick']} aten "
        f"ops); carrying a decision: meshed {m['fused_tick_ms']:.6f} ms, "
        f"meshless {p['fused_tick_ms']:.6f} ms")
    return {"card": card, "wall_s": wall, "new_tokens": new,
            "ticks": stats["ticks"], "launches": counts,
            "meshed_ticks": in_mesh[0], "meshed_launches": in_mesh[1],
            "fused_decisions": stats["fused_decisions"],
            "host_decisions": stats["host_decisions"],
            "pages": stats["allocated"], "timing": timing}


# ---------------------------------------------------------------------------
# phase: chaos (the serve launcher's --chaos path at full width)
# ---------------------------------------------------------------------------

# A replica loss named by a unique prefix of replica 1, replica 2 at half
# speed for 1 s (a straggler's slowdown factor of 2), and a degraded spine
# link: every kind of event the twin replays, the link on its spine.
CHAOS_TIMELINE = {"events": [
    {"t": 0.8, "kind": "replica_loss", "target": "replica1"},
    {"t": 0.3, "kind": "straggler", "target": "replica2", "duration_s": 1.0,
     "factor": 2.0},
    {"t": 0.2, "kind": "link_degrade", "target": "pod0:spine",
     "duration_s": 1.0, "factor": 0.5},
]}
CHAOS_SLO_S = 2.0
TWIN_KEYS = ("goodput", "goodput_clean", "requeued", "unserved")


def phase_chaos(torch, K, card: str) -> dict:
    """``repro_torch.launch.serve.main`` as a user runs it: deepseek-7b at
    full width (``--full-width``), ``--paged --fused-scheduler``, 8
    requests, ``--chaos`` on :data:`CHAOS_TIMELINE`, ``--min-goodput 90``.
    The launcher itself checks request 0 against the dense oracle and the
    failover re-serve token for token (``SystemExit`` otherwise).  Here:
    no ``SystemExit``, the published widths, ``fused_decision`` launched in
    the ticks and ``heft_fused`` by the twin's policy, and the twin's
    goodput, re-queued and unserved counts on the card equal to the same
    twin on the CPU, in the card's float32 arithmetic (the kernels' plain
    version) and on the float64 host path."""
    import tempfile
    from types import SimpleNamespace

    from repro_torch.launch import serve as launcher
    from repro_torch.sched_integration import (load_failure_timeline,
                                               make_policy_fabric)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "chaos.json"
        path.write_text(json.dumps(CHAOS_TIMELINE))
        argv = ["--arch", "deepseek-7b", "--full-width", "--paged",
                "--fused-scheduler", "--requests", str(SERVE_REQUESTS),
                "--chaos", str(path), "--min-goodput", "90",
                "--slo-s", str(CHAOS_SLO_S)]
        if DEVICE != "cuda":
            argv += ["--device", DEVICE]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out = launcher.main(argv)
        except SystemExit as e:
            raise AssertionError(f"the chaos run exited: {e}") from e
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        fleet = [SimpleNamespace(name=f"replica{i}(x{s})", speed=s)
                 for i, s in enumerate(SERVE_SPEEDS)]
        timeline = launcher._resolve_targets(
            load_failure_timeline(str(path)), [r.name for r in fleet])
    require((out["layers"], out["params"]) == (30, 6910365696),
            f"the chaos run was not at full width: {out['arch']}")
    chaos = out["chaos"]
    require(chaos["failover"]["token_identical"]
            and chaos["failover"]["lost"] == "replica1(x0.7)",
            f"failover: {chaos['failover']}")
    require(counts["fused_decision"] > 0,
            "fused_decision never launched in the chaos run's ticks")
    require(counts["heft_fused"] > 0,
            "heft_fused never launched by the chaos twin's policy")
    cpu32 = launcher.chaos_twin(
        timeline, fleet, CHAOS_SLO_S,
        policy=lambda: make_policy_fabric("torch", device="cpu"))
    cpu64 = launcher.chaos_twin(timeline, fleet, CHAOS_SLO_S, device="cpu")
    for tag, cpu in (("float32", cpu32), ("float64", cpu64)):
        require(all(chaos[k] == cpu[k] for k in TWIN_KEYS),
                f"chaos twin on the card {chaos} != the CPU's {tag} run "
                f"{cpu}")
    log(f"[chaos] {card} | deepseek-7b at full width ({out['params']} "
        f"parameters), {len(out['outputs'])} requests paged + fused, "
        f"{chaos['failures']} failures: goodput {chaos['goodput']}/"
        f"{chaos['goodput_clean']} ({chaos['pct']:.1f}% of failure-free; "
        f"min 90), {chaos['requeued']} re-queued, {chaos['unserved']} "
        f"unserved (equal to the CPU twin, float32 and float64); failover "
        f"lost {chaos['failover']['lost']}, re-served token-identically; "
        f"launches {counts}; wall {wall:.3f} s")
    return {"card": card, "wall_s": wall, "launches": counts,
            "twin": {k: chaos[k] for k in ("failures", "pct") + TWIN_KEYS},
            "failover": chaos["failover"]}


# ---------------------------------------------------------------------------
# phase: dryrun (launch/dryrun.py over a fake-rank mesh, in subprocesses)
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "deepseek-7b"
# (arch, shape, meshes): deepseek-7b's serving and training cells, yi-34b's
# padded heads (56 / 8 over 16: 64 / 16) and deepseek-v2's MLA with the
# batch over data
DRYRUN_CELLS = (("deepseek-7b", "decode_32k", "both"),
                ("deepseek-7b", "prefill_32k", "single"),
                ("deepseek-7b", "train_4k", "both"),
                ("yi-34b", "decode_32k", "single"),
                ("deepseek-v2-236b", "decode_32k", "single"))
DRYRUN_TIMEOUT_S = 600
CARD_DECODE_LANES, CARD_DECODE_CACHE = 4, 2048


def run_dryrun_cells() -> tuple[dict, Path]:
    """The dry run's CLI for :data:`DRYRUN_CELLS`, one process each (a fake
    world needs a process of its own), all at once, through
    ``launch.dryrun.run_cells``; returns the cells and their directory."""
    from repro_torch.launch import dryrun

    keys = [(arch, shape, kind) for arch, shape, mesh in DRYRUN_CELLS
            for kind in (("single", "multi") if mesh == "both" else (mesh,))]
    res = dryrun.run_cells([(a, s, k == "multi") for a, s, k in keys],
                           jobs=len(keys), timeout=DRYRUN_TIMEOUT_S)
    cells = dict(zip(keys, res))
    for key, cell in cells.items():
        require("error" not in cell,
                f"dry-run cell {key} failed: {cell.get('error')}\n"
                f"{cell.get('traceback')}")
    return cells, Path(dryrun.ARTIFACT_DIR)


DRYRUN_FLOP_SLACK = 1.25


def dryrun_flop_bounds(cell: dict) -> tuple[float, float]:
    """(lowest, highest) FLOPs rank 0 of a dry-run cell may count, from the
    config alone (heads padded over the model axis of 16 where it does not
    divide them, as the cell ran them; no function of the dry run or of
    the MoE dispatch is used).

    ``T`` tokens (``B`` a decode, ``B · S`` otherwise), ``N`` the active
    parameters.  Floor: the weights' products, 2 FLOPs a token for each
    active weight it multiplies (3x that to train: 6·N·T), which leaves
    out the looked-up embedding rows (untied), the vectors (norms, biases,
    Mamba's ``D``), Mamba's elementwise ``A_log`` and its conv of shifted
    adds, and a prefill's head on all but its last token.  Ceiling: :data:`DRYRUN_FLOP_SLACK` x (every
    weight on every token, with the routed experts on the dispatch's
    capacity rows in place of their ``top_k`` + attention); to train, 4x
    the products (forward, remat's second forward, a backward of twice a
    forward) and 5x attention (the ``differentiable`` q-block recompute's
    third forward too).

    * Capacity rows of a MoE layer: ``G`` groups of ``T / G`` tokens, each
      giving each of the ``E`` experts ``C = max(4, ⌊cf · (T / G) · K /
      E⌋)`` rows (the reference's formula).  ``G · E · C ≤ max(cf · T · K,
      4 · E · G)``, which grows with ``G``.  ``G`` is ``B · 16`` to train
      and prefill (the reference's ``activation_hint_policy`` pins
      ``__moe_groups__`` to the batch x the model axis); a decode's is at
      most ``min(T, max(min(T / 8, 256), batch ranks))`` (the
      reference's ``_num_groups``, raised to the batch's ranks where they
      split the groups, and never more groups than tokens).  The experts' weights, ``(params - active) · E / (E - K)``,
      are ``1 / E`` a row.
    * Attention a token and attention layer: GQA ``4 · S · H · hd`` (QK^T
      and PV over every key); MLA's absorbed decode ``2 · S · H · (2 ·
      kv_lora + rope)``, its prefill and train ``2 · S · H · (nope + rope
      + v)``; a Mamba layer's scan ``2 · d_inner · d_state``.
    * A batch the batch axes do not split (``batch_sharded`` False) runs
      whole on each of their ranks: the ceiling divides over ``n / batch
      ranks`` devices, not ``n``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import padded_config
    from repro_torch.models.config import SHAPES
    from repro_torch.models.model import param_shapes

    cfg = padded_config(get_config(cell["arch"]), 16)
    sc = SHAPES[cell["shape"]]
    n = cell["num_devices"]
    batch_ranks = n // 16
    B, S = sc.global_batch, sc.seq_len
    T = B * (1 if sc.kind == "decode" else S)
    train = sc.kind == "train"
    N, total = cfg.active_param_count(), cfg.param_count()
    head = cfg.vocab_size * cfg.d_model
    unmultiplied = (0 if cfg.tie_embeddings else head) + sum(
        math.prod(sh) for name, sh in param_shapes(cfg).items()
        if len(sh) == 1 or name.split(".")[-1] in ("A_log", "conv_w"))
    floor = 2 * (N - unmultiplied) * T
    if sc.kind == "prefill":
        floor -= 2 * head * (T - B)
    floor *= 3 if train else 1
    products = 2 * N * T
    if cfg.moe is not None:
        E, K, cf = (cfg.moe.num_experts, cfg.moe.top_k,
                    cfg.moe.capacity_factor)
        experts = (total - N) * E // (E - K)
        G = (B * 16 if sc.kind != "decode"
             else min(T, max(min(T // 8, 256), batch_ranks)))
        rows = max(cf * T * K, 4 * E * G)
        products += 2 * experts / E * rows - 2 * experts * K // E * T
    H, hd = cfg.num_heads, cfg.head_dim
    if cfg.attn_type == "mla":
        R, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        per = (2 * S * H * (2 * R + rope) if sc.kind == "decode" else
               2 * S * H * (cfg.qk_nope_head_dim + rope + cfg.v_head_dim))
    else:
        per = 4 * S * H * hd
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    scan = 2 * cfg.ssm.d_inner * cfg.ssm.d_state if cfg.ssm else 0
    attn = T * (kinds.count("attn") * per + kinds.count("mamba") * scan)
    few = n if cell.get("batch_sharded", True) else n // batch_ranks
    top = 4 * products + 5 * attn if train else products + attn
    return floor / n, DRYRUN_FLOP_SLACK * top / few


def check_dryrun_cells(cells: dict, art: Path) -> dict:
    """Rank 0's FLOPs of each cell within :func:`dryrun_flop_bounds`, the
    heads it ran those of ``padded_config`` over the model axis of 16; the
    cells cover a (deepseek-7b, (16, 16)) replica in
    ``CostModelRegistry``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import padded_config
    from repro_torch.sched_integration import CostModelRegistry, Replica

    out = {}
    for (arch, shape_name, mesh), cell in cells.items():
        cfg = padded_config(get_config(arch), 16)
        require(list(cell["run_heads"]) == [cfg.num_heads, cfg.num_kv_heads],
                f"{arch}: the cell ran heads {cell['run_heads']}")
        n = cell["num_devices"]
        lo, hi = dryrun_flop_bounds(cell)
        flops = cell["flops_per_device"]
        require(lo <= flops <= hi,
                f"{arch} {shape_name} x {cell['mesh']}: {flops:.6e} FLOPs a "
                f"device outside [{lo:.6e}, {hi:.6e}]")
        coll = cell["collectives"]
        out[f"{arch}_{shape_name}_{mesh}"] = dict(
            {k: cell[k] for k in ("mesh", "num_devices", "flops_per_device",
                                  "bytes_accessed_per_device", "ops",
                                  "trace_s", "wall_s", "run_heads")},
            flops_lo=lo, flops_hi=hi,
            wire_bytes=coll["total_wire_bytes_per_device"],
            collectives=coll["count_by_op"])
        log(f"[dryrun] {arch} {shape_name} x {cell['mesh']} ({n} fake "
            f"ranks, heads {cell['run_heads']}): {flops:.6e} FLOPs a device "
            f"(bounds {lo:.6e} .. {hi:.6e}; {flops / lo:.6f} x the floor, "
            f"{flops / hi:.6f} x the ceiling), "
            f"{cell['bytes_accessed_per_device']:.6e} bytes, "
            f"{coll['total_wire_bytes_per_device']:.6e} wire bytes "
            f"{coll['count_by_op']}, {cell['ops']} ops recorded in "
            f"{cell['trace_s']} s ({cell['wall_s']} s its process)")
    reg = CostModelRegistry()
    out["registered"] = reg.load_dir(str(art))
    require(reg.covers(Replica("dryrun", 1.0, 1.0, arch=DRYRUN_ARCH,
                               mesh_shape=(16, 16))),
            "the dry-run cells do not cover a (deepseek-7b, 16x16) replica")
    return out


def card_decode_counts(torch, cfg, seed: int, card: str) -> dict:
    """The recorder around one real ``decode_step`` of ``cfg`` on the card
    at 4 lanes and a 2048-token cache counts the FLOPs, bytes and ops it
    counts on ``meta`` stand-ins at those shapes; the step is timed beside
    its counted bytes at 3.35 TB/s."""
    from repro_torch.launch.cost_analysis import CostRecorder, summarize_step
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import decode_step, init_cache

    params, build = build_model(torch, cfg, seed, "dryrun")
    B, S = CARD_DECODE_LANES, CARD_DECODE_CACHE
    caches = init_cache(cfg, B, S, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    pos = torch.tensor(S // 2, dtype=torch.int32, device=DEVICE)
    args = (params, caches, tokens, pos)
    with torch.no_grad(), CostRecorder() as rec:
        logits, _ = decode_step(*args, cfg)
    real = summarize_step(rec.records, args, (logits, caches))
    meta = trace_cell(cfg, ShapeConfig("card", "decode", S, B))
    for key in ("flops_per_device", "bytes_accessed_per_device", "ops",
                "ops_by_name"):
        require(real[key] == meta[key],
                f"{key}: the card counted {real[key]}, meta {meta[key]}")
    require(bool(torch.isfinite(logits.float()).all()),
            "the card's decode step gave non-finite logits")

    def step():
        with torch.no_grad():
            decode_step(*args, cfg)

    ms = cuda_time_ms(torch, step, iters=5)
    bytes_ms = real["bytes_accessed_per_device"] / HBM_BYTES_PER_S * 1e3
    log(f"[dryrun] {card} | a full-width decode_step at {B} lanes and a "
        f"{S}-token cache: {real['ops']} ops, "
        f"{real['flops_per_device']:.6e} FLOPs, "
        f"{real['bytes_accessed_per_device']:.6e} bytes counted on the card "
        f"== on meta stand-ins; {ms:.6f} ms a step (CUDA events) beside "
        f"{bytes_ms:.6f} ms for its counted bytes at 3.35 TB/s")
    return {"lanes": B, "cache": S, "flops": real["flops_per_device"],
            "bytes": real["bytes_accessed_per_device"], "ops": real["ops"],
            "ms": ms, "counted_bytes_ms": bytes_ms, "build": build}


def phase_dryrun(torch, seed: int, card: str) -> dict:
    """The :data:`DRYRUN_CELLS` of ``python -m repro_torch.launch.dryrun``
    with no error, held by :func:`check_dryrun_cells`; then
    :func:`card_decode_counts` at full width on the card."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cells, art = run_dryrun_cells()
    cells_s = time.perf_counter() - t0
    cfg = get_config(SERVE_ARCH)
    check_widths(cfg, SERVE_ARCH)
    out = {"cells_wall_s": cells_s, "cells": check_dryrun_cells(cells, art)}
    out["card_decode"] = card_decode_counts(torch, cfg, seed, card)
    return out


# ---------------------------------------------------------------------------
# phase: examples (examples/port/ as subprocesses, card against CPU)
# ---------------------------------------------------------------------------

# Each example, and the part of its output whose numbers (decisions,
# SimResults) must be the same on the card and on the CPU: all of it, or
# what precedes a marker (serve_elastic's live engines print tokens of a
# model whose GEMMs round differently on the card; train_pod_compressed
# prints losses, for the same reason: those are checked by the runs'
# own assertions and the train / dist-train phases).
EXAMPLES = {"cedr_runtime_demo": "", "quickstart": "",
            "serve_with_heft": "", "serve_elastic": "== live ServeEngine",
            "train_pod_compressed": None}
EXAMPLE_TIMEOUT_S = 600
EXAMPLE_JOBS = 6                # processes at once (the dist ones spawn more)
NUMBER = re.compile(r"-?\d+(?:\.\d+)?|True|False")


def compared_part(text: str, upto: str) -> str:
    return text.split(upto)[0] if upto else text


def phase_examples(card: str) -> dict:
    """Each example of ``examples/port/`` on the card, and with ``--device
    cpu`` twice: in the card's float32 arithmetic
    (``REPRO_TORCH_FABRIC_BACKEND=torch``, the kernels' plain version) and
    on the default float64 host path (the reference's numbers).  Up to
    :data:`EXAMPLE_JOBS` at once; each must exit 0, and the numbers of the
    compared part of the card run's output (:data:`EXAMPLES`) must equal
    the float32 CPU run's.  Where the float64 run differs (a near-tie that
    float32 breaks the other way), the lines are printed."""
    root = Path(__file__).resolve().parent
    base = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = {"card": ([] if DEVICE == "cuda" else ["--device", DEVICE], base),
            "cpu32": (["--device", "cpu"],
                      dict(base, REPRO_TORCH_FABRIC_BACKEND="torch",
                           OMP_NUM_THREADS="1")),
            "cpu64": (["--device", "cpu"], dict(base, OMP_NUM_THREADS="1"))}
    queue = [(name, tag) for name in EXAMPLES for tag in runs]
    running, outs = {}, {}
    t0 = time.perf_counter()
    try:
        while queue or running:
            while queue and len(running) < EXAMPLE_JOBS:
                name, tag = queue.pop(0)
                extra, env = runs[tag]
                running[(name, tag)] = subprocess.Popen(
                    [sys.executable,
                     str(root / "examples" / "port" / f"{name}.py"), *extra],
                    env=env, cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            key = next(iter(running))
            outs[key] = running[key].communicate(
                timeout=max(1.0, EXAMPLE_TIMEOUT_S
                            - (time.perf_counter() - t0)))
            outs[key] = (running.pop(key).returncode, *outs[key])
    finally:
        for p in running.values():
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    res = {"wall_s": wall}
    for name, upto in EXAMPLES.items():
        for tag in runs:
            rc, _, err = outs[(name, tag)]
            require(rc == 0, f"{name} ({tag}) exited {rc}: {err[-3000:]}")
        text = {tag: outs[(name, tag)][1] for tag in runs}
        entry = {"lines": len(text["card"].splitlines())}
        if upto is not None:
            nums = {tag: NUMBER.findall(compared_part(text[tag], upto))
                    for tag in runs}
            require(nums["card"] == nums["cpu32"] and len(nums["card"]) > 20,
                    f"{name}: the card printed\n{text['card']}\nthe float32 "
                    f"CPU run\n{text['cpu32']}")
            diff = [(a, b) for a, b in zip(
                        compared_part(text["card"], upto).splitlines(),
                        compared_part(text["cpu64"], upto).splitlines())
                    if NUMBER.findall(a) != NUMBER.findall(b)]
            entry.update(numbers=len(nums["card"]),
                         float64_lines_differ=diff)
            log(f"[examples] {name}: card == --device cpu (float32), "
                f"{len(nums['card'])} numbers; the float64 host run differs "
                f"on {len(diff)} line(s)"
                + "".join(f"\n  card:    {a}\n  float64: {b}"
                          for a, b in diff))
        else:
            log(f"[examples] {name}: exit 0 on the card and on the CPU")
        res[name] = entry
    log(f"[examples] {card} | {len(EXAMPLES)} examples x 3 runs, "
        f"{EXAMPLE_JOBS} at once: wall {wall:.3f} s")
    return res


# ---------------------------------------------------------------------------
# phase: tp-train (the tensor-parallel step at full width on a (1, 1, 1) mesh)
# ---------------------------------------------------------------------------

TP_STEPS = 2


def phase_tp_train(torch, seed: int, card: str, evidence: dict,
                   meshless: dict) -> dict:
    """deepseek-7b at its published widths and depth (bf16, int8 moments,
    remat, ``TokenPipeline`` 4 x 512) trained ``TP_STEPS`` steps by the
    tensor-parallel ``make_train_step(pod_axis="pod", mesh=)`` on a (pod,
    data, model) = (1, 1, 1) mesh over an ``nccl`` world of this one
    process: every op a ``DTensor`` op (the vocab-parallel embedding and
    cross-entropy, the local-shard pod reduction, AdamW on ``DTensor``
    leaves), no collective that moves data.  Step 1's loss, ce and
    grad_norm and every parameter after step ``TP_STEPS`` must equal the
    meshless train phase's on the same seed, bit for bit (``evidence``:
    its step metrics and host copies of its parameters).  A third step is
    counted: its aten ops and ``DTensor`` redistributions."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import TrainLayout

    init_world("nccl" if DEVICE == "cuda" else "gloo", device=DEVICE)
    cfg = get_config(FULL_ARCH)
    check_widths(cfg, FULL_ARCH)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, out = build_model(torch, cfg, seed, "tp-train")
    mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"),
                           device=DEVICE)
    lay = TrainLayout(cfg, mesh)
    opt_cfg = full_opt_config()
    opt = lay.place_opt(init_opt_state(dict(params.named_parameters()),
                                       opt_cfg), opt_cfg.moment_dtype)
    placed = lay.place_params(params)
    del params
    require(all(isinstance(p, DTensor) for p in placed.parameters()),
            "[tp-train] a parameter is not a DTensor")
    step = make_train_step(cfg, opt_cfg, pod_axis="pod", mesh=mesh,
                           layout=lay)
    pipe = full_pipeline(cfg, seed)
    steps = []
    for s in range(TP_STEPS):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in pipe.batch_at(s).items()}
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed, opt, _, met = step(placed, opt, None, batch)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        rec = {k: float(met[k]) for k in ("loss", "ce", "grad_norm", "lr")}
        rec["s"] = time.perf_counter() - t0
        steps.append(rec)
        log(f"[tp-train] {cfg.name} step {s + 1}: loss {rec['loss']:.6f} ce "
            f"{rec['ce']:.6f} grad_norm {rec['grad_norm']:.6f}, "
            f"{rec['s']:.6f} s (meshless {evidence['steps'][s]['s']:.6f} s)")
    want = evidence["steps"][0]
    for k in ("loss", "ce", "grad_norm"):
        require(steps[0][k] == want[k],
                f"[tp-train] step 1 {k} {steps[0][k]!r} against the meshless "
                f"{want[k]!r}")
    differ = {}
    for n, p in placed.named_parameters():
        local = p.to_local().detach().cpu()
        if not torch.equal(local, evidence["params"][n]):
            differ[n] = float((local.float()
                               - evidence["params"][n].float()).abs().max())
    require(not differ, f"[tp-train] parameters after step {TP_STEPS} that "
                        f"differ from the meshless run's: {differ}")
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in pipe.batch_at(TP_STEPS).items()}
    ops, redist = count_dispatch(torch, lambda: step(placed, opt, None,
                                                     batch))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    out.update({"card": card, "mesh": [1, 1, 1], "steps": steps,
                "meshless_steps": evidence["steps"],
                "meshless_step_s_median_2_4": meshless["step_s_median_2_4"],
                "bitwise_params": len(evidence["params"]),
                "aten_ops_per_step": ops, "redistributions_per_step": redist,
                "peak_bytes": peak})
    log(f"[tp-train] {card} | {cfg.name} on a (1, 1, 1) (pod, data, model) "
        f"mesh: step 1's loss / ce / grad_norm and all "
        f"{len(evidence['params'])} parameters after step {TP_STEPS} bitwise "
        f"the meshless train phase's; step {TP_STEPS} "
        f"{steps[-1]['s']:.6f} s against the meshless "
        f"{evidence['steps'][TP_STEPS - 1]['s']:.6f} s (median of its steps "
        f"2-{FULL_STEPS} {meshless['step_s_median_2_4']:.6f} s); a step "
        f"dispatches {ops} aten ops with {redist} DTensor redistributions; "
        f"peak memory {peak} bytes")
    return out


# ---------------------------------------------------------------------------
# phase: dist-train (two ranks on the one card over gloo, pod = 2)
# ---------------------------------------------------------------------------

DIST_ARCH = "deepseek_7b"
DIST_LAYERS = 4                 # of 30: two ranks' state fits the card
DIST_STEPS, DIST_BATCH, DIST_SEQ, DIST_LR = 2, 4, 512, 3e-3
DIST_TIMEOUT_S = 600
DIST_SMOKE_STEPS = 3


def dist_config(layers: int):
    """deepseek-7b at its published widths, cut to ``layers`` layers."""
    from repro_torch.configs import get_config
    full = get_config(DIST_ARCH)
    check_widths(full, DIST_ARCH)
    return full.with_(num_layers=layers)


def bits_checksum(torch, params) -> list[int]:
    """One int64 a parameter: its bit patterns weighted by position, so two
    ranks' parameters agree in these exactly when (with near certainty)
    they are bitwise equal."""
    out = []
    for p in params.parameters():
        bits = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32).to(
            torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(int((bits * w).sum()))
    return out


def rounded_bits(torch, model, seed: int):
    """``model`` with every nonzero bf16 weight moved one unit of its last
    place up or down (random signs from ``seed``): one rounding."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            ints = torch.int16 if p.element_size() == 2 else torch.int32
            step = torch.randint(0, 2, p.shape, generator=g,
                                 device=p.device, dtype=ints) * 2 - 1
            p.view(ints).add_(torch.where(p != 0, step,
                                          torch.zeros_like(step)))
    return model


def model_grads(torch, cfg, model, tokens, labels) -> dict:
    """``{name: d loss / d param}`` of ``model`` on these rows (the loss the
    train step differentiates)."""
    from repro_torch.models.model import loss_fn
    names, leaves = zip(*model.named_parameters())
    with torch.enable_grad():
        loss, _ = loss_fn(model, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return dict(zip(names, grads))


def check_pod_reductions(torch, cfg, group, rank: int, seed: int,
                         batch: dict) -> dict:
    """The pod reductions held on real gradients (two ranks, collective).

    Each rank takes the gradient of its half of ``batch`` at the initial
    weights and reduces it with ``psum_mean`` and ``compressed_psum_mean``
    (timed; a cold residual, as at step 1).  Rank 1 sends its gradient to
    rank 0, which holds, entry by entry against the exact mean ``m`` of the
    two ranks' gradients (f32): the exact result within one bf16 rounding,
    ``2**-8 |m|`` (gloo sums the bf16 pair and rounds once; the halving is
    exact); the int8 result within half an int8 step of its scale group's
    absmax over both ranks, plus one bf16 rounding of the result.  Then,
    leaf by leaf, ``m`` against the whole-batch gradient, ``|m - g| / |g|``
    (2-norms), within ``ROUND_FACTOR`` times what one bf16 rounding of the
    weights moves the whole-batch gradient by (two draws).  A reduction
    that kept one rank's half, forgot the ``/ n``, flipped the sign or
    returned zeros misses these by orders of magnitude.  Returns rank 0's
    record (``{}`` on rank 1)."""
    import torch.distributed as dist

    from repro_torch.dist import compressed_psum_mean, psum_mean
    from repro_torch.models import init_params
    from repro_torch.train.trainer import scale_groups

    def fresh():
        m = init_params(cfg, torch.Generator(device=DEVICE)
                        .manual_seed(seed), device=DEVICE)
        m.requires_grad_(True)
        return m

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    tokens, labels = batch["tokens"], batch["labels"]
    rows = tokens.shape[0] // 2
    own = slice(rank * rows, (rank + 1) * rows)
    model = fresh()
    grads = model_grads(torch, cfg, model, tokens[own], labels[own])
    groups = scale_groups(cfg, grads)
    outs, seconds = {}, {}
    for kind in ("exact", "compressed"):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        if kind == "exact":
            outs[kind] = psum_mean(grads, group)
        else:
            outs[kind], _ = compressed_psum_mean(grads, group, None, groups)
        sync()
        seconds[kind] = time.perf_counter() - t0
    peer = {}
    for n, g in grads.items():
        buf = g if rank == 1 else torch.empty_like(g)
        dist.broadcast(buf.view(-1).view(torch.uint8), src=1)  # raw bits
        if rank == 0:
            peer[n] = buf
    if rank == 1:
        return {}

    amax: dict = {}
    for n in grads:
        key = groups[n]
        amax[key] = max(amax.get(key, 0.0),
                        float(grads[n].abs().max()), float(peer[n].abs().max()))
    def worst(err, bound):
        """max err / bound (0 / 0 counts 0, x / 0 infinite)."""
        r = torch.where(bound > 0, err / bound.clamp_min(1e-38),
                        torch.where(err > 0, math.inf, 0.0))
        return float(r.max())

    exact_ratio = comp_ratio = 0.0
    for n in grads:
        m = (grads[n].float() + peer[n].float()) / 2
        ex = outs["exact"][n].float()
        exact_ratio = max(exact_ratio, worst(
            (ex - m).abs(), 2.0 ** -8 * m.abs() * (1 + 2.0 ** -16)))
        cp = outs["compressed"][n].float()
        scale = max(amax[groups[n]], 1e-30) / 127
        comp_ratio = max(comp_ratio, worst(
            (cp - m).abs(), 0.5 * scale * (1 + 2.0 ** -10)
            + 2.0 ** -8 * cp.abs() * (1 + 2.0 ** -6)))
    del outs
    whole = model_grads(torch, cfg, model, tokens, labels)
    norms = {n: float(g.float().norm()) for n, g in whole.items()}
    gaps = {n: float(((grads[n].float() + peer[n].float()) / 2
                      - whole[n].float()).norm()) for n in whole}
    del grads, peer, model
    spread = dict.fromkeys(whole, 0.0)
    for r in (1, 2):
        moved = model_grads(torch, cfg, rounded_bits(torch, fresh(), r),
                            tokens, labels)
        for n, g in moved.items():
            spread[n] = max(spread[n], float((g.float()
                                              - whole[n].float()).norm()))
        del moved
    worst, ratio = None, -math.inf
    for n in whole:
        if gaps[n] == 0:
            continue
        r = gaps[n] / spread[n] if spread[n] > 0 else math.inf
        if r > ratio:
            worst, ratio = n, r
    rel = {n: (gaps[n] / norms[n], spread[n] / norms[n])
           for n in whole if norms[n] > 0}
    del whole
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"reduction_s": seconds, "exact_err_over_bound": exact_ratio,
            "compressed_err_over_bound": comp_ratio,
            "whole_batch_worst_leaf": worst,
            "whole_batch_gap_over_spread": ratio,
            "whole_batch_rel_gap_max": max(g for g, _ in rel.values()),
            "rounding_rel_spread_min": min(sp for _, sp in rel.values())}


def _dist_train_worker(rank: int, world: int, store: str, out_dir: str,
                       layers: int, seed: int, device: str) -> None:
    """One pod of the dist-train phase (see :func:`phase_dist_train`)."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    # two ranks share the card: segments that grow leave less unused
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    import torch.distributed as dist
    global DEVICE
    DEVICE = device
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import Trainer, TrainerConfig, make_train_step

    if device == "cuda":
        torch.cuda.set_device(0)          # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_debug_mesh((world,), ("pod",), device=device)
    cfg = dist_config(layers)
    opt_cfg = AdamWConfig(moment_dtype="int8", learning_rate=DIST_LR)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=DIST_SEQ,
                                    global_batch=DIST_BATCH, seed=seed))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def batch_at(s):
        return {k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch_at(s).items()}

    rec = {"steps": {}, **check_pod_reductions(
        torch, cfg, mesh.get_group("pod"), rank, seed, batch_at(0))}
    if device == "cuda":
        torch.cuda.empty_cache()
    for kind, comp in (("exact", False), ("compressed", True)):
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(seed), device=device)
        params.requires_grad_(True)
        opt = init_opt_state(dict(params.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg, pod_axis="pod",
                               compress_pods=comp, mesh=mesh)
        residual, times, equal = None, [], []
        for s in range(DIST_STEPS):
            batch = batch_at(s)
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            params, opt, residual, met = step(params, opt, residual, batch)
            sync()
            times.append(time.perf_counter() - t0)
            sums = torch.tensor(bits_checksum(torch, params))
            gathered = [torch.zeros_like(sums) for _ in range(world)]
            dist.all_gather(gathered, sums)
            equal.append(all(torch.equal(g, sums) for g in gathered))
            require(np.isfinite(float(met["loss"])),
                    f"[dist-train] {kind} step {s + 1} loss {met['loss']}")
        rec["steps"][kind] = {"s": times, "ranks_bitwise_equal": equal,
                              "loss": float(met["loss"]),
                              "peak_bytes": (torch.cuda.max_memory_allocated()
                                             if device == "cuda" else 0)}
        if comp:
            res_ok = all(bool(torch.isfinite(e).all())
                         for e in residual.values())
            nonzero = any(bool((e != 0).any()) for e in residual.values())
            require(res_ok and nonzero,
                    f"[dist-train] residual finite {res_ok} nonzero "
                    f"{nonzero}")
            rec["residual_elems"] = sum(e.numel() for e in residual.values())
        del params, opt, residual, step
        if device == "cuda":
            torch.cuda.empty_cache()

    # a Trainer at smoke widths saves the residual with num_pods = 2; the
    # parent restores it at pod = 1
    from repro_torch.configs import get_smoke_config
    smoke = get_smoke_config(DIST_ARCH)
    tr = Trainer(smoke, AdamWConfig(learning_rate=DIST_LR),
                 DataConfig(vocab_size=smoke.vocab_size, seq_len=32,
                            global_batch=4, seed=seed),
                 TrainerConfig(total_steps=DIST_SMOKE_STEPS,
                               checkpoint_every=DIST_SMOKE_STEPS,
                               checkpoint_dir=f"{out_dir}/ckpt",
                               mesh_shape=(world,), compress_pods=True),
                 device=device)
    tr.run()
    if rank == 0:
        torch.save({n: e for n, e in tr.last_residual.items()},
                   f"{out_dir}/smoke_residual.pt")
        Path(f"{out_dir}/rank0.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def phase_dist_train(torch, seed: int, card: str,
                     layers: int = DIST_LAYERS) -> dict:
    """Two processes on the one card over a ``gloo`` group, a ``(2,)``
    mesh of pods: deepseek-7b at its published widths with ``layers`` of
    its 30 layers, bf16, AdamW with int8 moments, remat on,
    ``TokenPipeline`` batches of 4 x 512 tokens split over the pods; two
    steps of the exact pod step and two of the int8 error-feedback one.
    Checks: the two reductions on the ranks' real gradients
    (:func:`check_pod_reductions`); both ranks' parameters bitwise equal
    after every step; the residual finite and non-zero; a smoke-width
    Trainer's residual saved at pod = 2 and restored here at pod = 1 keeps
    Σe/n.  The step time and the reduction's alone
    are printed: gloo stages the card's tensors through the host, the only
    transport two ranks on one card have."""
    import shutil
    import torch.multiprocessing as mp

    work = Path(__file__).resolve().parent / "build" / "dist_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    free_card(torch)
    if DEVICE == "cuda":
        log(f"[dist-train] this process holds "
            f"{torch.cuda.memory_allocated()} bytes "
            f"({torch.cuda.memory_reserved()} reserved) as the ranks start")
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _dist_train_worker,
        args=(2, str(work / "store"), str(work), layers, seed, DEVICE),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            require(False, f"[dist-train] ranks still running after "
                           f"{DIST_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    rec = json.loads((work / "rank0.json").read_text())
    for kind, st in rec["steps"].items():
        require(all(st["ranks_bitwise_equal"]),
                f"[dist-train] {kind}: the two ranks' parameters differ "
                f"after a step: {st['ranks_bitwise_equal']}")
    require(rec["exact_err_over_bound"] <= 1,
            f"[dist-train] psum_mean {rec['exact_err_over_bound']} x one "
            f"bf16 rounding from the ranks' exact mean gradient")
    require(rec["compressed_err_over_bound"] <= 1,
            f"[dist-train] compressed_psum_mean "
            f"{rec['compressed_err_over_bound']} x (half an int8 step + one "
            f"bf16 rounding) from the ranks' exact mean gradient")
    require(rec["whole_batch_gap_over_spread"] <= ROUND_FACTOR,
            f"[dist-train] the ranks' mean gradient is "
            f"{rec['whole_batch_gap_over_spread']} x the one-rounding spread "
            f"from the whole-batch gradient at "
            f"{rec['whole_batch_worst_leaf']} (bound {ROUND_FACTOR:g}x)")

    # the smoke Trainer's residual, restored at pod = 1 in this process
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import init_world
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    init_world("nccl" if DEVICE == "cuda" else "gloo", device=DEVICE)
    smoke = get_smoke_config(DIST_ARCH)
    saved = torch.load(work / "smoke_residual.pt")
    tr = Trainer(smoke, AdamWConfig(learning_rate=DIST_LR),
                 DataConfig(vocab_size=smoke.vocab_size, seq_len=32,
                            global_batch=4, seed=seed),
                 TrainerConfig(total_steps=DIST_SMOKE_STEPS + 1,
                               checkpoint_dir=str(work / "ckpt"),
                               mesh_shape=(1,), compress_pods=True),
                 device=DEVICE)
    _, _, restored, start = tr.init_or_restore()
    require(start == DIST_SMOKE_STEPS, f"[dist-train] restored at {start}")
    worst = 0.0
    for n, e in saved.items():
        require(e.shape[0] == 2 and restored[n].shape[0] == 1,
                f"[dist-train] residual {n}: {tuple(e.shape)} -> "
                f"{tuple(restored[n].shape)}")
        worst = max(worst, float((restored[n].sum(0).cpu() / 1
                                  - e.sum(0) / 2).abs().max()))
    require(worst <= 1e-6 * max(float(e.abs().max()) for e in saved.values()),
            f"[dist-train] Σe/n moved by {worst} across the pod-count change")
    shutil.rmtree(work, ignore_errors=True)
    ex, cp = rec["steps"]["exact"], rec["steps"]["compressed"]
    red = rec["reduction_s"]
    log(f"[dist-train] {card} | {DIST_ARCH} at its published widths, "
        f"{layers} of 30 layers, bf16, int8 moments, 2 ranks on one card "
        f"over gloo, batch {DIST_BATCH} x {DIST_SEQ}: exact step "
        f"{ex['s']} s (psum_mean alone {red['exact']:.6f} s), int8 "
        f"step {cp['s']} s (compressed_psum_mean alone "
        f"{red['compressed']:.6f} s); rank 0 peak {ex['peak_bytes']} / "
        f"{cp['peak_bytes']} bytes; ranks bitwise equal every step; on the "
        f"ranks' gradients psum_mean at most "
        f"{rec['exact_err_over_bound']:.6f} x one bf16 rounding from their "
        f"exact mean, compressed_psum_mean at most "
        f"{rec['compressed_err_over_bound']:.6f} x half an int8 step (+ one "
        f"bf16 rounding), the "
        f"mean vs the whole-batch gradient at most "
        f"{rec['whole_batch_gap_over_spread']:.6f} x the one-rounding "
        f"spread ({rec['whole_batch_worst_leaf']}; relative gap at most "
        f"{rec['whole_batch_rel_gap_max']:.6e}, relative spread at least "
        f"{rec['rounding_rel_spread_min']:.6e}); "
        f"residual finite, nonzero; Σe/n kept across pod 2 -> 1 "
        f"(max {worst:.3e}); wall {wall:.3f} s")
    rec.update(card=card, layers=layers, wall_s=wall,
               sum_e_over_n_gap=worst)
    return rec


# ---------------------------------------------------------------------------
# phase: the training path (card against CPU at smoke widths, then
# deepseek-7b trained at full width)
# ---------------------------------------------------------------------------

TRAIN_SMOKE = ("deepseek_7b", "falcon_mamba_7b", "jamba_v0_1_52b")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 16, 3, 1e-3
# Card against CPU, both float32 from the same weights and batches: cuBLAS
# and the card's exp / log / tanh round differently from the CPU's, and
# Adam, which divides each entry's update by its own gradient scale, lets
# a gradient within rounding of zero move its entry by up to ~lr a step on
# one side and not the other.  So the bound is measured, not guessed: two
# more runs on the CPU start from the weights times (1 +- 2**-24), one
# float32 rounding (two draws of the signs), and the card may differ from
# the CPU by at most ROUND_FACTOR times what such a rounding does on the
# CPU alone: in the metrics, the largest gap relative to the metric's
# largest value, over the metrics, steps and entries (plus ROUND_FACTOR
# float32 ulps); in the parameters after the last step, the largest gap.
ROUND_FACTOR = 4.0
ROUNDINGS = 2
FULL_ARCH, FULL_BATCH, FULL_SEQ, FULL_STEPS = "deepseek_7b", 4, 512, 4
# step 1's ce from the train step against a plain f32 cross-entropy of
# logits_fn's bf16 logits: the same bf16 logits, f32 reductions in another
# order, so well inside one bf16 rounding (2**-8 relative)
FULL_CE_RTOL = 2.0 ** -8


def numpy_weights(torch, cfg, seed: int):
    """The model on the CPU with every parameter drawn from
    ``np.random.default_rng(seed)``: matrices N(0, 1/fan_in), the
    embedding and head N(0, 0.02**2), 1-D leaves N(0, 0.1**2)."""
    from repro_torch.models import init_params
    model = init_params(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = rng.standard_normal(tuple(p.shape))
            if name in ("embed", "lm_head"):
                x = 0.02 * x
            elif p.dim() == 1:
                x = 0.1 * x
            else:
                x = x / np.sqrt(p.shape[-2])
            p.copy_(torch.from_numpy(x).to(p.dtype))
    return model


def rounded(torch, model, seed: int):
    """A copy of ``model`` with every weight times (1 +- 2**-24), the sign
    drawn from a generator seeded with ``seed``."""
    import copy
    out = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
            p.mul_(1 + sign * 2.0 ** -24)
    return out


def train_card_vs_cpu(torch, arch: str, seed: int) -> dict:
    """3 steps of ``make_train_step`` on the card and on the CPU from the
    same float32 weights and batches, at microbatches 1 and 2, held within
    ``ROUND_FACTOR`` times the CPU's own spread under one rounding of the
    weights."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    cfg = get_smoke_config(arch)
    base = numpy_weights(torch, cfg, seed)
    starts = {"cpu": base, "card": base}
    starts.update({f"round{i}": rounded(torch, base, seed + i)
                   for i in range(ROUNDINGS)})
    opt_cfg = AdamWConfig(learning_rate=TRAIN_LR, weight_decay=0.1)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=seed))
    eps = float(np.finfo(np.float32).eps)
    out = {}
    for micro in (1, 2):
        step = make_train_step(cfg, opt_cfg, microbatches=micro)
        runs = {}
        for run, start in starts.items():
            params = copy.deepcopy(start).to(DEVICE if run == "card"
                                             else "cpu")
            opt = init_opt_state(dict(params.named_parameters()), opt_cfg)
            hist = []
            for s in range(TRAIN_STEPS):
                params, opt, res, met = step(params, opt, None,
                                             pipe.batch_at(s))
                require(res is None, "the residual did not pass through")
                hist.append({k: v.cpu() for k, v in met.items()})
            require(int(opt["step"]) == TRAIN_STEPS, f"{arch}: optimizer step")
            runs[run] = ({n: p.detach().cpu()
                          for n, p in params.named_parameters()}, hist)
        pc, hc = runs.pop("cpu")
        pg, hg = runs.pop("card")
        require(all(sorted(h[s]) == sorted(hc[s]) for h in
                    [hg] + [h for _, h in runs.values()]
                    for s in range(TRAIN_STEPS)),
                f"{arch}: metric names differ {sorted(hc[0])}")

        def rel_gap(h):
            """max over metrics of max |h - CPU| / max |CPU|"""
            out = 0.0
            for k in hc[0]:
                a, c = (torch.stack([x[s][k] for s in range(TRAIN_STEPS)])
                        for x in (h, hc))
                require(bool(torch.isfinite(a).all()),
                        f"{arch}: {k} not finite")
                out = max(out, float((a - c).abs().max()
                                     / c.abs().max().clamp_min(1e-30)))
            return out

        met_err = rel_gap(hg)
        met_floor = max(rel_gap(h) for _, h in runs.values())
        require(met_err <= ROUND_FACTOR * (met_floor + eps),
                f"{arch} microbatches={micro}: metrics differ by {met_err} "
                f"relative, one rounding by {met_floor}: card "
                f"{[{k: v.tolist() for k, v in h.items()} for h in hg]} CPU "
                f"{[{k: v.tolist() for k, v in h.items()} for h in hc]}")
        p_err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
        p_floor = max(float((pr[n] - pc[n]).abs().max())
                      for pr, _ in runs.values() for n in pc)
        require(p_err <= ROUND_FACTOR * p_floor,
                f"{arch} microbatches={micro}: parameters differ by {p_err}, "
                f"one rounding moves them by {p_floor}")
        out[f"microbatches_{micro}"] = {
            "loss": [float(h["loss"]) for h in hg],
            "metrics_max_rel_err": met_err, "metrics_round_floor": met_floor,
            "params_max_abs_err": p_err, "params_round_floor": p_floor}
        log(f"[train] {cfg.name} microbatches={micro}: {TRAIN_STEPS} steps, "
            f"loss {out[f'microbatches_{micro}']['loss']}; card vs CPU: "
            f"metrics {met_err:.3e} relative (one rounding on the CPU: "
            f"{met_floor:.3e}), parameters {p_err:.3e} (one rounding: "
            f"{p_floor:.3e}; bound {ROUND_FACTOR:g}x)")
    return out


def train_restart(torch, arch: str, seed: int) -> dict:
    """The ``Trainer`` on the card fails at step 3, resumes to step 6, and
    ends bitwise equal to a clean 6-step run (deterministic algorithms: the
    embedding's scatter-add and cuBLAS in their deterministic modes)."""
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_smoke_config(arch)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def trainer(sub):
                return Trainer(
                    cfg, AdamWConfig(learning_rate=3e-3),
                    DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=seed),
                    TrainerConfig(total_steps=6, checkpoint_every=3,
                                  checkpoint_dir=f"{tmp}/{sub}", log_every=1,
                                  seed=seed),
                    device=DEVICE)
            try:
                trainer("a").run(inject_failure_at=3)
                require(False, f"{arch}: the injected failure did not fire")
            except RuntimeError as e:
                require("injected failure at step 3" in str(e), str(e))
            resumed, _, h_res = trainer("a").run()
            clean, _, h_clean = trainer("b").run()
    finally:
        torch.use_deterministic_algorithms(False)
    for (name, a), b in zip(resumed.named_parameters(), clean.parameters()):
        require(bits_equal(a, b), f"{arch}: restart differs at {name} by "
                                  f"{max_abs_err(a, b)}")
    require(h_res == h_clean[3:], f"{arch}: resumed losses {h_res} against "
                                  f"{h_clean[3:]}")
    log(f"[train] {cfg.name}: Trainer failed at step 3, resumed to 6: "
        f"parameters and losses bitwise a clean run ({h_clean})")
    return {"losses": [l for _, l in h_clean], "bitwise": True}


def full_opt_config():
    """The full-width runs' AdamW: int8 moments, decay 0.1, warmup-cosine
    from 3e-3 over ``FULL_STEPS``."""
    from repro_torch.optim import AdamWConfig, warmup_cosine

    return AdamWConfig(moment_dtype="int8", weight_decay=0.1,
                       learning_rate=warmup_cosine(3e-3, 10, FULL_STEPS))


def full_pipeline(cfg, seed: int):
    from repro_torch.data import DataConfig, TokenPipeline

    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=FULL_SEQ, global_batch=FULL_BATCH,
                                    seed=seed))


def train_full_width(torch, seed: int, card: str) -> dict:
    """deepseek-7b at its published widths and depth, bf16, int8 moments:
    ``FULL_STEPS`` steps of ``make_train_step`` on ``TokenPipeline``
    batches of 4 x 512 tokens, remat on."""
    from repro_torch.configs import get_config
    from repro_torch.models import logits_fn, model_flops
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    import torch.nn.functional as F

    cfg = get_config(FULL_ARCH)
    check_widths(cfg, FULL_ARCH)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, out = build_model(torch, cfg, seed, "train")
    params.requires_grad_(True)
    opt_cfg = full_opt_config()
    opt = init_opt_state(dict(params.named_parameters()), opt_cfg)
    pipe = full_pipeline(cfg, seed)
    step = make_train_step(cfg, opt_cfg)
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in params.named_parameters()}

    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in pipe.batch_at(0).items()}
    with torch.no_grad():
        logits, _ = logits_fn(params, batch["tokens"], cfg)
        plain_ce = float(F.cross_entropy(
            logits.to(torch.float32).reshape(-1, cfg.vocab_size),
            batch["labels"].reshape(-1).long()))
        del logits
    steps = []
    for s in range(FULL_STEPS):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in pipe.batch_at(s).items()}
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, met = step(params, opt, None, batch)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {k: float(met[k]) for k in ("loss", "ce", "grad_norm", "lr")}
        rec["s"] = dt
        for k in ("loss", "ce", "grad_norm"):
            require(np.isfinite(rec[k]), f"[train] step {s + 1}: {k} = "
                                         f"{rec[k]}")
        steps.append(rec)
        if s + 1 == TP_STEPS:
            # the tp-train phase's evidence: every parameter on the host
            evidence = {n: p.detach().to("cpu", copy=True)
                        for n, p in params.named_parameters()}
        log(f"[train] {cfg.name} step {s + 1}: loss {rec['loss']:.6f} ce "
            f"{rec['ce']:.6f} grad_norm {rec['grad_norm']:.6f} lr "
            f"{rec['lr']:.3e}, {dt:.6f} s")
    require(abs(steps[0]["ce"] - plain_ce) <= FULL_CE_RTOL * plain_ce,
            f"[train] step 1 ce {steps[0]['ce']} against a plain f32 "
            f"cross-entropy of logits_fn {plain_ce}")
    still = [n for n, p in params.named_parameters()
             if torch.equal(p.detach().cpu(), before[n])]
    require(not still, f"[train] parameters that never moved: {still[:8]}")
    require(int(opt["step"]) == FULL_STEPS, "[train] optimizer step")
    peak = (torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0)
    step_s = float(np.median([r["s"] for r in steps[1:]]))
    tokens = FULL_BATCH * FULL_SEQ
    flops = model_flops(cfg, tokens, train=True)
    out.update({
        "card": card, "batch": FULL_BATCH, "seq": FULL_SEQ,
        "moment_dtype": "int8", "steps": steps, "plain_ce": plain_ce,
        "step_s_median_2_4": step_s, "tokens_per_s": tokens / step_s,
        "model_flops_6NT": flops, "flops_with_remat_8NT": flops * 8 / 6,
        "mfu_6NT": flops / step_s / BF16_OPS_PER_S,
        "hw_flops_share_8NT": flops * 8 / 6 / step_s / BF16_OPS_PER_S,
        "peak_bytes": peak, "reckoned_resident_bytes": 41.5e9,
        "evidence": {"params": evidence, "steps": steps[:TP_STEPS]}})
    log(f"[train] {card} | {cfg.name} {cfg.num_layers} layers, "
        f"{cfg.param_count()} parameters, batch {FULL_BATCH} x {FULL_SEQ}, "
        f"int8 moments: step {step_s:.6f} s (median of steps 2-"
        f"{FULL_STEPS}), {out['tokens_per_s']:.3f} tokens/s, model FLOPs "
        f"6NT {flops:.6e} = {100 * out['mfu_6NT']:.4f}% of 989 TFLOP/s bf16 "
        f"({100 * out['hw_flops_share_8NT']:.4f}% counting remat's extra "
        f"forward, 8NT); peak memory {peak} bytes against the 41.5e9 "
        f"reckoned resident (params + grads + int8 moments); step 1 ce "
        f"{steps[0]['ce']:.6f} against plain {plain_ce:.6f}")
    return out


def phase_train(torch, K, seed: int, card: str) -> dict:
    """The training path: (a) deepseek-7b, falcon-mamba-7b and jamba smoke
    configs, card against CPU and a Trainer restart; (b) deepseek-7b
    trained at full width."""
    K.reset_launch_counts()
    out = {"card_vs_cpu": {}, "restart": {}}
    for arch in TRAIN_SMOKE:
        out["card_vs_cpu"][arch] = train_card_vs_cpu(torch, arch, seed)
        out["restart"][arch] = train_restart(torch, arch, seed)
    free_card(torch)
    out["full_width"] = train_full_width(torch, seed, card)
    out["launches"] = K.launch_counts()
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the measurements to FILE (JSON)")
    args = ap.parse_args()

    # cuBLAS's deterministic mode (the train phase's restart check) needs
    # this before the first GEMM
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    serve, params = phase_serve(torch, K, args.seed)
    walls["serve"] = time.perf_counter() - t0
    log(f"[serve] wall {walls['serve']:.3f} s")
    launches["fused_decision"] += serve["launches"]["fused_decision"]

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    dist_serve = phase_dist_serve(torch, K, get_config(SERVE_ARCH), params,
                                  args.seed, card)
    walls["dist_serve"] = time.perf_counter() - t0
    log(f"[dist-serve] wall {walls['dist_serve']:.3f} s")
    launches["fused_decision"] += dist_serve["launches"]["fused_decision"]
    del params
    free_card(torch)

    t0 = time.perf_counter()
    chaos = phase_chaos(torch, K, card)
    walls["chaos"] = time.perf_counter() - t0
    log(f"[chaos] wall {walls['chaos']:.3f} s")
    for name in ("heft_fused", "fused_decision"):
        launches[name] += chaos["launches"][name]
    free_card(torch)

    t0 = time.perf_counter()
    examples = phase_examples(card)
    walls["examples"] = time.perf_counter() - t0
    log(f"[examples] wall {walls['examples']:.3f} s")

    t0 = time.perf_counter()
    dryrun = phase_dryrun(torch, args.seed, card)
    walls["dryrun"] = time.perf_counter() - t0
    log(f"[dryrun] wall {walls['dryrun']:.3f} s")
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
    train = phase_train(torch, K, args.seed, card)
    walls["train"] = time.perf_counter() - t0
    log(f"[train] launches of the four kernels {train['launches']}, wall "
        f"{walls['train']:.3f} s")
    free_card(torch)

    t0 = time.perf_counter()
    tp_train = phase_tp_train(torch, args.seed, card,
                              train["full_width"].pop("evidence"),
                              train["full_width"])
    walls["tp_train"] = time.perf_counter() - t0
    log(f"[tp-train] wall {walls['tp_train']:.3f} s")
    free_card(torch)

    t0 = time.perf_counter()
    dist_train = phase_dist_train(torch, args.seed, card)
    walls["dist_train"] = time.perf_counter() - t0
    log(f"[dist-train] wall {walls['dist_train']:.3f} s")

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
            "train": train, "tp_train": tp_train, "dist_serve": dist_serve,
            "dist_train": dist_train, "chaos": chaos, "dryrun": dryrun,
            "examples": examples,
            "event_shapes": timing["event_shapes"],
            "queue_shapes": timing["queue_shapes"]}, indent=1))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

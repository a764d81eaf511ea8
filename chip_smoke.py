#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--seed N]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
process per source, all at once), then runs three phases and fails on the
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
  SoC, the oversubscribed high-latency workload at 600 frames/s) with
  ``make_dispatch_fabric("cuda")`` and ``("fused")`` on the card, against
  the same run on the CPU plain path: identical ``SimResult``.

The fabric and runtime phases are the main path: the kernels' launch
counters are zeroed just before each and read just after, and each kernel
must have launched in each.  Then each kernel is timed with CUDA events at
the fabric-batched shape (B = 256, D = 2048, P = 4) beside its plain
version and its memory bound.  The last two lines are the ``kernels`` JSON
record and ``{"ok": true, "device": {...}}``.  Exits non-zero without a
card, without the port's sources next to it, or on any failure.
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
    """Bitwise equality of two tensors (float lanes compared as int32)."""
    import torch
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
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

def run_twin(backend: str, device: str):
    from repro_torch.runtime import (CedrSimulator, high_latency_arrivals,
                                     make_dispatch_fabric,
                                     paper_soc_pe_types)
    sim = CedrSimulator(paper_soc_pe_types(),
                        dispatch=make_dispatch_fabric(backend, device=device),
                        seed=7)
    return sim.run(high_latency_arrivals(600, seed=1))


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


def bound(B: int, D: int, P: int, masked: bool) -> tuple[float, str]:
    """Least time for the work: bytes moved (inputs once, outputs once) over
    the memory rate vs f32 operations (an add and a compare per lane per
    step) over the f32 rate."""
    nbytes = 4 * B * D + 4 * B * D * P + 4 * B * P + (P if masked else 0)
    nbytes += 16 * B * D + 4 * B * P
    ops = 2 * B * D * P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
        b_ms, b_by = bound(B, D, P, name == "fused_decision")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "single_event_D256_ms": single}
        log(f"[timing] {name} B={B} D={D} P={P}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}); one event "
            f"D=256 P=4: {single:.6f} ms")
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
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf

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
    for kern in (hf.KERNEL, fd.KERNEL):
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kern.name}: {line.strip()}")
    log(f"[build] nvcc, both kernels in parallel: {walls['build']:.3f} s")

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

    launches = {}
    for name in fabric_counts:
        per_phase = [fabric_counts[name]] + [c[name] for c in
                                             runtime_counts.values()]
        require(fabric_counts[name] > 0,
                f"{name} never launched in the fabric phase")
        require(sum(c[name] for c in runtime_counts.values()) > 0,
                f"{name} never launched in the runtime phase")
        launches[name] = sum(per_phase)

    t0 = time.perf_counter()
    timing = phase_timing(torch, args.seed)
    walls["timing"] = time.perf_counter() - t0
    log(f"[timing] wall {walls['timing']:.3f} s")

    sources = {"heft_fused": ("src/repro_torch/csrc/heft_fused.cu",
                              "src/repro/kernels/heft_fused.py:28"),
               "fused_decision": ("src/repro_torch/csrc/fused_decision.cu",
                                  "src/repro/kernels/fused_decision.py:118")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": dict(zip("BDP", TIMED_SHAPE)),
            "single_event_D256_ms": t["single_event_D256_ms"],
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "walls_s": walls, "kernels": kernels,
            "launches_fabric": fabric_counts,
            "launches_runtime": runtime_counts}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

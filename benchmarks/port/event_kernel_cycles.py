#!/usr/bin/env python3
"""Where the kernels' cycles go, phase by phase, on the card.

    python3 benchmarks/port/event_kernel_cycles.py [--out FILE]

Copies the port's sources into ``build/cycles/`` (git-ignored) and adds
``clock64()`` stamps to that copy of ``csrc/heft_event.cuh``: around the
sort (``sort_queue``), and within it around its barrier stages (the
shared-memory phases and the scratch passes, each with its barriers: the
rest of the sort is register and shuffle stages); around the first tile's
staging, the drain loop (the rest of the ring's staging overlaps it) and
the last write-back (``drain_event``).  Thread 0 of each CTA writes them
to a device array that an entry point added to each kernel's source reads
back.  Builds the copy, runs its ``heft_fused`` and ``fused_decision``
(lane 1 masked, as ``chip_smoke.py`` times it), ``oddeven_sort`` (the
keys carrying the QIDs) and ``eft_select`` (the exec rows in that order)
at the main path's shapes, and prints, for each kernel and shape, the mean
cycles of each phase per CTA, the live rows drained and the cycles per
drained row, beside the card's name, power limit and SM clock.  The
sources of the checkout stay as they are: the stamps exist only in the
copy.  Fails without a card, or if the kernels' text no longer has the
places the stamps go.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "cycles"
# stamp slots per CTA, in the device array
PHASES = ("sort", "stage0", "drain", "write_back", "live_rows", "tiles",
          "sort_barrier_stages")
SLOTS = 8

# (anchor in heft_event.cuh, what goes in its place)
STAMPS = [
    ("namespace heft {\n",
     "namespace heft {\n\n"
     f"__device__ unsigned long long heft_clk[8192 * {SLOTS}];\n"
     "__device__ __forceinline__ void heft_stamp(int slot,\n"
     "                                           unsigned long long v,\n"
     "                                           bool add) {\n"
     "  if (threadIdx.x != 0 || blockIdx.x >= 8192) return;\n"
     f"  unsigned long long* r = heft_clk + blockIdx.x * {SLOTS} + slot;\n"
     "  *r = add ? *r + v : v;\n"
     "}\n"),
    # the sort, and its barrier stages
    ("  switch (sort_grain(N, blockDim.x)) {\n",
     "  const unsigned long long q0 = clock64();\n"
     "  heft_stamp(6, 0, false);\n"
     "  switch (sort_grain(N, blockDim.x)) {\n"),
    ("    default: sort_keys<8>(kb, buf, chunk, D, N);\n  }\n",
     "    default: sort_keys<8>(kb, buf, chunk, D, N);\n  }\n"
     "  heft_stamp(0, clock64() - q0, false);\n"),
    ("    if (j >= kWarp * E) {\n",
     "    const unsigned long long qb = clock64();\n"
     "    if (j >= kWarp * E) {\n"),
    ("      if (holds) get_keys(v, s, t * E, true);\n    }\n",
     "      if (holds) get_keys(v, s, t * E, true);\n    }\n"
     "    heft_stamp(6, clock64() - qb, true);\n"),
    ("      for (int j = k / 2; j >= kSortChunk; j >>= 1) {\n"
     "        __syncthreads();\n"
     "        buffer_stage(buf, N, 0, k, j, false);\n"
     "      }\n"
     "      __syncthreads();\n",
     "      const unsigned long long qg = clock64();\n"
     "      for (int j = k / 2; j >= kSortChunk; j >>= 1) {\n"
     "        __syncthreads();\n"
     "        buffer_stage(buf, N, 0, k, j, false);\n"
     "      }\n"
     "      __syncthreads();\n"
     "      heft_stamp(6, clock64() - qg, true);\n"),
    # the drain
    ("  stage(0, threadIdx.x, blockDim.x, false);\n  __syncthreads();\n",
     "  const unsigned long long c1 = clock64();\n"
     "  stage(0, threadIdx.x, blockDim.x, false);\n  __syncthreads();\n"
     "  const unsigned long long c2 = clock64();\n"
     "  unsigned long long nl = 0;\n"),
    ("      if (drains) step.run(",
     "      nl += nlive[k % s.nrows];\n      if (drains) step.run("),
    ("  back(s.ntiles - 1, threadIdx.x, blockDim.x);\n"
     "  if (drains) step.store(avail_out + (size_t)b * P, P);\n",
     "  const unsigned long long c3 = clock64();\n"
     "  back(s.ntiles - 1, threadIdx.x, blockDim.x);\n"
     "  if (drains) step.store(avail_out + (size_t)b * P, P);\n"
     "  __syncthreads();\n"
     "  heft_stamp(1, c2 - c1, false);\n"
     "  heft_stamp(2, c3 - c2, false);\n"
     "  heft_stamp(3, clock64() - c3, false);\n"
     "  heft_stamp(4, nl, false);\n"
     "  heft_stamp(5, s.ntiles, false);\n"),
]

READER = """
extern "C" int {name}_clocks(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, heft::heft_clk,
                                   sizeof(unsigned long long) * SLOTS * n);
}
""".replace("SLOTS", str(SLOTS))
KERNELS = ("heft_fused", "fused_decision", "oddeven_sort", "eft_select")


def make_copy() -> Path:
    """The port's sources under COPY, with the stamps in heft_event.cuh."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch",
                    COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = COPY / "src" / "repro_torch" / "csrc" / "heft_event.cuh"
    text = header.read_text()
    for anchor, stamped in STAMPS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"heft_event.cuh: no single place for a "
                               f"stamp at {anchor!r}")
        text = text.replace(anchor, stamped)
    header.write_text(text)
    for name in KERNELS:
        source = COPY / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        source.write_text(source.read_text() +
                          READER.replace("{name}", name))
    return COPY / "src"


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the cycles to FILE (JSON)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("event_kernel_cycles: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(make_copy()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import eft_select, oddeven_sort, ops
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf
    if not Path(hf.__file__).resolve().is_relative_to(COPY):
        raise RuntimeError(f"imported {hf.__file__}, not the stamped copy")
    readers = {}
    for kern in ops.KERNELS:
        fn = getattr(kern.lib(), f"{kern.name}_clocks")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        readers[kern.name] = fn
    card = smi("name,power.limit")
    print(f"[device] {card}, SM clock now {smi('clocks.sm')}", flush=True)

    rng = np.random.default_rng(args.seed)
    shapes = cs.timed_shapes(rng)
    shapes["B8_D1330_P200"] = cs.make_event(rng, 8, 1330, 200)
    shapes["B1_D65536_P4"] = cs.make_event(rng, 1, 65536, 4)
    out = {name: {} for name in KERNELS}
    for name, arrays in shapes.items():
        keys, ex, av = (torch.from_numpy(x).cuda() for x in arrays)
        qids, exec_sorted = cs.queue_operands(torch, keys, ex)
        mask = torch.zeros(ex.shape[2], dtype=torch.bool, device="cuda")
        mask[1] = True
        for kernel, run in (
                ("heft_fused", lambda: hf.heft_fused(keys, ex, av)),
                ("fused_decision",
                 lambda: fd.fused_decision(keys, ex, av, mask)),
                ("oddeven_sort", lambda: oddeven_sort(keys, qids)),
                ("eft_select", lambda: eft_select(exec_sorted, av))):
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            B = keys.shape[0]
            host = np.zeros(SLOTS * B, np.uint64)
            status = readers[kernel](host.ctypes.data, B)
            if status != 0:
                raise RuntimeError(f"reading the stamps failed: {status}")
            h = host.reshape(B, SLOTS).astype(np.float64)
            has_sort = kernel != "eft_select"
            has_drain = kernel != "oddeven_sort"
            rec = {}
            for i, p in enumerate(PHASES):
                if (has_sort or "sort" not in p) and \
                        (has_drain or "sort" in p):
                    rec[p if p in ("live_rows", "tiles")
                        else f"{p}_cycles"] = float(h[:, i].mean())
            if has_drain:
                rec["drain_cycles_per_live_row"] = float(
                    (h[:, 2] / np.maximum(h[:, 4], 1)).mean())
            # a CTA's stamped cycles, mean and largest: the CTAs of a
            # batch run in one wave, so the largest is the kernel's
            total = h[:, [0, 1, 2, 3]].sum(axis=1)
            rec["cta_cycles_mean"] = float(total.mean())
            rec["cta_cycles_max"] = float(total.max())
            out[kernel][name] = rec
            print(f"[cycles] {kernel} {name} {tuple(ex.shape)}: " +
                  ", ".join(f"{k} {v:.1f}" for k, v in rec.items()),
                  flush=True)
    record = {"card": card, "clocks_sm_after": smi("clocks.sm"),
              "shapes": out}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

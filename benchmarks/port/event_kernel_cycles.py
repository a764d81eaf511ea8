#!/usr/bin/env python3
"""Where an event kernel's cycles go, phase by phase, on the card.

    python3 benchmarks/port/event_kernel_cycles.py [--out FILE]

Copies the port's sources into ``build/cycles/`` (git-ignored), adds
``clock64()`` stamps to that copy of ``event_kernel``
(``csrc/heft_event.cuh``) around the sort, the first tile's staging, the
drain loop (the rest of the ring's staging overlaps it) and the last
write-back, plus an entry point that reads them; builds the copy, runs its
``heft_fused`` and ``fused_decision`` (lane 1 masked, as ``chip_smoke.py``
times it) at the main path's shapes and prints, for each kernel and shape,
the mean cycles of each phase per CTA, the live rows drained and the
cycles per drained row, beside the card's name, power limit and SM clock.
The sources of the checkout stay as they are: the stamps exist only in the
copy.  Fails without a card, or if the kernel's text no longer has the
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
PHASES = ("sort", "stage0", "drain", "write_back")

# (anchor in heft_event.cuh, what goes in its place)
STAMPS = [
    ("template <typename Step, bool MASKED>\n__global__",
     "__device__ unsigned long long heft_clk[8192 * 6];\n\n"
     "template <typename Step, bool MASKED>\n__global__"),
    ("  sort_queue(keys + (size_t)b * D, buf, D, N);\n",
     "  const unsigned long long c0 = clock64();\n"
     "  unsigned long long nl = 0;\n"
     "  sort_queue(keys + (size_t)b * D, buf, D, N);\n"
     "  const unsigned long long c1 = clock64();\n"),
    ("  stage(0, threadIdx.x, blockDim.x, false);\n  __syncthreads();\n",
     "  stage(0, threadIdx.x, blockDim.x, false);\n  __syncthreads();\n"
     "  const unsigned long long c2 = clock64();\n"),
    ("      if (drains) step.run(",
     "      nl += nlive[k % s.nrows];\n      if (drains) step.run("),
    ("  back(s.ntiles - 1, threadIdx.x, blockDim.x);\n"
     "  if (drains) step.store(avail_out + (size_t)b * P, P);\n",
     "  const unsigned long long c3 = clock64();\n"
     "  back(s.ntiles - 1, threadIdx.x, blockDim.x);\n"
     "  if (drains) step.store(avail_out + (size_t)b * P, P);\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0 && b < 8192) {\n"
     "    unsigned long long* r = heft_clk + (size_t)b * 6;\n"
     "    r[0] = c1 - c0; r[1] = c2 - c1; r[2] = c3 - c2;\n"
     "    r[3] = clock64() - c3; r[4] = nl; r[5] = s.ntiles;\n"
     "  }\n"),
]

READER = """
extern "C" int {name}_clocks(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, heft::heft_clk,
                                   sizeof(unsigned long long) * 6 * n);
}
"""


def make_copy() -> Path:
    """The port's sources under COPY, with the stamps in the event kernel."""
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
    for name in ("heft_fused", "fused_decision"):
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
    from repro_torch.kernels import fused_decision as fd, heft_fused as hf
    if not Path(hf.__file__).resolve().is_relative_to(COPY):
        raise RuntimeError(f"imported {hf.__file__}, not the stamped copy")
    readers = {}
    for kern in (hf.KERNEL, fd.KERNEL):
        fn = getattr(kern.lib(), f"{kern.name}_clocks")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        readers[kern.name] = fn
    card = smi("name,power.limit")
    print(f"[device] {card}, SM clock now {smi('clocks.sm')}", flush=True)

    rng = np.random.default_rng(args.seed)
    batch = cs.make_event(rng, 256, 2048, 4)
    shapes = {
        "B256_D2048_P4": batch,
        "D256": tuple(np.ascontiguousarray(x[:1, :256]) for x in batch),
        "pad223_of_256": cs.make_event(rng, 1, 256, 4, kind="pad223"),
        "bucket8": cs.make_event(rng, 1, 8, 4),
        "B8_D1330_P200": cs.make_event(rng, 8, 1330, 200),
        "B1_D65536_P4": cs.make_event(rng, 1, 65536, 4),
    }
    out = {"heft_fused": {}, "fused_decision": {}}
    for name, arrays in shapes.items():
        keys, ex, av = (torch.from_numpy(x).cuda() for x in arrays)
        mask = torch.zeros(ex.shape[2], dtype=torch.bool, device="cuda")
        mask[1] = True
        for kernel, run in (
                ("heft_fused", lambda: hf.heft_fused(keys, ex, av)),
                ("fused_decision",
                 lambda: fd.fused_decision(keys, ex, av, mask))):
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            B = keys.shape[0]
            host = np.zeros(6 * B, np.uint64)
            status = readers[kernel](host.ctypes.data, B)
            if status != 0:
                raise RuntimeError(f"reading the stamps failed: {status}")
            h = host.reshape(B, 6).astype(np.float64)
            rec = {f"{p}_cycles": float(h[:, i].mean())
                   for i, p in enumerate(PHASES)}
            rec["live_rows"] = float(h[:, 4].mean())
            rec["tiles"] = float(h[:, 5].mean())
            rec["drain_cycles_per_live_row"] = float(
                (h[:, 2] / np.maximum(h[:, 4], 1)).mean())
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

#!/usr/bin/env python3
"""The four kernels of one tree of the port, timed on the card.

    python3 benchmarks/port/event_kernel_timing.py [--src DIR] [--out FILE]

Times ``heft_fused`` and ``fused_decision`` (``chip_smoke.time_event_shapes``)
and ``oddeven_sort``, ``eft_select`` and ``torch.sort`` + gather
(``chip_smoke.time_queue_shapes``) of the port found under ``--src``
(default: this checkout's ``src``; point it at the ``src`` of an unpacked
``git archive`` of another commit to compare two trees in one run) at the
main path's shapes: B = 256 events of D = 2048 slots on P = 4 PEs, one
event of 256 slots, one CEDR-twin event (223 real slots padded to the 256
bucket as the fabric pads them) and one serving event (8 slots), each back
to back through the wrapper and replayed from a CUDA graph.  Builds the
tree's kernels first (into its own ``build/``) and prints what ``ptxas -v``
said of each kernel function (registers, spills).  Prints the card's name
and power limit, one line per shape, and one JSON line; fails without a
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the timings to FILE (JSON)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("event_kernel_timing: no CUDA device available",
              file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import repro_torch.kernels as K
    if not Path(K.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {K.__file__}, not the tree at {src}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card} | tree {src}", flush=True)
    K.build_kernels()
    ptxas = {}
    for kern in K.ops.KERNELS:
        log = kern.library_path().with_suffix(".log").read_text()
        ptxas[kern.name] = chip_smoke.ptxas_report(log)
        for line in ptxas[kern.name]:
            print(f"[ptxas] {kern.name}: {line}", flush=True)
    shapes = chip_smoke.time_event_shapes(torch, args.seed)
    queue = chip_smoke.time_queue_shapes(torch, args.seed)
    record = {"card": card, "src": str(src), "ptxas": ptxas,
              "event_shapes": shapes, "queue_shapes": queue}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

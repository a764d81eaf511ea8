#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as one JSON line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json`` (see ``bench/spec.py``);
the program under test is the PyTorch port under ``src/``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
(the program's spans on, ``torch.profiler`` over a fixed run of steady
iterations).  Exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell asks for), when the program cannot be imported,
or when JAX or the JAX package was loaded.  The last line of standard
output is the result; the numbers compared for ``correct`` end standard
error, each beside its limit.  ``--rate r`` offers ``r`` requests an
iteration in place of the cell's rate: one point of a rate sweep, read
from the backlog the run logs every 30 iterations.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="offer this many requests an iteration in place "
                         "of the cell's rate (for a rate sweep; the "
                         "backlog readings on standard error show whether "
                         "the cell sustains it)")
    args = ap.parse_args(argv)

    cache_dirs()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.spec import load_cell
    spec = load_cell(args.workload, bool(args.trace))
    if args.rate is not None:
        spec.cell = dict(spec.cell, rate=args.rate)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"bench: the cell needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program is not importable: {e}", file=sys.stderr)
        return 2
    from bench import result
    torch.set_num_threads(1)
    line = result.measure(spec, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    line["device"]["kind"] = torch.cuda.get_device_name(0)
    print(f"bench: card {card_name()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

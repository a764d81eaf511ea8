"""CLI: validate a Chrome trace artifact (the CI ``--trace`` gate).

  PYTHONPATH=src python -m repro_torch.obs.check out.json \\
      --require fabric. --require-metrics fabric.decision_s

Exit status is non-zero on schema violations, missing required event
names, or missing metrics-snapshot keys.  Lives outside ``trace.py`` so
``python -m`` does not re-execute an already-imported module.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.obs.trace import validate_chrome_trace


def main() -> None:
    ap = argparse.ArgumentParser(
        description="validate a Chrome trace artifact (Perfetto JSON)")
    ap.add_argument("path")
    ap.add_argument("--require", action="append", default=[],
                    metavar="SUBSTRING",
                    help="require an event whose name contains SUBSTRING "
                         "(repeatable)")
    ap.add_argument("--require-metrics", action="append", default=[],
                    metavar="SUBSTRING",
                    help="require an embedded metrics snapshot whose key "
                         "contains SUBSTRING (repeatable)")
    args = ap.parse_args()
    with open(args.path) as f:
        obj = json.load(f)
    n = validate_chrome_trace(obj, require_names=args.require)
    for want in args.require_metrics:
        snap = obj.get("metrics") or {}
        if not any(want in k for k in snap):
            raise SystemExit(
                f"[obs] {args.path}: no metrics key matching {want!r} "
                f"(saw {sorted(snap)[:20]})")
    print(f"[obs] {args.path}: valid Chrome trace, {n} events")


if __name__ == "__main__":
    main()

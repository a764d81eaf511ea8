"""``python -m repro_torch.analysis`` — the port's lint gate.

Counterpart of ``repro.analysis.cli``.  Exit status: 0 when every finding
is suppressed or baselined, 1 when any new finding survives, 2 on usage
errors.  ``--json`` writes the full run
(live + suppressed + baselined counts) as a machine-readable artifact so
CI regressions are diffable.

Environment knobs: ``REPRO_TORCH_LINT_HOT`` extends the hot-function
registry, ``REPRO_TORCH_LINT_RULES`` pre-selects rules (same syntax as
``--rules``).  They are not the reference gate's knobs, so the two gates
never read each other's settings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from repro_torch.analysis.findings import (apply_baseline, load_baseline,
                                     write_baseline)
from repro_torch.analysis.registry import all_rules, default_context
from repro_torch.analysis.runner import run_analysis


def _detect_root(paths) -> Path:
    """Nearest ancestor (of the first path, else cwd) with pyproject.toml."""
    start = Path(paths[0]).resolve() if paths else Path.cwd().resolve()
    if start.is_file():
        start = start.parent
    for cand in (start, *start.parents):
        if (cand / "pyproject.toml").exists():
            return cand
    return Path.cwd().resolve()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static design-rule checker for the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: <root>/src)")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths + repo-scope rule "
                         "anchors (default: auto-detect via pyproject.toml)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="grandfathered-findings file; matching findings "
                         "don't gate (tools/analysis_baseline_torch.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from the current findings and "
                         "exit 0")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the findings report as a JSON artifact")
    ap.add_argument("--rules",
                    default=os.environ.get("REPRO_TORCH_LINT_RULES"),
                    metavar="A,B",
                    help="comma-separated rule subset (default: all; env "
                         "REPRO_TORCH_LINT_RULES)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary line only, no per-finding output")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in all_rules().values():
            head = r.doc.split("\n")[0] if r.doc else ""
            print(f"{r.name}  [{r.scope}]  {head}")
        return 0

    root = Path(args.root).resolve() if args.root else _detect_root(args.paths)
    ctx = default_context(root, paths=args.paths or None)
    rule_names = ([r.strip() for r in args.rules.split(",") if r.strip()]
                  if args.rules else None)
    t0 = time.perf_counter()
    try:
        result = run_analysis(ctx, rule_names)
    except ValueError as e:
        print(f"[repro_torch.analysis] {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0

    if args.update_baseline:
        if not args.baseline:
            print("[repro_torch.analysis] --update-baseline needs --baseline",
                  file=sys.stderr)
            return 2
        write_baseline(args.baseline, result.findings)
        print(f"[repro_torch.analysis] baseline {args.baseline} <- "
              f"{len(result.findings)} finding(s)")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else None
    if baseline is not None:
        fresh, absorbed = apply_baseline(result.findings, baseline)
    else:
        fresh, absorbed = result.findings, 0

    if not args.quiet:
        for f in fresh:
            print(f.render())
    status = "FAIL" if fresh else "OK"
    print(f"[repro_torch.analysis] {status} — {result.files} files, "
          f"{len(result.rules)} rules, {len(fresh)} new finding(s) "
          f"({absorbed} baselined, {len(result.suppressed)} noqa'd) "
          f"in {elapsed:.2f}s")

    if args.json:
        payload = {
            "version": 1,
            "root": str(root),
            "files": result.files,
            "rules": list(result.rules),
            "elapsed_s": round(elapsed, 4),
            "findings": [f.to_json() for f in fresh],
            "baselined": absorbed,
            "suppressed": [f.to_json() for f in result.suppressed],
        }
        with open(args.json, "w") as fp:
            json.dump(payload, fp, indent=1)
            fp.write("\n")
    return 1 if fresh else 0

"""Hold every dry-run artifact to ``chip_smoke.py``'s own FLOP bound.

``chip_smoke.dryrun_flop_bounds`` bounds rank 0's FLOPs of a dry-run cell
from the config alone, with no function of the dry run or of the MoE
dispatch: a second witness beside the dry run's ``flop_bounds``.  This
prints one row per artifact that ``python -m repro_torch.launch.dryrun
--all`` left (its FLOPs over the floor and over the ceiling) and exits 1
if a cell failed or lies outside:

  PYTHONPATH=src python tools/dryrun_bounds.py [ARTIFACT_DIR]
"""

import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    art = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                       ROOT / "experiments" / "artifacts" / "dryrun_torch")
    bad = []
    print("| arch | shape | mesh | FLOPs/dev | / floor | / ceiling |")
    print("|---|---|---|---|---|---|")
    for path in sorted(art.glob("*.json")):
        cell = json.loads(path.read_text())
        if "error" in cell:
            bad.append(path.name)
            print(f"| {cell['arch']} | {cell['shape']} | {cell['mesh']} | "
                  f"error | | |")
            continue
        lo, hi = smoke.dryrun_flop_bounds(cell)
        flops = cell["flops_per_device"]
        if not lo <= flops <= hi:
            bad.append(path.name)
        print(f"| {cell['arch']} | {cell['shape']} | {cell['mesh']} | "
              f"{flops:.6e} | {flops / lo:.4f} | {flops / hi:.4f} |")
    print(f"{len(bad)} cell(s) failed or outside the bounds: {bad}",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

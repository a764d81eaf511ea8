"""The control fails the correctness check; the program passes it.  Card
only (``-m cuda``): each cell at its own size, three seeds, a short window.

The control is the plain reference in fp8 put in the program's place
(:func:`bench.check.control_gap`): at the same positions of the same
sampled requests, its own first token read in the float32 reference.  Its
widest gap has to lie above the cell's ``logit_gap`` limit, and the
program's below it.  Each seed's readings are printed as a JSON line (run
with ``-s`` to keep them): they are what the limit is set from."""

import gc
import json
import time
from pathlib import Path

import pytest

from bench import check, harness
from bench.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
SECONDS = 15.0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    import torch
    spec = load_cell(workload, False)
    limit = spec.cell["limits"]["logit_gap"]
    for seed in SEEDS:
        run, weights = harness.execute(spec, seed, SECONDS, False, card,
                                       time.perf_counter())
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = check.control_gap(run, weights, card)
        out.update(workload=workload, seed=seed,
                   decisions_differing=check.decisions_differing(run)["value"],
                   reference_s=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        assert out["tokens"] > 0
        assert out["program"] <= limit < out["control"], (seed, out)
        del run, weights
        gc.collect()
        torch.cuda.empty_cache()

"""Small cells for the CPU tests: the benchmark's configurations at the
program's smoke widths (float32), the two traffic laws at small sizes."""

from __future__ import annotations

import json
from pathlib import Path

from bench.spec import CellSpec

BENCH = Path(__file__).resolve().parents[1]

MODELS = {
    "llama": {"num_layers": 3, "d_model": 64, "num_heads": 4,
              "num_kv_heads": 4, "d_ff": 172, "vocab_size": 160,
              "norm_eps": 1e-6, "rope_theta": 10000.0,
              "param_dtype": "float32", "compute_dtype": "float32"},
    "mamba1": {"num_layers": 4, "d_model": 64, "num_heads": 1,
               "num_kv_heads": 1, "d_ff": 0, "vocab_size": 128,
               "block_pattern": ["mamba"], "norm_eps": 1e-5,
               "ssm": {"d_inner": 128, "d_state": 8, "d_conv": 4,
                       "dt_rank": 8, "chunk": 4, "bcdt_rms": True},
               "param_dtype": "float32", "compute_dtype": "float32"},
}

TRAFFIC = {
    "generator": "tick_poisson", "lanes": 2, "max_len": 64, "page_size": 8,
    "prompt": {"law": "uniform", "low": 3, "high": 20},
    "output": {"law": "uniform", "low": 3, "high": 8},
    "cycle": [[2, 2.0], [2, 0.0]], "horizon": 400, "block": 8,
    "warmup_tokens": 2, "trace": {"start_iteration": 2, "iterations": 2},
    "sample_tokens": 24,
}


def cell(reference: str = "llama", *, trace: bool = False,
         limit: float = 1e-3, rate: float = 0.6) -> CellSpec:
    model = MODELS[reference]
    config = {"name": f"smoke-{reference}", "reference": reference,
              "model": model,
              "prefill_multiple": model.get("ssm", {}).get("chunk", 512)}
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    return CellSpec(name=f"smoke-{reference}", config=config,
                    traffic=dict(TRAFFIC),
                    cell={"rate": rate, "speeds": [1.0, 0.7, 1.4],
                          "limits": {"logit_gap": limit,
                                     "decisions_differing": 0}},
                    metrics=bench[kind])

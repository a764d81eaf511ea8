"""Small cells for the CPU tests: the benchmark's references at their
smoke widths (float32, each module's ``SMOKE``), the two traffic laws at
small sizes."""

from __future__ import annotations

import ast
import importlib
import json
from pathlib import Path

from bench.spec import CellSpec

BENCH = Path(__file__).resolve().parents[1]
PLAINREF = BENCH / "plainref"

# the sizes of the program's deepseek-v2-236b smoke model, written out:
# MLA with a query latent, a dense first layer, 2 shared and 8 routed
# experts, top 2
MLA_MOE = {"num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
           "d_ff": 192, "vocab_size": 160, "attn_type": "mla",
           "kv_lora_rank": 32, "q_lora_rank": 48, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16, "first_dense_layers": 1,
           "first_dense_d_ff": 192,
           "moe": {"num_experts": 8, "top_k": 2, "expert_d_ff": 48,
                   "num_shared_experts": 2, "shared_d_ff": 96,
                   "capacity_factor": 2.0},
           "param_dtype": "float32", "compute_dtype": "float32"}

TRAFFIC = {
    "generator": "tick_poisson", "lanes": 2, "max_len": 64, "page_size": 8,
    "prompt": {"law": "uniform", "low": 3, "high": 20},
    "output": {"law": "uniform", "low": 3, "high": 8},
    "cycle": [[2, 2.0], [2, 0.0]], "horizon": 400, "block": 8,
    "warmup_tokens": 2, "trace": {"start_iteration": 2, "iterations": 2},
    "sample_tokens": 160,
}


def references(directory: Path = PLAINREF) -> list[str]:
    """The model references in ``directory``: the modules that define a
    function ``parameters`` and a ``SMOKE`` at their top level, read from
    their source without importing them."""
    out = []
    for path in sorted(directory.glob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names.add(node.target.id)
        if {"parameters", "SMOKE"} <= names:
            out.append(path.stem)
    return out


def cell(reference: str = "llama", *, trace: bool = False,
         limit: float = 1e-3, rate: float = 0.6) -> CellSpec:
    model = importlib.import_module(f"bench.plainref.{reference}").SMOKE
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

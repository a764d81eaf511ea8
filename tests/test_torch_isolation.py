"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py`` and the
twins under ``experiments/port/``) import neither JAX nor anything of the
JAX package ``repro``.

Two checks: a fresh interpreter imports every ``repro_torch`` module and
finds no ``jax``/``repro`` module loaded, and an AST scan finds no import of
them in any port source file.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax_or_repro():
    mods = _modules()
    assert len(mods) >= 63
    for new in ("repro_torch.kernels.oddeven_sort",
                "repro_torch.kernels.eft_select",
                "repro_torch.core.heft_static", "repro_torch.core.heft_energy",
                "repro_torch.models", "repro_torch.models.config",
                "repro_torch.sched_integration.topology",
                "repro_torch.sched_integration.serve_scheduler",
                "repro_torch.sched_integration.cost_model",
                "repro_torch.sched_integration.fleet",
                "repro_torch.sched_integration.expert_placement",
                "repro_torch.configs", "repro_torch.configs.deepseek_7b",
                "repro_torch.models.layers", "repro_torch.models.ffn",
                "repro_torch.models.attention",
                "repro_torch.models.transformer", "repro_torch.models.model",
                "repro_torch.models.convert", "repro_torch.models.mamba",
                "repro_torch.models.moe", "repro_torch.serve",
                "repro_torch.serve.paging", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.dist",
                "repro_torch.dist.hints", "repro_torch.dist.sharding",
                "repro_torch.dist.compression", "repro_torch.launch.mesh",
                "repro_torch.launch.train", "repro_torch.train.trainer",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                "repro_torch.launch.cost_analysis", "repro_torch.analysis",
                "repro_torch.analysis.findings",
                "repro_torch.analysis.registry",
                "repro_torch.analysis.runner",
                "repro_torch.analysis.rules_ast",
                "repro_torch.analysis.rules_repo",
                "repro_torch.analysis.cli"):
        assert new in mods, new
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_no_port_source_imports_jax_or_repro():
    twins = sorted((REPO / "experiments" / "port").glob("*.py"))
    assert REPO / "experiments" / "port" / "hillclimb.py" in twins
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + twins
    offenders = [f"{p.relative_to(REPO)}:{line} imports {root}"
                 for p in files for line, root in _imported_roots(p)
                 if root in FORBIDDEN]
    assert offenders == []
    # the scan does see the port's own imports
    roots = {root for line, root in _imported_roots(PORT / "sched_integration"
                                                     / "fabric.py")}
    assert {"torch", "numpy", "repro_torch"} <= roots
    # ... the lazy imports inside functions too (cost_model reads SHAPES)
    lazy = [line for line, root in _imported_roots(
        PORT / "sched_integration" / "cost_model.py") if root == "repro_torch"]
    assert len(lazy) >= 2


def test_every_reference_module_of_the_slice_has_a_counterpart():
    slice_1 = ["core/heft_rt.py", "core/queue_model.py",
               "core/resource_model.py", "kernels/ref.py",
               "kernels/heft_fused.py", "kernels/fused_decision.py",
               "kernels/ops.py", "obs/log.py", "obs/metrics.py",
               "obs/trace.py", "obs/check.py", "obs/device.py",
               "sched_integration/fabric.py", "runtime/apps.py",
               "runtime/workload.py", "runtime/overhead.py",
               "runtime/simulator.py"]
    slice_2 = ["kernels/oddeven_sort.py", "kernels/eft_select.py",
               "core/heft_static.py", "core/heft_energy.py",
               "models/config.py", "sched_integration/topology.py",
               "sched_integration/serve_scheduler.py",
               "sched_integration/cost_model.py",
               "sched_integration/fleet.py",
               "sched_integration/expert_placement.py"]
    slice_5 = ["configs/__init__.py", "models/layers.py", "models/ffn.py",
               "models/attention.py", "models/transformer.py",
               "models/model.py", "serve/__init__.py", "serve/paging.py",
               "serve/engine.py", "launch/serve.py"]
    slice_5 += [f"configs/{p.name}" for p in
                (REPO / "src" / "repro" / "configs").glob("*.py")]
    slice_8 = ["dist/__init__.py", "dist/hints.py", "dist/sharding.py",
               "dist/compression.py", "launch/mesh.py"]
    slice_9 = ["launch/specs.py", "launch/dryrun.py"]
    slice_9 += [f"analysis/{p.name}" for p in
                (REPO / "src" / "repro" / "analysis").glob("*.py")]
    for rel in slice_1 + slice_2 + slice_5 + slice_8 + slice_9:
        assert (REPO / "src" / "repro" / rel).exists(), rel
        assert (PORT / rel).exists(), rel
    # XLA's HLO has no counterpart: the port counts the step as it runs
    assert (REPO / "src" / "repro" / "launch" / "hlo_analysis.py").exists()
    assert (PORT / "launch" / "cost_analysis.py").exists()
    # every module of the reference now has its counterpart
    ref = {p.relative_to(REPO / "src" / "repro").as_posix()
           for p in (REPO / "src" / "repro").rglob("*.py")
           if "__pycache__" not in p.parts}
    port = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert ref - port == {"launch/hlo_analysis.py"}
    for cu in ("heft_fused.cu", "fused_decision.cu", "oddeven_sort.cu",
               "eft_select.cu"):
        assert (PORT / "csrc" / cu).exists()
    # every Pallas kernel of the reference has a CUDA counterpart
    pallas = sorted(p.stem for p in (REPO / "src" / "repro" / "kernels")
                    .glob("*.py") if "pallas_call(" in p.read_text())
    assert pallas == ["eft_select", "fused_decision", "heft_fused",
                      "oddeven_sort"]
    for stem in pallas:
        assert (PORT / "csrc" / f"{stem}.cu").exists(), stem

"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither JAX nor anything of the JAX package ``repro``.

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
    assert len(mods) >= 25
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
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{p.relative_to(REPO)}:{line} imports {root}"
                 for p in files for line, root in _imported_roots(p)
                 if root in FORBIDDEN]
    assert offenders == []
    # the scan does see the port's own imports
    roots = {root for line, root in _imported_roots(PORT / "sched_integration"
                                                     / "fabric.py")}
    assert {"torch", "numpy", "repro_torch"} <= roots


def test_every_reference_module_of_the_slice_has_a_counterpart():
    slice_1 = ["core/heft_rt.py", "core/queue_model.py",
               "core/resource_model.py", "kernels/ref.py",
               "kernels/heft_fused.py", "kernels/fused_decision.py",
               "kernels/ops.py", "obs/log.py", "obs/metrics.py",
               "obs/trace.py", "obs/check.py", "obs/device.py",
               "sched_integration/fabric.py", "runtime/apps.py",
               "runtime/workload.py", "runtime/overhead.py",
               "runtime/simulator.py"]
    for rel in slice_1:
        assert (REPO / "src" / "repro" / rel).exists(), rel
        assert (PORT / rel).exists(), rel
    for cu in ("heft_fused.cu", "fused_decision.cu"):
        assert (PORT / "csrc" / cu).exists()

"""What the benchmark loads: never JAX or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` begins with
``repro``), nothing of ``benchmarks/`` or ``chip_smoke.py``, and, for the
plain references, nothing of the program either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from bench.tests.smoke import references

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def _loaded(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n" + code +
            "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _bench_modules() -> list[str]:
    mods = []
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts:
            continue
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_a_whole_run_loads_no_jax_and_no_benchmarks():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = [m["name"] for kind in ("end_to_end", "per_layer")
               for m in bench[kind]]
    code = "\n".join(f"import {m}" for m in _bench_modules() if m != "bench.run")
    code += ("\nfrom bench.spec import metric_reader\n"
             f"for n in {readers!r}: metric_reader(n)\n"
             "import time, torch\nfrom bench import result\n"
             "from bench.tests.smoke import cell\n"
             "torch.set_num_threads(1)\n"
             "result.measure(cell('llama', trace=True), 5, 1.0, True, 'cpu', "
             "time.perf_counter())\n"
             "import runpy; runpy.run_path('bench/run.py')\n")
    loaded = _loaded(code)
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_references_load_nothing_of_the_program():
    mods = [f"bench.plainref.{r}" for r in references()]
    assert mods, "no model reference found"
    loaded = _loaded("import " + ", ".join(
        mods + ["bench.plainref.heft_rt", "bench.plainref.precision"]))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_no_source_imports_them():
    for p in BENCH.rglob("*.py"):
        banned = FORBIDDEN | ({"repro_torch"} if "plainref" in p.parts
                              else set())
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (p, n)

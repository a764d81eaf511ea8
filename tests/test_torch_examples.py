"""The port's examples (``examples/port/``) with ``--device cpu`` print the
reference examples' numbers.  The two that spawn gloo ranks
(``serve_elastic``, ``train_pod_compressed``) run their ranks here too:
the live reshard is token-identical and the pod-compressed run restarts
and finishes.

Each pair runs in subprocesses: the port's example with ``--device cpu``
(the host paths, float64 where the reference's are), the reference's with
``_torch_ref.PREAMBLE`` first (so ``repro.models`` / ``repro.serve``
import on jax 0.9, in that process only).  Every number either prints —
decisions, cycle counts, latencies, frame rates, queue sizes, pages — must
be the same, in the same order.  The quickstart's paged requests run on
other random weights in the two packages; what it prints of them (prompt
and token counts, the oracle checks, the pages) is weight-independent.
"""

import os
import re
import subprocess
import sys

import pytest

from _torch_ref import PREAMBLE, REPO

NUMBER = re.compile(r"-?\d+(?:\.\d+)?|True|False")


def _port(name):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "port" / f"{name}.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _reference(name):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    script = (PREAMBLE + "import runpy\n"
              f"runpy.run_path({str(REPO / 'examples' / f'{name}.py')!r}, "
              "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("name", ["cedr_runtime_demo", "serve_with_heft",
                                  "quickstart"])
def test_port_example_prints_the_reference_numbers(name):
    got = NUMBER.findall(_port(name))
    want = NUMBER.findall(_reference(name))
    assert len(got) > 20
    assert got == want


def test_quickstart_checks_itself():
    out = _port("quickstart")
    assert "decisions bit-identical to software: True" in out
    assert out.count("bit-identical to dense generate: True") == 2
    assert "pages allocated == freed: 4 == 4" in out


def test_serve_elastic_simulation_and_live_reshard():
    """Part 1 prints the reference's numbers; part 2 (six gloo ranks, which
    the reference skips without six devices) reshards bit-identically."""
    out = _port("serve_elastic")
    sim, live = out.split("== live ServeEngine")
    ref = _reference("serve_elastic").split("(live reshard demo skipped")[0]
    assert NUMBER.findall(sim) == NUMBER.findall(ref)
    assert live.count("generation bit-identical") == 2


def test_train_pod_compressed_restarts_and_finishes():
    out = _port("train_pod_compressed")
    assert "injected failure at step 30" in out
    steps = re.findall(r"step\s+(\d+)\s+loss (\S+)", out)
    assert [int(s) for s, _ in steps] == [40, 60]
    assert all(0.0 < float(v) < 10.0 for _, v in steps)
    assert "error-feedback residual: 30 leaves, per-pod stacked (2, 160, 64)" \
        in out

"""Reach the JAX reference's models and serving stack from a port test.

``repro.models`` / ``repro.serve`` do not import on jax 0.9 in the test
process (``repro/dist/__init__.py`` asks ``p in batching.primitive_batchers``
and jax 0.9's proxy has no ``__contains__``).  A script run here executes in
a fresh interpreter that first gives the proxy a ``__contains__`` — inside
that process only, never in a conftest — then imports the reference, and
hands its results back as an ``.npz``.

Helpers shared with the scripts: ``rand_tree`` draws a parameter tree from
``np.random.default_rng`` on the reference's ``param_shapes`` and
``flat_tree`` / ``unflatten`` move a nested tree through the ``.npz`` under
``|``-joined keys.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

PREAMBLE = '''
import sys
import numpy as np
from jax.interpreters import batching
type(batching.primitive_batchers).__contains__ = lambda self, k: True

def rand_tree(shapes, rng, name=""):
    """Float32 leaves on the reference's shapes: matrices N(0, 1/fan_in),
    the embedding N(0, 1), norm weights and the other vectors (Mamba's
    conv_b, dt_bias, D) N(0, 0.1**2)."""
    if isinstance(shapes, dict):
        return {k: rand_tree(v, rng, k) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [rand_tree(v, rng, name) for v in shapes]
    x = rng.standard_normal(shapes)
    if name == "embed":
        pass
    elif name.endswith("norm") or len(shapes) == 1:
        x = 0.1 * x
    else:
        x = x / np.sqrt(shapes[-2])
    return x.astype(np.float32)

def flat_tree(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat_tree(v, f"{prefix}|{k}", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            flat_tree(v, f"{prefix}|{i}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out
'''


def run_reference(code: str, out: Path, timeout: int = 600):
    """Run ``code`` (after :data:`PREAMBLE`) with ``OUT`` bound to ``out``;
    returns the ``.npz`` it wrote."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    script = PREAMBLE + f"OUT = {str(out)!r}\n" + textwrap.dedent(code)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict under ``prefix|...`` keys (list levels come back as
    dicts keyed by index strings; the dense models have none)."""
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split("|")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree

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
import signal
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


# Opt-in preamble for the reference's pod path on jax 0.9 (the reference
# runs it on the jax it was written for): ``jax.make_mesh`` now gives
# ``Explicit`` axes, under which ``with_sharding_constraint`` in the
# trainer's ``_pod_split`` asserts, and ``jax.experimental.shard_map``
# lost ``auto=``.  Inside the subprocess only, meshes are built with
# ``Auto`` axes and ``shard_map`` forwards to ``jax.shard_map``.
JAX09_SHIMS = '''
import jax
import jax.experimental.shard_map as _sm

def _auto_mesh(shape, names, *args, devices=None, **kw):
    devs = devices if devices is not None else jax.devices()
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(list(devs)[:n]).reshape(shape), names)

def _shard_map(f, mesh, in_specs, out_specs, check_rep=True, auto=frozenset()):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs,
                         axis_names=set(mesh.axis_names) - set(auto),
                         check_vma=check_rep)

jax.make_mesh = _auto_mesh
_sm.shard_map = _shard_map
'''


def run_reference(code: str, out: Path, timeout: int = 600, *,
                  devices: int | None = None, shims: bool = False):
    """Run ``code`` (after :data:`PREAMBLE`) with ``OUT`` bound to ``out``;
    returns the ``.npz`` it wrote.  ``devices``: the host platform's device
    count (``XLA_FLAGS``, set before jax starts); ``shims``: add
    :data:`JAX09_SHIMS` after the preamble."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    if devices is not None:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices}")
    script = (PREAMBLE + (JAX09_SHIMS if shims else "")
              + f"OUT = {str(out)!r}\n" + textwrap.dedent(code))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# A world of gloo ranks on the CPU for the port's distributed tests: the
# script below runs ``code`` in every rank (``RANK`` / ``WORLD`` bound, the
# process group joined through a FileStore in the test's directory, so
# parallel test workers never share a port; ``tests/`` importable), and
# each rank returns the dict ``RESULT`` it fills as an ``.npz``.
_RANKS = '''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank, world, store, out, code_path):
    # a rank that aborts (SIGABRT, SIGSEGV) prints every thread's Python
    # stack to stderr, which the test's failure message carries
    import faulthandler
    faulthandler.enable(all_threads=True)
    with open(code_path) as f:
        code = f.read()
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    RANK, WORLD, RESULT = rank, world, {}
    try:
        exec(compile(code, "<rank code>", "exec"), dict(
            RANK=RANK, WORLD=WORLD, RESULT=RESULT, np=np, torch=torch,
            dist=dist))
    finally:
        np.savez(f"{out}/rank{rank}.npz", **RESULT)
        dist.destroy_process_group()


if __name__ == "__main__":
    world, store, out, code_path = sys.argv[1:5]
    mp.spawn(_worker, args=(int(world), store, out, code_path),
             nprocs=int(world))
'''


def run_ranks(code: str, world: int, tmp: Path, timeout: int = 300
              ) -> list[dict]:
    """Run ``code`` in ``world`` gloo ranks on the CPU; returns each rank's
    ``RESULT`` dict.  A rank that hangs fails the test at ``timeout``
    seconds (the whole process group is killed)."""
    tmp = Path(tmp)
    (tmp / "ranks_main.py").write_text(_RANKS)
    (tmp / "ranks_code.py").write_text(textwrap.dedent(code))
    store = tmp / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "ranks_main.py"), str(world), str(store),
         str(tmp), str(tmp / "ranks_code.py")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"ranks did not finish in {timeout} s")
    # room for an aborted rank's thread stacks before spawn's own report
    assert proc.returncode == 0, err[-12000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


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

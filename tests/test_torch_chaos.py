"""The serve launcher's ``--chaos`` path and ``HeftFrontEnd.estimate_s``
on the port, on the CPU.

* ``_resolve_targets`` mirrors ``test_chaos.py::
  test_launcher_resolves_unique_prefix_targets``.
* The launcher with ``--device cpu --paged --fused-scheduler --chaos``
  serves, fails over and re-serves token-identically.
* The simulator twin's goodput, re-queued and unserved counts equal the
  reference's ``simulate_serving`` + ``goodput`` on the same twin,
  timeline and SLO, written as the reference launcher's ``_run_chaos``
  builds them (the reference's scheduler side imports here; its launcher
  module does not, on jax 0.9).
* ``--min-goodput 101`` exits non-zero; ``estimate_s`` is the
  reference's ``_host_scale_s`` over the replica's speed.
"""

import ast
import json
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_ref import REPO

from repro_torch.launch.serve import _resolve_targets, chaos_twin, main
from repro_torch.sched_integration import FailureEvent

NAMES = ["replica0(x1.0)", "replica1(x0.7)", "replica2(x1.4)"]
SPEEDS = [1.0, 0.7, 1.4]

# replica loss by a unique prefix, a straggler at half speed, a degraded
# spine link: every kind of the twin's timeline, the link one on the
# spine topology
TIMELINE = {"events": [
    {"t": 0.8, "kind": "replica_loss", "target": "replica1"},
    {"t": 0.3, "kind": "straggler", "target": "replica2", "duration_s": 1.0,
     "factor": 2.0},
    {"t": 0.2, "kind": "link_degrade", "target": "pod0:spine",
     "duration_s": 1.0, "factor": 0.5},
]}


def test_launcher_resolves_unique_prefix_targets():
    names = ["replica0(x1.0)", "replica1(x0.7)"]
    tl = [FailureEvent(0.1, "replica_loss", "replica1"),
          FailureEvent(0.2, "link_degrade", "pod0:spine", duration_s=1.0,
                       factor=0.5)]
    out = _resolve_targets(tl, names)
    assert out[0].target == "replica1(x0.7)"
    assert out[1].target == "pod0:spine"          # link targets pass through
    with pytest.raises(SystemExit, match="matches"):
        _resolve_targets([FailureEvent(0.1, "replica_loss", "replica")],
                         names)
    with pytest.raises(SystemExit, match="no replicas"):
        _resolve_targets([FailureEvent(0.1, "replica_loss", "ghost")], names)


def _trace(tmp_path):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps(TIMELINE))
    return str(path)


def _argv(tmp_path, *extra):
    return ["--device", "cpu", "--paged", "--fused-scheduler", "--requests",
            "4", "--new-tokens", "4", "--chaos", _trace(tmp_path), *extra]


def test_launcher_chaos_run_fails_over_token_identically(tmp_path):
    out = main(_argv(tmp_path))
    chaos = out["chaos"]
    assert chaos["failover"] == {"lost": "replica1(x0.7)", "survivors": 2,
                                 "token_identical": True}
    assert chaos["failures"] == 3
    assert chaos["pct"] >= 90.0
    assert len(out["outputs"]) == 4


def test_launcher_exits_below_min_goodput(tmp_path):
    with pytest.raises(SystemExit, match="below --min-goodput"):
        main(_argv(tmp_path, "--min-goodput", "101"))


def _reference_twin(timeline, slo_s):
    """The reference launcher's twin (``repro/launch/serve.py:_run_chaos``)
    on the reference's scheduler."""
    from repro.sched_integration import (POLICIES, Replica, goodput,
                                         make_requests, simulate_serving,
                                         spine_topology)

    twin = [Replica(n, 25000.0 * s, 126000.0 * s)
            for n, s in zip(NAMES, SPEEDS)]
    rate = 24.0 * sum(SPEEDS)
    topo = None
    if any(e.kind in ("link_degrade", "link_partition") for e in timeline):
        pod_of = {r.name: f"pod{i}" for i, r in enumerate(twin)}
        topo = spine_topology(["gw"] + sorted(set(pod_of.values())), 100.0,
                              pod_of=pod_of, gateway="gw")
    load = make_requests(rate, 2.0, seed=0)
    clean = simulate_serving(twin, load, POLICIES["heft_rt"](),
                             active_params=7e9)
    chaos = simulate_serving(twin, load, POLICIES["heft_rt"](),
                             active_params=7e9, failure_events=timeline,
                             topology=topo)
    return {"goodput": goodput(chaos, load, slo_s),
            "goodput_clean": goodput(clean, load, slo_s),
            "requeued": int(chaos.requeued.sum()),
            "unserved": int((~chaos.served_mask).sum())}


@pytest.mark.parametrize("slo_s", [2.0, 0.05])
def test_twin_goodput_equals_the_reference(slo_s):
    from repro.sched_integration import FailureEvent as RefEvent

    fleet = [SimpleNamespace(name=n, speed=s) for n, s in zip(NAMES, SPEEDS)]
    port_tl = _resolve_targets(
        [FailureEvent(**e) for e in TIMELINE["events"]], NAMES)
    ref_tl = [RefEvent(e.t, e.kind, e.target, e.duration_s, e.factor,
                       e.reason) for e in port_tl]
    got = chaos_twin(port_tl, fleet, slo_s, device="cpu")
    want = _reference_twin(ref_tl, slo_s)
    assert {k: got[k] for k in want} == want
    assert got["requeued"] > 0          # the loss strikes work in flight


def _reference_host_scale():
    """``_host_scale_s`` from the reference's ``serve/engine.py`` source (the
    module itself needs ``repro.models``)."""
    src = (REPO / "src" / "repro" / "serve" / "engine.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_host_scale_s")
    scope = {}
    exec(compile(ast.Module([fn], []), "engine.py", "exec"), scope)
    return scope["_host_scale_s"]


def test_estimate_s_is_the_reference_formula():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import HeftFrontEnd, ReplicaHandle, ServeEngine

    cfg = get_smoke_config("deepseek-7b")
    params = init_params(cfg, device="cpu")
    fleet = [ReplicaHandle(n, ServeEngine(cfg, params, max_len=32, lanes=1),
                           speed=s) for n, s in zip(NAMES, SPEEDS)]
    front = HeftFrontEnd(fleet)
    ref = _reference_host_scale()
    for r in fleet:
        for pl, nt in [(8, 16), (47, 1), (4096, 512)]:
            assert front.estimate_s(pl, nt, r) == ref(pl, nt) / r.speed
    # the estimate is the column exec_estimates puts in the mapping event
    reqs = [(np.zeros(pl, np.int32), nt) for pl, nt in [(8, 16), (47, 1)]]
    ex = front.exec_estimates(reqs)
    assert ex[1, 2] == front.estimate_s(47, 1, fleet[2])

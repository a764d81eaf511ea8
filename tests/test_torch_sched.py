"""repro_torch.sched_integration's serving side against the JAX reference.

The serving simulator, the elastic fleet, the chaos tier, the topology, the
cost model and the expert placement are numpy in both packages; the port's
HEFT_RT policy runs on the port's MappingFabric with ``device="cpu"`` (the
float64 numpy host path).  Each scenario below is the scheduler-only part
of ``tests/test_chaos.py``, ``tests/test_elastic_fleet.py`` or
``tests/test_serve_sharded.py``, run once through ``repro.sched_integration``
(``R``) and once through the port (``S``) on the same seeded inputs: every
``ServeResult`` field, the re-queue counts, the final registers, the
controller's decision trace and the tracer's events must be equal bit for
bit (float64 on both sides, so the tolerance is 0).  The reference's own
assertions are kept on the port's run.

Tests that need a live engine (the paged engine, the front end, the
SIGKILL restore, re-sharding) or the reference's launcher wait for the port
of the engine.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

import repro.sched_integration as R
import repro_torch.sched_integration as S
from repro.core import heft_rt_numpy
from repro.obs import MetricsRegistry as RMetrics, Tracer as RTracer
from repro.sched_integration.serve_scheduler import \
    policy_heft_rt as r_policy_heft_rt
from repro_torch.obs import MetricsRegistry as SMetrics, Tracer as STracer
from repro_torch.sched_integration.serve_scheduler import policy_heft_rt

REPO = Path(__file__).resolve().parents[1]

settings.register_profile("ci", max_examples=20, deadline=None)
settings.load_profile("ci")


def _ref_models_config():
    """``repro.models.config`` loaded by path: importing ``repro.models``
    pulls in ``repro.dist``, which does not import on every jax."""
    spec = importlib.util.spec_from_file_location(
        "_reference_models_config", REPO / "src/repro/models/config.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(spec.name, mod)     # dataclasses look it up
    spec.loader.exec_module(sys.modules[spec.name])
    return sys.modules[spec.name]


# ---------------------------------------------------------------------------
# helpers: one scenario through both packages
# ---------------------------------------------------------------------------

def policy(m, name="heft_rt"):
    """``m.POLICIES[name]()``; the port's fabric policy on the CPU."""
    if m is S and name == "heft_rt":
        return m.POLICIES[name](device="cpu")
    return m.POLICIES[name]()


def _canon(x):
    """A comparable form: dataclasses by field, arrays as (dtype, shape,
    bytes), trace events without their thread id."""
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return ("f", np.float64(x).tobytes())
    if isinstance(x, np.generic):
        return _canon(x.item())
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, np.ascontiguousarray(x).tobytes())
    if isinstance(x, torch.Tensor):
        return _canon(x.numpy())
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _canon(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if hasattr(x, "ph") and hasattr(x, "args"):            # TraceEvent
        return ("event", x.name, x.ph, _canon(x.ts), _canon(x.dur),
                _canon(x.args))
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    raise TypeError(f"cannot compare {type(x)}")


def both(scenario):
    """Run ``scenario(R)`` and ``scenario(S)``; they must agree bitwise.
    Returns the port's outcome."""
    want = scenario(R)
    got = scenario(S)
    assert _canon(got) == _canon(want)
    return got


def _slow_fleet(m, n=2):
    """Replicas with multi-second service times (roofline at 7e9 params), so
    failure windows overlap in-flight work without huge request counts."""
    return [m.Replica(f"r{i}", 50.0, 500.0) for i in range(n)]


# ---------------------------------------------------------------------------
# the policy factory: the card by default, the float64 oracle on the CPU
# ---------------------------------------------------------------------------

def test_policy_fabric_without_a_device_takes_the_card(monkeypatch):
    """``make_policy_fabric()`` resolves to ``auto``: the cuda kernel on the
    card; without a card its first mapping event raises instead of running
    on the host."""
    monkeypatch.delenv("REPRO_TORCH_FABRIC_BACKEND", raising=False)
    ex = np.ones((3, 2))
    if torch.cuda.is_available():
        pol = S.POLICIES["heft_rt"]()
        pol(ex, np.zeros(2))
        assert pol.fabric().backend_effective == "cuda"
    else:
        pol = S.POLICIES["heft_rt"]()
        assert pol.fabric() is None                  # lazily built
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pol(ex, np.zeros(2))
    cpu = S.make_policy_fabric(device="cpu")
    cpu(ex, np.zeros(2))
    assert cpu.fabric().backend == "numpy"
    monkeypatch.setenv("REPRO_TORCH_FABRIC_BACKEND", "fused")
    fused = S.make_policy_fabric(device="cpu")
    fused(ex, np.zeros(2))
    assert fused.fabric().backend_effective == "cpu-plain"
    monkeypatch.setenv("REPRO_TORCH_FABRIC_BACKEND", "bogus")
    with pytest.raises(ValueError):             # factory-time, not event-time
        S.make_policy_fabric(device="cpu")


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), p=st.integers(1, 6))
def test_cpu_policy_equals_reference_policy_fabric(seed, p):
    """Continuous float64 service times: the port's ``device="cpu"`` policy
    decides as the reference's ``make_policy_fabric()`` and
    ``policy_heft_rt`` do, bit for bit, across fleet resizes."""
    rng = np.random.default_rng(seed)
    pol, jpol = S.make_policy_fabric(device="cpu"), R.make_policy_fabric()
    for q in (p, p + 2, max(p - 1, 1)):
        ex = rng.uniform(0.01, 3.0, (int(rng.integers(1, 30)), q))
        ex[rng.random(ex.shape[0]) < 0.1] = np.inf
        avail = rng.uniform(0.0, 2.0, q)
        got = pol(ex, avail)
        np.testing.assert_array_equal(got, jpol(ex, avail))
        np.testing.assert_array_equal(got, r_policy_heft_rt(ex, avail))
        np.testing.assert_array_equal(policy_heft_rt(ex, avail), got)


# ---------------------------------------------------------------------------
# chaos tier (tests/test_chaos.py)
# ---------------------------------------------------------------------------

@given(seed=st.integers(0, 2**31 - 1),
       name=st.sampled_from(sorted(R.POLICIES)))
def test_empty_failure_timeline_bit_identical(seed, name):
    def scenario(m):
        reqs = m.make_requests(rate_rps=300, duration_s=1.0, seed=seed)
        topo = m.fully_connected(["gw", "pod0"], 100.0, gateway="gw")
        a = m.simulate_serving(m.default_fleet(), reqs, policy(m, name),
                               active_params=7e9)
        b = m.simulate_serving(m.default_fleet(), reqs, policy(m, name),
                               active_params=7e9, failure_events=[],
                               topology=topo, retry_budget=1)
        return a, b

    a, b = both(scenario)
    for f in ("mean_latency", "p50_latency", "p99_latency", "achieved_rps"):
        assert getattr(a, f) == getattr(b, f) or np.isnan(getattr(a, f))
    for f in ("replica_util", "served_mask", "finish_times", "final_avail"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert b.requeued.sum() == 0


@given(seed=st.integers(0, 2**31 - 1))
def test_resize_failure_interleaving_replay_reaches_same_state(seed):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.choice(np.arange(1, 40), size=5, replace=False)) / 8.0
    strag_dur = float(rng.integers(1, 8)) / 4.0
    strag_fac = float(rng.integers(2, 5))

    def run(m, shuffle):
        reqs = m.make_spike_requests(2.0, 25.0, spike_start=0.5,
                                     spike_end=1.5, duration_s=5.0,
                                     seed=int(seed % 997))
        base = m.mesh_fleet("a", ((4, 4), (4, 4), (2, 2)))
        se = m.split_event(float(times[0]), base[1], [(2, 4), (2, 4)])
        grow = m.ResizeEvent(float(times[1]),
                             add=(m.mesh_fleet("a", ((2, 4),))[0],))
        me = m.merge_event(float(times[3]), se.add, (4, 4))
        resizes = [se, grow, me]
        fails = [
            m.FailureEvent(float(times[2]), "replica_loss", base[0].name),
            m.FailureEvent(float(times[4]), "straggler", base[2].name,
                           duration_s=strag_dur, factor=strag_fac),
        ]
        if shuffle:
            srng = np.random.default_rng(seed + 1)
            resizes = [resizes[i] for i in srng.permutation(len(resizes))]
            fails = [fails[i] for i in srng.permutation(len(fails))]
        ctl = m.FleetController(
            m.FleetControllerConfig(grow_backlog_s=2.0, cooldown_s=0.5,
                                    max_grown=1, straggler_factor=4.0),
            m.grown_replica_factory("a", (2, 2)))
        res = m.simulate_serving(base, reqs, policy(m), active_params=7e9,
                                 fleet_events=resizes, failure_events=fails,
                                 controller=ctl)
        return res, ctl.events

    a, _ = both(lambda m: run(m, False))
    b, _ = both(lambda m: run(m, True))
    for f in ("final_avail", "served_mask", "requeued", "finish_times",
              "replica_util"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.served_mask.all()


def test_replica_loss_requeues_unfinished_work():
    def scenario(m):
        reqs = m.make_requests(rate_rps=20, duration_s=0.5, seed=3)
        loss = [m.FailureEvent(0.3, "replica_loss", "r1", reason="pod down")]
        return m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                  active_params=7e9, failure_events=loss)

    r = both(scenario)
    assert r.served_mask.all()
    assert r.requeued.sum() > 0
    assert r.replica_util.shape == (1,)


def test_loss_after_last_dispatch_drains_in_flight_work():
    def scenario(m):
        reqs = m.make_requests(rate_rps=20, duration_s=0.5, seed=3)
        clean = m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                   active_params=7e9)
        loss = [m.FailureEvent(2.0, "replica_loss", "r1")]
        return clean, m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                         active_params=7e9,
                                         failure_events=loss)

    clean, r = both(scenario)
    assert np.nanmax(clean.finish_times) > 2.0
    assert r.served_mask.all() and r.requeued.sum() > 0


def test_loss_requeues_are_exempt_from_retry_budget():
    def scenario(m):
        reqs = m.make_requests(rate_rps=20, duration_s=0.5, seed=3)
        loss = [m.FailureEvent(0.3, "replica_loss", "r1")]
        return m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                  active_params=7e9, failure_events=loss,
                                  retry_budget=0)

    r = both(scenario)
    assert r.served_mask.all() and r.requeued.sum() > 0


def test_loss_emptying_the_fleet_raises():
    for m in (R, S):
        reqs = m.make_requests(rate_rps=20, duration_s=0.3, seed=1)
        with pytest.raises(ValueError, match="left the fleet empty"):
            m.simulate_serving(_slow_fleet(m, 1), reqs, policy(m),
                               active_params=7e9,
                               failure_events=[m.FailureEvent(
                                   0.2, "replica_loss", "r0")])


def test_exec_matrix_allowed_with_loss_rejected_with_windowed_kinds():
    def scenario(m):
        reqs = m.make_requests(rate_rps=20, duration_s=0.5, seed=1)
        ex = np.full((len(reqs), 2), 0.25)
        r = m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                               active_params=7e9, exec_matrix=ex,
                               failure_events=[m.FailureEvent(
                                   0.3, "replica_loss", "r1")])
        with pytest.raises(ValueError, match="pinned exec_matrix"):
            m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                               active_params=7e9, exec_matrix=ex,
                               failure_events=[m.FailureEvent(
                                   0.3, "straggler", "r1", duration_s=0.5,
                                   factor=2.0)])
        return r

    assert both(scenario).served_mask.all()


def test_link_kinds_require_topology():
    for m in (R, S):
        reqs = m.make_requests(rate_rps=20, duration_s=0.3, seed=1)
        with pytest.raises(ValueError, match="need a topology"):
            m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                               active_params=7e9,
                               failure_events=[m.FailureEvent(
                                   0.1, "link_partition", "pod0:spine",
                                   duration_s=0.5)])


def test_straggler_stretch_matches_analytic_mirror():
    k, ts = 3.0, 0.5

    def scenario(m):
        fleet = [m.Replica("solo", 50.0, 500.0)]
        reqs = [m.Request(0, 0.0, 1000, 100)]
        f0 = m.simulate_serving(fleet, reqs, policy(m),
                                active_params=7e9).finish_times[0]
        long_w = m.FailureEvent(ts, "straggler", "solo", duration_s=1e3,
                                factor=k)
        r1 = m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                                failure_events=[long_w])
        f1 = ts + k * (f0 - ts)
        dur = 0.5 * (f1 - ts)
        short_w = m.FailureEvent(ts, "straggler", "solo", duration_s=dur,
                                 factor=k)
        r2 = m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                                failure_events=[short_w])
        return f0, r1, r2

    f0, r1, r2 = both(scenario)
    assert ts < f0
    f1 = ts + k * (f0 - ts)
    assert r1.finish_times[0] == f1
    tr = ts + 0.5 * (f1 - ts)
    assert r2.finish_times[0] == tr + (f1 - tr) / k


def test_straggler_window_with_no_overlapping_work_leaves_no_trace():
    def scenario(m):
        reqs = m.make_requests(rate_rps=100, duration_s=0.5, seed=2)
        a = m.simulate_serving(m.default_fleet(), reqs, policy(m),
                               active_params=7e9)
        w = m.FailureEvent(50.0, "straggler", "v4-128", duration_s=1.0,
                           factor=8.0)
        b = m.simulate_serving(m.default_fleet(), reqs, policy(m),
                               active_params=7e9, failure_events=[w])
        return a, b

    a, b = both(scenario)
    assert np.nanmax(a.finish_times) < 50.0
    for f in ("finish_times", "replica_util", "final_avail"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.p99_latency == b.p99_latency


def test_controller_straggler_detection_backoff_and_reset():
    def scenario(m):
        ctl = m.FleetController(
            m.FleetControllerConfig(straggler_factor=2.0,
                                    straggler_min_backlog_s=0.1,
                                    straggler_cooldown_s=1.0),
            m.grown_replica_factory("a", (2, 2)))
        names = ["a", "b", "c"]
        hot = [0.1, 0.1, 5.0]
        flags = [ctl.observe_stragglers(t, names, b) for t, b in (
            (0.0, hot), (0.5, hot), (1.0, hot), (2.0, hot),
            (2.5, [0.1, 0.1, 0.1]), (2.6, hot))]
        off = m.FleetController(m.FleetControllerConfig(),
                                m.grown_replica_factory("a", (2, 2)))
        return (flags, ctl.trace, ctl.events,
                off.observe_stragglers(0.0, names, hot),
                ctl.observe_stragglers(9.9, ["a"], [99.0]))

    flags, trace, _, off, single = both(scenario)
    assert flags == [["c"], [], ["c"], [], [], ["c"]]
    assert [k for _, k, _ in trace] == ["remap"] * 3
    assert off == [] and single == []


def test_straggler_remap_requeues_within_retry_budget():
    def scenario(m):
        reqs = m.make_requests(rate_rps=200, duration_s=1.0, seed=5,
                               prefill_range=(128, 512), decode_range=(8, 32))
        w = m.FailureEvent(0.5, "straggler", "r3", duration_s=60.0,
                           factor=16.0)
        ctl = m.FleetController(
            m.FleetControllerConfig(grow_backlog_s=float("inf"),
                                    straggler_factor=2.0,
                                    straggler_min_backlog_s=0.5,
                                    straggler_cooldown_s=0.25),
            m.grown_replica_factory("a", (2, 2)))
        r = m.simulate_serving(_slow_fleet(m, 4), reqs, policy(m),
                               active_params=7e9, failure_events=[w],
                               controller=ctl, retry_budget=2)
        passive = m.simulate_serving(_slow_fleet(m, 4), reqs, policy(m),
                                     active_params=7e9, failure_events=[w])
        return r, passive, ctl.trace

    r, passive, trace = both(scenario)
    assert "remap" in [k for _, k, _ in trace]
    assert r.requeued.sum() > 0 and r.requeued.max() <= 2
    assert r.served_mask.all()
    assert r.p99_latency < passive.p99_latency


def test_link_target_parsing_and_validation():
    for m in (R, S):
        assert m.parse_link_target("b:a") == ("a", "b")
        for bad in ("a", "a:", ":b", "a:b:c"):
            with pytest.raises(ValueError, match="podA:podB"):
                m.parse_link_target(bad)
        topo = m.Topology()
        with pytest.raises(ValueError, match="self-link"):
            topo.connect("a", "a", 1.0)
        with pytest.raises(ValueError, match="bandwidth"):
            topo.connect("a", "b", 0.0)
        with pytest.raises(KeyError):
            topo.link("a", "b")


def test_transfer_contention_serializes_shared_links():
    def scenario(m):
        topo = m.spine_topology(["a", "b", "c"], 10.0, latency_s=0.001)
        t1 = topo.transfer_s(1e9, "a", "b", at=0.0)
        t2 = topo.transfer_s(1e9, "a", "c", at=0.0)
        t3 = topo.transfer_s(1e9, "b", "c", at=t2[1])
        topo2 = m.spine_topology(["a", "b"], 10.0)
        topo2.transfer_s(1e9, "a", "b", at=0.0, reserve=False)
        return t1, t2, t3, topo2.transfer_s(1e9, "a", "b", at=0.0)

    (s1, f1), (s2, f2), (s3, _), (s4, _) = both(scenario)
    assert s1 == 0.0 and f1 == pytest.approx(0.102)
    assert s2 == f1 and f2 == pytest.approx(f1 + 0.102)
    assert s3 == f2 and s4 == 0.0


def test_degrade_and_background_util_scale_bandwidth():
    def scenario(m):
        topo = m.fully_connected(["a", "b"], 10.0)
        out = [topo.transfer_s(1e9, "a", "b", reserve=False)[1]]
        topo.degrade("a", "b", 0.5)
        out.append(topo.transfer_s(1e9, "a", "b", reserve=False)[1])
        topo.set_background_util("a", "b", 0.5)
        out.append(topo.transfer_s(1e9, "a", "b", reserve=False)[1])
        topo.restore("a", "b")
        topo.set_background_util("a", "b", 0.0)
        out.append(topo.transfer_s(1e9, "a", "b", reserve=False)[1])
        with pytest.raises(ValueError, match="degrade factor"):
            topo.degrade("a", "b", 0.0)
        with pytest.raises(ValueError, match="background_util"):
            topo.set_background_util("a", "b", 1.0)
        return out

    assert both(scenario) == pytest.approx([0.1, 0.2, 0.4, 0.1])


def test_partition_delays_transfers_and_masks_reachability():
    def scenario(m):
        topo = m.spine_topology(["gw", "pod0"], 10.0, pod_of={"r0": "pod0"},
                                gateway="gw")
        topo.set_down("gw", "spine", 2.0)
        reach = [topo.replica_reachable("r0", at=1.0),
                 topo.replica_reachable("r0", at=2.0),
                 topo.replica_reachable("unmapped", at=1.0)]
        window = topo.transfer_s(1e9, "gw", "pod0", at=1.0)
        topo.set_down("gw", "spine", 1.0)
        return reach, window, topo.link("gw", "spine").down_until

    reach, (s, f), down_until = both(scenario)
    assert reach == [False, True, True]
    assert s == 2.0 and f == pytest.approx(2.1)
    assert down_until == 2.0


def test_collective_contends_with_migration_on_shared_links():
    def scenario(m):
        topo = m.spine_topology(["a", "b", "c"], 10.0)
        _, fm = topo.transfer_s(1e9, "a", "b", at=0.0)
        return fm, topo.collective_s(1e9, ["a", "b", "c"], at=0.0), \
            topo.collective_s(1e9, ["a"], at=3.0)

    fm, (s, f), single = both(scenario)
    assert s >= 0.0 and f >= fm + 2.0 * 1e9 * 2 / 3 / 10e9
    assert single == (3.0, 3.0)


def test_topology_joiner_pays_migration_horizon():
    def scenario(m):
        topo = m.spine_topology(["gw", "podj"], 10.0,
                                pod_of={"joiner": "podj"}, gateway="gw")
        reqs = m.make_requests(rate_rps=20, duration_s=0.5, seed=2)
        joiner = m.Replica("joiner", 50.0, 500.0)
        return m.simulate_serving(
            _slow_fleet(m, 1), reqs, policy(m), active_params=7e9,
            fleet_events=[m.ResizeEvent(0.2, add=(joiner,))], topology=topo)

    r = both(scenario)
    assert r.served_mask.all()
    assert r.final_avail[-1] >= 0.2 + S.migration_bytes(7e9) / 10e9
    assert S.migration_bytes(7e9) == R.migration_bytes(7e9)


def test_partition_diverts_new_admissions_and_recovers():
    def run(m, duration_s):
        topo = m.spine_topology(["gw", "pod0", "pod1"], 100.0,
                                pod_of={"r0": "pod0", "r1": "pod1"},
                                gateway="gw")
        ev = [m.FailureEvent(0.0, "link_partition", "pod1:spine",
                             duration_s=duration_s)]
        reqs = m.make_requests(rate_rps=20, duration_s=1.0, seed=4)
        return m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                  active_params=7e9, failure_events=ev,
                                  topology=topo)

    whole_run = both(lambda m: run(m, 1e3))
    assert whole_run.served_mask.all()
    assert whole_run.replica_util[1] == 0.0
    windowed = both(lambda m: run(m, 0.3))
    assert windowed.served_mask.all()
    assert windowed.replica_util[1] > 0.0


def test_failure_event_knob_validation():
    for m in (R, S):
        with pytest.raises(ValueError, match="failure kind"):
            m.FailureEvent(0.0, "meteor", "r0")
        with pytest.raises(ValueError, match="no target"):
            m.FailureEvent(0.0, "replica_loss", "")
        with pytest.raises(ValueError, match="duration_s"):
            m.FailureEvent(0.0, "straggler", "r0", factor=2.0)
        with pytest.raises(ValueError, match="factor must be > 1"):
            m.FailureEvent(0.0, "straggler", "r0", duration_s=1.0,
                           factor=0.5)
        with pytest.raises(ValueError, match=r"in \(0, 1\)"):
            m.FailureEvent(0.0, "link_degrade", "a:b", duration_s=1.0,
                           factor=1.5)
    assert S.FAILURE_KINDS == R.FAILURE_KINDS


def test_failure_timeline_schema_validation(tmp_path):
    good = {"events": [
        {"t": 0.5, "kind": "replica_loss", "target": "r0", "reason": "x"},
        {"t": 1.0, "kind": "straggler", "target": "r1",
         "duration_s": 0.5, "factor": 4.0},
    ]}
    bad = [([], "root must be an object"), ({}, "'events' list"),
           ({"events": [{"t": 0.0, "kind": "replica_loss", "target": "r0",
                         "severity": 9}]}, "unknown keys"),
           ({"events": [{"t": 0.0, "target": "r0"}]},
            "missing required 'kind'"),
           ({"events": [{"t": "soon", "kind": "replica_loss",
                         "target": "r0"}]}, r"events\[0\].t must be")]
    p = tmp_path / "chaos.json"
    p.write_text('{"events": [{"t": 0.25, "kind": "replica_loss", '
                 '"target": "r0"}]}')

    def scenario(m):
        for obj, match in bad:
            with pytest.raises(ValueError, match=match):
                m.validate_failure_timeline(obj)
        return (m.validate_failure_timeline(good),
                m.load_failure_timeline(str(p)))

    evs, loaded = both(scenario)
    assert [e.kind for e in evs] == ["replica_loss", "straggler"]
    assert loaded[0].t == 0.25


def test_goodput_counts_only_in_slo_serves():
    def scenario(m):
        reqs = [m.Request(0, 0.0, 100, 10), m.Request(1, 0.0, 100, 10),
                m.Request(2, 0.5, 100, 10)]
        res = m.ServeResult(3.0, 2.0, 0.5, 3.0, 1.75, np.zeros(1),
                            served_mask=np.array([True, True, False]),
                            finish_times=np.array([0.5, 3.0, np.nan]))
        return m.goodput(res, reqs, slo_s=1.0), m.goodput(res, reqs,
                                                           slo_s=10.0)

    assert both(scenario) == (1, 2)


def test_fabric_pe_mask_matches_oracle_on_masked_matrix():
    rng = np.random.default_rng(7)
    avg = rng.integers(0, 5, 10).astype(np.float32)
    ex = rng.integers(1, 16, (10, 4)).astype(np.float32)
    masked_ex = ex.copy()
    masked_ex[:, 1] = np.inf
    for backend in ("numpy", "cuda", "fused"):
        fab = S.MappingFabric(4, backend=backend, device="cpu")
        ref = S.MappingFabric(4, backend=backend, device="cpu")
        jfab = R.MappingFabric(4, backend="numpy")
        fab.set_pe_mask([False, True, False, False])
        jfab.set_pe_mask([False, True, False, False])
        got = fab.map_event(avg, ex)
        for g, w, j in zip(got, ref.map_event(avg, masked_ex),
                           jfab.map_event(avg, ex)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(np.asarray(g, np.float64),
                                          np.asarray(j, np.float64))
        np.testing.assert_array_equal(fab.avail, ref.avail)
        assert fab.avail[1] == 0.0


def test_fabric_pe_mask_validation_and_resize_clearing():
    fab = S.MappingFabric(3, backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="pe mask"):
        fab.set_pe_mask([True, False])
    fab.set_pe_mask([True, False, False])
    fab.grow(4)
    assert fab._pe_mask is None
    fab.set_pe_mask([True, False, False, False])
    fab.set_pe_mask(None)
    assert fab._pe_mask is None


def test_chaos_events_land_on_tracer_and_metrics_without_perturbing():
    def scenario(m):
        Tracer, Metrics = (RTracer, RMetrics) if m is R else (STracer,
                                                              SMetrics)
        reqs = m.make_requests(rate_rps=20, duration_s=0.5, seed=3)
        fails = [m.FailureEvent(0.3, "replica_loss", "r1", reason="chaos"),
                 m.FailureEvent(0.5, "straggler", "r0", duration_s=0.5,
                                factor=2.0)]
        tracer, metrics = Tracer(), Metrics()
        obs = m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                 active_params=7e9, failure_events=fails,
                                 tracer=tracer, metrics=metrics)
        plain = m.simulate_serving(_slow_fleet(m), reqs, policy(m),
                                   active_params=7e9, failure_events=fails)
        counters = [metrics.counter("serve.failures",
                                    kind="replica_loss").value,
                    metrics.counter("serve.failures", kind="straggler").value,
                    metrics.counter("serve.retries",
                                    cause="replica_loss").value,
                    metrics.counter("serve.served").value]
        return obs, plain, tracer.events(), counters

    obs, plain, events, counters = both(scenario)
    np.testing.assert_array_equal(obs.finish_times, plain.finish_times)
    np.testing.assert_array_equal(obs.final_avail, plain.final_avail)
    assert {"serve.failure", "serve.recovery", "serve.requeue",
            "serve.queue_depth"} <= {e.name for e in events}
    assert counters == [1, 1, plain.requeued.sum(), plain.served_mask.sum()]


# ---------------------------------------------------------------------------
# elastic fleet (tests/test_elastic_fleet.py)
# ---------------------------------------------------------------------------

def _event(rng, n, p):
    avg = rng.integers(0, 5, n).astype(np.float32)
    ex = rng.integers(1, 16, (n, p)).astype(np.float32)
    ex[rng.random(n) < 0.1] = np.inf
    return avg, ex


@given(seed=st.integers(0, 2**31 - 1), steps=st.integers(2, 10),
       backend=st.sampled_from(["numpy", "cuda", "fused", "torch"]))
def test_fabric_resize_sequence_matches_host_mirror(seed, steps, backend):
    rng = np.random.default_rng(seed)
    fab = S.MappingFabric(int(rng.integers(1, 6)), backend=backend,
                          device="cpu")
    mirror = np.zeros(fab.num_pes)
    for _ in range(steps):
        op = rng.integers(0, 4)
        if op == 0:
            avg, ex = _event(rng, int(rng.integers(1, 12)), fab.num_pes)
            fab.map_event(avg, ex)
            mirror = heft_rt_numpy(avg, ex, mirror)[4]
        elif op == 1:
            k = int(rng.integers(1, 4))
            fab.grow(fab.num_pes + k)
            mirror = np.concatenate([mirror, np.zeros(k)])
        elif op == 2 and fab.num_pes > 1:
            keep = np.sort(rng.choice(
                fab.num_pes, int(rng.integers(1, fab.num_pes)),
                replace=False))
            fab.shrink(keep)
            mirror = mirror[keep]
        elif op == 3:
            perm = rng.permutation(fab.num_pes)
            fab.remap(perm)
            new = np.empty(fab.num_pes)
            new[perm] = mirror
            mirror = new
        np.testing.assert_array_equal(fab.avail, mirror)

    fresh = S.MappingFabric(fab.num_pes, backend=backend, device="cpu",
                            avail=mirror)
    avg, ex = _event(rng, 8, fab.num_pes)
    for g, w in zip(fab.map_event(avg, ex, update=False),
                    fresh.map_event(avg, ex, update=False)):
        np.testing.assert_array_equal(g, w)


def test_fabric_grow_shrink_equals_fixed_p_replaying_surviving_events():
    rng = np.random.default_rng(5)
    P = 3
    fab = S.MappingFabric(P, backend="cuda", device="cpu")
    fixed = S.MappingFabric(P, backend="cuda", device="cpu")
    jfixed = R.MappingFabric(P, backend="jit")
    events = [_event(rng, 6, P) for _ in range(4)]
    for f in (fab, fixed, jfixed):
        f.map_event(*events[0])
    fab.grow(P + 2)
    for avg, ex in events[1:3]:
        ex_wide = np.concatenate(
            [ex, np.full((ex.shape[0], 2), np.inf, np.float32)], axis=1)
        fab.map_event(avg, ex_wide)
        fixed.map_event(avg, ex)
        jfixed.map_event(avg, ex)
    fab.shrink(np.arange(P))
    for f in (fab, fixed, jfixed):
        f.map_event(*events[3])
    np.testing.assert_array_equal(fab.avail, fixed.avail)
    np.testing.assert_array_equal(fab.avail, np.asarray(jfixed.avail))
    assert fab.resizes == 2 and fixed.resizes == 0


def test_fabric_resize_validation():
    fab = S.MappingFabric(4, backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="grow target"):
        fab.grow(2)
    with pytest.raises(ValueError, match="duplicates"):
        fab.shrink([0, 0, 1])
    with pytest.raises(ValueError, match="out of range"):
        fab.shrink([0, 7])
    with pytest.raises(ValueError, match="permutation"):
        fab.remap([0, 1, 1, 2])
    with pytest.raises(ValueError, match="num_pes"):
        fab.map_event(np.ones(3), np.ones((3, 5)))


def test_fabric_resize_stays_in_its_pe_bucket():
    """Grows inside one P bucket keep the bucket (and the resident register
    tensor); crossing it doubles the bucket, shrinking brings it back."""
    fab = S.MappingFabric(3, backend="cuda", device="cpu", min_pe_bucket=4)
    jfab = R.MappingFabric(3, backend="jit", min_pe_bucket=4)
    regs = fab._avail
    assert fab.p_bucket == jfab.p_bucket == 4
    fab.map_event(*_event(np.random.default_rng(0), 5, 3))
    for f in (fab, jfab):
        f.grow(4)
    assert fab.p_bucket == jfab.p_bucket == 4 and fab._avail is regs
    fab.map_event(*_event(np.random.default_rng(1), 5, 4))
    for f in (fab, jfab):
        f.grow(5)
    assert fab.p_bucket == jfab.p_bucket == 8
    for f in (fab, jfab):
        f.shrink([0, 1])
    assert fab.p_bucket == jfab.p_bucket == 4


def test_policy_fabric_survives_fleet_resize():
    rng = np.random.default_rng(2)
    pol = S.make_policy_fabric(device="cpu")
    for p in (3, 5, 2):
        ex = rng.integers(1, 16, (10, p)).astype(np.float64) / 8.0
        avail = rng.integers(0, 8, p).astype(np.float64) / 8.0
        np.testing.assert_array_equal(pol(ex, avail),
                                      r_policy_heft_rt(ex, avail))
    assert pol.fabric().num_pes == 2 and pol.fabric().resizes == 2


def test_empty_fleet_events_bit_identical_to_fixed_fleet():
    def scenario(m):
        reqs = m.make_requests(rate_rps=600, duration_s=1.0, seed=0)
        a = m.simulate_serving(m.default_fleet(), reqs, policy(m),
                               active_params=7e9)
        b = m.simulate_serving(m.default_fleet(), reqs, policy(m),
                               active_params=7e9, fleet_events=[])
        return a, b

    a, b = both(scenario)
    assert _canon(a) == _canon(b)


def test_grow_event_improves_spike_latency():
    def scenario(m):
        base = m.mesh_fleet("a", ((4, 4), (4, 4)))
        reqs = m.make_spike_requests(2.0, 30.0, spike_start=1.0,
                                     spike_end=2.0, duration_s=8.0, seed=1)
        static = m.simulate_serving(base, reqs, policy(m),
                                    active_params=7e9)
        grow = m.ResizeEvent(1.2, add=tuple(m.mesh_fleet("a", ((4, 4),))))
        elastic = m.simulate_serving(base, reqs, policy(m),
                                     active_params=7e9, fleet_events=[grow])
        return static, elastic

    static, elastic = both(scenario)
    assert elastic.served_mask.sum() >= static.served_mask.sum()
    assert elastic.p99_latency < static.p99_latency


def test_remove_event_is_drain_then_leave():
    def scenario(m):
        fleet = m.mesh_fleet("a", ((4, 4), (4, 4)))
        reqs = m.make_requests(rate_rps=3.0, duration_s=4.0, seed=3)
        ev = [m.ResizeEvent(1.0, remove=(fleet[1].name,))]
        return m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                                  fleet_events=ev)

    r = both(scenario)
    assert r.served_mask.all() and r.replica_util.shape == (1,)


def test_fleet_events_reject_exec_matrix_and_unknown_names():
    for m in (R, S):
        fleet = m.default_fleet()
        reqs = m.make_requests(rate_rps=100, duration_s=0.5, seed=4)
        ex = np.ones((len(reqs), len(fleet)))
        with pytest.raises(ValueError, match="exec_matrix"):
            m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                               exec_matrix=ex,
                               fleet_events=[m.ResizeEvent(0.1)])
        with pytest.raises(ValueError, match="no replica named"):
            m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                               fleet_events=[m.ResizeEvent(
                                   0.0, remove=("nope",))])


def test_split_merge_events_balance_devices():
    def scenario(m):
        fleet = m.mesh_fleet("a", ((2, 2), (4, 4)))
        with pytest.raises(ValueError, match="devices"):
            m.split_event(0.5, fleet[0], [(1, 1)])
        with pytest.raises(ValueError, match="devices"):
            m.merge_event(0.5, fleet, (2, 2))
        se = m.split_event(0.5, fleet[1], [(2, 4), (2, 4)])
        me = m.merge_event(2.0, se.add, (4, 4))
        reqs = m.make_requests(rate_rps=4.0, duration_s=4.0, seed=5)
        return fleet, se, me, m.simulate_serving(
            fleet, reqs, policy(m), active_params=7e9, fleet_events=[se, me])

    fleet, se, me, r = both(scenario)
    assert se.remove == (fleet[1].name,) and len(se.add) == 2
    assert all(x.compute_tflops == fleet[1].compute_tflops / 2
               for x in se.add)
    assert me.add[0].compute_tflops == fleet[1].compute_tflops
    assert r.served_mask.all()


def _two_cell_registry(m, mesh=(4, 4), decode=True):
    cells = [m.CostCell("a", "prefill", mesh, tokens_per_step=1024,
                        flops_per_device=1e12, bytes_per_device=1e9)]
    if decode:
        cells.append(m.CostCell("a", "decode", mesh, tokens_per_step=16,
                                flops_per_device=1e8, bytes_per_device=2e9))
    return m.CostModelRegistry(cells)


def test_fleet_event_joiner_gets_scaled_cost_cells():
    def scenario(m):
        reg = _two_cell_registry(m)
        fleet = m.mesh_fleet("a", ((4, 4), (4, 4)))
        joiner = m.mesh_fleet("a", ((2, 2),))[0]
        covered = [reg.covers(fleet[0]), reg.covers(joiner)]
        reqs = m.make_requests(rate_rps=6.0, duration_s=3.0, seed=6)
        r = m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                               cost_registry=reg,
                               fleet_events=[m.ResizeEvent(0.5,
                                                           add=(joiner,))])
        return covered, reg.covers(joiner), r, \
            reg.cell("a", "prefill", (2, 2)), reg.cell("a", "prefill", (4, 4))

    covered, after, _, cp, c44 = both(scenario)
    assert covered == [True, False] and after
    assert cp.flops_per_token == pytest.approx(c44.flops_per_token * 0.9)


def test_ensure_coverage_anchors_on_measured_cells_join_order_free():
    def scenario(m):
        def fresh():
            return _two_cell_registry(m, mesh=(1, 1))

        small = m.mesh_fleet("a", ((2, 2),))[0]
        big = m.mesh_fleet("a", ((4, 4),))[0]
        r1, r2 = fresh(), fresh()
        ok = [r1.ensure_coverage(small), r1.ensure_coverage(big),
              r2.ensure_coverage(big), r2.ensure_coverage(small)]
        return ok, [(r1.cell("a", k, (4, 4)), r2.cell("a", k, (4, 4)),
                     r1.cell("a", k, (1, 1))) for k in ("prefill", "decode")]

    ok, cells = both(scenario)
    assert all(ok)
    for c1, c2, measured in cells:
        assert c1.projected and c1 == c2 and not measured.projected
        assert c1.flops_per_token == pytest.approx(
            measured.flops_per_token / 0.9)


def test_make_requests_rejects_non_positive_rate():
    for m in (R, S):
        with pytest.raises(ValueError, match="positive"):
            m.make_requests(lambda t: 0.0 if t < 1 else 10.0, 5.0, seed=0)


def test_merge_event_rejects_mixed_chip_generations():
    for m in (R, S):
        fast = m.mesh_fleet("a", ((2, 2),), chip_tflops=200.0)[0]
        slow = m.mesh_fleet("a", ((2, 2),), chip_tflops=100.0)[0]
        with pytest.raises(ValueError, match="mixed"):
            m.merge_event(0.0, [fast, slow], (2, 4))


def test_ensure_coverage_atomic_when_kind_missing():
    for m in (R, S):
        reg = _two_cell_registry(m, decode=False)
        joiner = m.mesh_fleet("a", ((2, 2),))[0]
        assert not reg.ensure_coverage(joiner)
        assert reg.cell("a", "prefill", (2, 2)) is None


def test_controller_grows_on_spike_and_merges_back():
    def scenario(m):
        base = m.mesh_fleet("a", ((4, 4), (4, 4)))
        reqs = m.make_spike_requests(2.0, 30.0, spike_start=1.0,
                                     spike_end=2.0, duration_s=8.0, seed=1)
        ctl = m.FleetController(
            m.FleetControllerConfig(grow_backlog_s=1.0, shrink_backlog_s=0.3,
                                    cooldown_s=0.5, max_grown=3),
            m.grown_replica_factory("a", (4, 4)))
        elastic = m.simulate_serving(base, reqs, policy(m),
                                     active_params=7e9, controller=ctl)
        static = m.simulate_serving(base, reqs, policy(m),
                                    active_params=7e9)
        return elastic, static, ctl.trace, ctl.events, ctl.grown

    elastic, static, trace, _, grown = both(scenario)
    kinds = [k for _, k, _ in trace]
    assert "grow" in kinds and "shrink" in kinds
    assert elastic.p99_latency < static.p99_latency
    assert next(t for t, k, _ in trace if k == "grow") >= 1.0
    assert grown == [] or all(n.endswith(f"+g{i}")
                              for i, n in enumerate(grown))


def test_controller_p95_signal_windows_and_does_not_oscillate():
    def scenario(m):
        base = m.mesh_fleet("a", ((4, 4), (4, 4)))
        reqs = m.make_spike_requests(2.0, 30.0, spike_start=1.0,
                                     spike_end=2.0, duration_s=10.0, seed=1)
        ctl = m.FleetController(
            m.FleetControllerConfig(grow_backlog_s=float("inf"),
                                    grow_p95_s=1.5, p95_window_s=3.0,
                                    shrink_backlog_s=0.3, cooldown_s=0.5,
                                    max_grown=2),
            m.grown_replica_factory("a", (4, 4)))
        r = m.simulate_serving(base, reqs, policy(m), active_params=7e9,
                               controller=ctl)
        return r, ctl.trace, ctl.grown

    _, trace, grown = both(scenario)
    kinds = [k for _, k, _ in trace]
    assert "grow" in kinds and "shrink" in kinds
    assert all(k == "shrink" for k in kinds[kinds.index("shrink"):])
    assert grown == []


def test_pending_grow_event_rescues_dead_backlog():
    def scenario(m):
        dead = [m.Replica("dead", 0.0, 0.0)]
        reqs = m.make_requests(rate_rps=20.0, duration_s=0.3, seed=7)
        unserved = m.simulate_serving(dead, reqs, policy(m),
                                      active_params=7e9)
        live = m.mesh_fleet("a", ((4, 4),))[0]
        served = m.simulate_serving(
            dead, reqs, policy(m), active_params=7e9,
            fleet_events=[m.ResizeEvent(2.0, add=(live,))])
        return unserved, served

    unserved, served = both(scenario)
    assert not unserved.served_mask.any()
    assert served.served_mask.all()


def test_split_merge_reject_non_mesh_replicas():
    for m in (R, S):
        abstract = m.Replica("abstract", 1.0, 1.0)
        with pytest.raises(ValueError, match="mesh-backed"):
            m.split_event(0.0, abstract, [(1, 1)])
        with pytest.raises(ValueError, match="mesh-backed"):
            m.merge_event(0.0, [m.mesh_fleet("a", ((1, 1),))[0], abstract],
                          (2, 1))


def test_controller_cooldown_and_budget():
    def scenario(m):
        ctl = m.FleetController(
            m.FleetControllerConfig(grow_backlog_s=1.0, cooldown_s=1.0,
                                    max_grown=1),
            m.grown_replica_factory("a", (2, 2)))
        return [ctl.observe(0.0, backlog_s=5.0),
                ctl.observe(0.5, backlog_s=5.0),
                ctl.observe(2.0, backlog_s=5.0),
                ctl.observe(4.0, backlog_s=0.0, queue_depth=0),
                ctl.observe(9.0, backlog_s=0.0)]

    grow, cool, budget, shrink, done = both(scenario)
    assert grow is not None and len(grow.add) == 1
    assert cool is None and budget is None and done is None
    assert shrink is not None and shrink.remove


# ---------------------------------------------------------------------------
# cost model and mesh-backed fleets (tests/test_serve_sharded.py)
# ---------------------------------------------------------------------------

def _dryrun_dict(arch="deepseek_7b", shape="decode_32k", mesh="16x16",
                 flops=1e9, bytes_=2e9, wire=3e7):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "num_devices": 256,
        "flops_per_device": flops, "bytes_accessed_per_device": bytes_,
        "collectives": {"bytes_by_op": {"all-gather": wire},
                        "count_by_op": {"all-gather": 4},
                        "total_wire_bytes_per_device": wire},
    }


def test_models_config_copy_equals_reference():
    from repro_torch.models import SHAPES, ModelConfig, MoEConfig, SSMConfig

    ref = _ref_models_config()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    cfg = ModelConfig("t", 6, 64, 4, 2, 128, 100, block_pattern=("attn",
                                                                 "mamba"),
                      moe=MoEConfig(4, 2, 32, layer_period=3),
                      ssm=SSMConfig(128), window_pattern=("local", "global"))
    twin = ref.ModelConfig("t", 6, 64, 4, 2, 128, 100,
                           block_pattern=("attn", "mamba"),
                           moe=ref.MoEConfig(4, 2, 32, layer_period=3),
                           ssm=ref.SSMConfig(128),
                           window_pattern=("local", "global"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(twin)
    assert (cfg.period, cfg.num_stages) == (twin.period, twin.num_stages)
    for layer in range(6):
        assert (cfg.layer_kind(layer), cfg.is_moe_layer(layer),
                cfg.window_kind(layer)) == (twin.layer_kind(layer),
                                            twin.is_moe_layer(layer),
                                            twin.window_kind(layer))
    assert dataclasses.asdict(cfg.with_(d_ff=256)) == \
        dataclasses.asdict(twin.with_(d_ff=256))


def test_registry_round_trips_cell_path_artifacts(tmp_path):
    shapes = _ref_models_config().SHAPES
    paths = {}
    for shape in ("decode_32k", "prefill_32k"):
        p = tmp_path / f"deepseek_7b_{shape}_single.json"
        p.write_text(json.dumps(_dryrun_dict(shape=shape)))
        paths[shape] = p
    reg = S.CostModelRegistry()
    assert reg.load_dir(str(tmp_path)) == 2
    for shape in ("decode_32k", "prefill_32k"):
        sc = shapes[shape]
        cell = reg.cell("deepseek_7b", sc.kind, (16, 16))
        assert cell == S.CostCell.from_dryrun(
            json.loads(paths[shape].read_text()))
        tokens = sc.global_batch * (sc.seq_len if sc.kind == "prefill" else 1)
        want = R.CostCell("deepseek_7b", sc.kind, (16, 16),
                          tokens_per_step=tokens, flops_per_device=1e9,
                          bytes_per_device=2e9, wire_bytes_per_device=3e7)
        assert _canon(cell) == _canon(want)
        assert cell.num_devices == 256
        assert cell.flops_per_token == pytest.approx(1e9 * 256 / tokens)
        assert cell.wire_bytes_per_token == pytest.approx(3e7 * 256 / tokens)
    assert S.CostModelRegistry().load_dir(str(tmp_path / "none")) == 0
    assert len(S.registry_from_dryrun_artifacts(str(tmp_path))) == 2


def test_registry_skips_train_and_failed_cells():
    reg = S.CostModelRegistry()
    assert reg.register_dryrun(_dryrun_dict(shape="train_4k")) is None
    assert reg.register_dryrun({"arch": "x", "shape": "decode_32k",
                                "mesh": "16x16", "error": "boom"}) is None
    assert len(reg) == 0


def test_cost_cell_reads_a_device_mesh_shape():
    """Mesh descriptors: a tuple, an ``AxB`` string, or a torch
    ``DeviceMesh`` (its ``mesh`` tensor of ranks)."""
    class _Mesh:                       # the DeviceMesh attribute it reads
        mesh = torch.arange(8).reshape(2, 4)

    cells = [S.CostCell("a", "decode", mesh, tokens_per_step=4,
                        flops_per_device=1.0, bytes_per_device=2.0)
             for mesh in ((2, 4), "2x4", _Mesh())]
    assert {c.mesh_shape for c in cells} == {(2, 4)}
    assert S.CostModelRegistry(cells[:1]).cell("a", "decode", _Mesh()) \
        is not None
    with pytest.raises(ValueError, match="kind"):
        S.CostCell("a", "train", (1,), tokens_per_step=1,
                   flops_per_device=0.0, bytes_per_device=0.0)


def test_exec_tid_matrix_uncovered_is_bitwise_roofline():
    def scenario(m):
        fleet = m.mesh_fleet("deepseek-7b", ((16, 16), (4, 4)))
        reqs = m.make_requests(rate_rps=200, duration_s=0.5, seed=1)
        return (m.CostModelRegistry().exec_tid_matrix(reqs, fleet,
                                                      active_params=7e9),
                m.service_time_matrix(reqs, fleet, active_params=7e9))

    got, want = both(scenario)
    np.testing.assert_array_equal(got, want)


def _serve_cells(m, arch, mesh_shape, *, pf_flops_tok=2.1 * 7e9,
                 dc_bytes_tok=2.6 * 7e9):
    n = int(np.prod(mesh_shape))
    return [
        m.CostCell(arch, "prefill", mesh_shape, tokens_per_step=1024,
                   flops_per_device=pf_flops_tok * 1024 / n,
                   bytes_per_device=1e9),
        m.CostCell(arch, "decode", mesh_shape, tokens_per_step=16,
                   flops_per_device=1e8,
                   bytes_per_device=dc_bytes_tok * 16 / n),
    ]


def test_exec_tid_matrix_covered_column_values():
    def scenario(m):
        fleet = m.mesh_fleet("deepseek-7b", ((16, 16), (4, 4), (4, 4)),
                             ici_gbps=100.0)
        reg = m.CostModelRegistry(_serve_cells(m, "deepseek-7b", (16, 16)))
        reqs = m.make_requests(rate_rps=100, duration_s=0.5, seed=2)
        return (fleet, reg.covers(fleet[0]), reg.covers(fleet[1]),
                reg.exec_tid_matrix(reqs, fleet, active_params=7e9),
                m.service_time_matrix(reqs, fleet, active_params=7e9), reqs)

    fleet, c0, c1, ex, roof, reqs = both(scenario)
    assert c0 and not c1
    np.testing.assert_array_equal(ex[:, 1], roof[:, 1])
    assert (ex[:, 0] > roof[:, 0]).all()


def test_scaled_cell_monotone_per_device_cost():
    def scenario(m):
        base = _serve_cells(m, "a", (4, 4))[0]
        return base, [m.scaled_cell(base, s, efficiency=0.9)
                      for s in ((8, 8), (2, 2), (4, 4))]

    base, (up, down, same) = both(scenario)
    assert up.flops_per_device < base.flops_per_device < down.flops_per_device
    assert up.flops_per_token == pytest.approx(base.flops_per_token / 0.9)
    assert down.flops_per_token == pytest.approx(base.flops_per_token * 0.9)
    assert same.flops_per_token == pytest.approx(base.flops_per_token)


def test_simulate_serving_registry_equals_explicit_matrix():
    def scenario(m):
        fleet = m.mesh_fleet("deepseek-7b",
                             ((16, 16), (16, 16), (4, 16), (4, 4)))
        reg = m.CostModelRegistry(_serve_cells(m, "deepseek-7b", (16, 16)))
        for cell in _serve_cells(m, "deepseek-7b", (16, 16)):
            for shape in ((4, 16), (4, 4)):
                reg.register(m.scaled_cell(cell, shape, efficiency=0.9))
        reqs = m.make_requests(rate_rps=300, duration_s=1.0, seed=3)
        ex = reg.exec_tid_matrix(reqs, fleet, active_params=7e9)
        a = m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                               cost_registry=reg)
        b = m.simulate_serving(fleet, reqs, policy(m), active_params=7e9,
                               exec_matrix=ex)
        return a, b

    a, b = both(scenario)
    assert _canon(a) == _canon(b)


@given(n=st.integers(1, 24), seed=st.integers(0, 2**31 - 1))
def test_mesh_fleet_decisions_bit_identical_to_oracle(n, seed):
    """On the 1/8 grid (exact in float32) every backend of the port's
    policy, ``device="cpu"``, assigns like ``heft_rt_numpy``."""
    rng = np.random.default_rng(seed)
    P = 4
    ex = rng.integers(1, 32, (n, P)).astype(np.float64) / 8.0
    ex[rng.random(n) < 0.1] = np.inf
    avail = rng.integers(0, 16, P).astype(np.float64) / 8.0
    want = r_policy_heft_rt(ex, avail)
    for backend in ("numpy", "cuda", "fused", "torch"):
        pol = S.make_policy_fabric(backend, device="cpu")
        np.testing.assert_array_equal(pol(ex, avail), want)


def test_mesh_fleet_cost_model_decisions_bit_identical_numpy_backend():
    def scenario(m):
        fleet = m.mesh_fleet("deepseek-7b", ((16, 16), (4, 16), (4, 4)))
        reg = m.CostModelRegistry(_serve_cells(m, "deepseek-7b", (16, 16)))
        for cell in _serve_cells(m, "deepseek-7b", (16, 16)):
            for shape in ((4, 16), (4, 4)):
                reg.register(m.scaled_cell(cell, shape, efficiency=0.9))
        reqs = m.make_requests(rate_rps=200, duration_s=1.0, seed=4)
        return reg.exec_tid_matrix(reqs, fleet, active_params=7e9)

    ex = both(scenario)
    avail = np.zeros(ex.shape[1])
    got = S.make_policy_fabric("numpy", device="cpu")(ex, avail)
    order, assignment, _, _, _ = heft_rt_numpy(ex.mean(axis=1), ex, avail)
    want = np.empty(len(ex), dtype=np.int64)
    want[order] = assignment
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, R.make_policy_fabric("numpy")(ex, avail))


# ---------------------------------------------------------------------------
# MoE expert placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_placement_equals_reference_and_preserves_the_layer(seed):
    """Plan, balance and permutation equal the reference's; the permuted
    router and stacked experts compute the same MoE output (the routed
    expert follows its weights), and the plan beats round robin."""
    rng = np.random.default_rng(seed)
    E, P, d, f = 16, 4, 8, 6
    load = rng.zipf(1.5, E).astype(np.float64)
    speed = np.array([1.0, 1.0, 0.5, 2.0])
    plan = S.plan_expert_placement(load, speed)
    np.testing.assert_array_equal(plan, R.plan_expert_placement(load, speed))
    perm = S.placement_permutation(plan, P, E // P)
    np.testing.assert_array_equal(perm,
                                  R.placement_permutation(plan, P, E // P))
    assert sorted(perm.tolist()) == list(range(E))
    rr = S.round_robin_assignment(E, P)
    np.testing.assert_array_equal(rr, R.round_robin_assignment(E, P))
    assert S.makespan(load, speed, plan) == R.makespan(load, speed, plan)
    assert S.makespan(load, speed, plan) <= S.makespan(load, speed, rr)

    params = {"router": torch.from_numpy(rng.normal(size=(d, E))),
              "experts": {"w_in": torch.from_numpy(rng.normal(size=(E, d, f))),
                          "w_out": torch.from_numpy(
                              rng.normal(size=(E, f, d)))}}
    moved = S.apply_placement(params, perm)
    assert params["router"].shape == moved["router"].shape
    x = torch.from_numpy(rng.normal(size=(5, d)))

    def moe(p):
        top = torch.argmax(x @ p["router"], dim=-1)
        h = torch.einsum("td,tdf->tf", x, p["experts"]["w_in"][top])
        return torch.einsum("tf,tfd->td", h, p["experts"]["w_out"][top])

    torch.testing.assert_close(moe(moved), moe(params), rtol=0, atol=0)
    for k in ("w_in", "w_out"):
        assert torch.equal(moved["experts"][k], params["experts"][k][perm])

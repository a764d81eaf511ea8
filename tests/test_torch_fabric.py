"""repro_torch's MappingFabric against the JAX reference fabric.

The port's device backends run on ``device="cpu"`` here, where the ``cuda``
and ``fused`` backends run their kernels' plain versions.  They are held
against the JAX fabric (``pallas`` in interpret mode, ``jit``) and against
the float64 ``heft_rt_numpy`` oracle on a host mirror, through random
interleavings of every register-touching operation.  Inputs are small
integers (and NaN keys), exact in float32; the tolerance is bitwise (0).
"""

import warnings

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.core import heft_rt_numpy
from repro.sched_integration import MappingFabric as JaxFabric
from repro.sched_integration import default_fleet, make_requests
from repro.sched_integration import eft_dispatch_numpy as j_dispatch
from repro.sched_integration import heft_rt_fast as j_fast
from repro.sched_integration import make_policy_fabric as j_policy_fabric
from repro.sched_integration import pow2_bucket as j_pow2
from repro.sched_integration import service_time_matrix as j_stm

from repro_torch.kernels import decision_hw, pack_tick_outputs
from repro_torch.obs import accumulate_counters
from repro_torch.sched_integration import (MappingFabric, eft_dispatch_numpy,
                                           heft_rt_fast, make_policy_fabric,
                                           pow2_bucket, service_time_matrix)

# (port backend, JAX backend it is held against)
PAIRS = [("cuda", "pallas"), ("fused", "jit"), ("torch", "jit")]


def _event(rng, n, p, inf_frac=0.2):
    avg = rng.integers(0, 6, n).astype(np.float32)
    avg[rng.random(n) < 0.1] = np.nan            # nanmean of an all-inf row
    ex = rng.integers(1, 16, (n, p)).astype(np.float32)
    ex[rng.random(n) < inf_frac] = np.inf
    ex[rng.random((n, p)) < 0.1] = np.inf
    return avg, ex


def _as64(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_as64(g), _as64(w))


def _jax_fabric(backend, p, **kw):
    if backend == "pallas":
        kw["interpret"] = True
    return JaxFabric(p, backend=backend, **kw)


@settings(max_examples=6, deadline=None)
@given(pair=st.sampled_from(PAIRS), seed=st.integers(0, 2**31 - 1))
def test_random_op_interleaving_equals_jax_fabric_and_oracle(pair, seed):
    port_backend, jax_backend = pair
    rng = np.random.default_rng(seed)
    p = int(rng.integers(2, 6))
    fab = MappingFabric(p, backend=port_backend, device="cpu",
                        device_counters=True)
    jfab = _jax_fabric(jax_backend, p, device_counters=True)
    mirror = np.zeros(p)                 # host registers for the oracle
    mask = None
    for _ in range(10):
        op = int(rng.integers(0, 7))
        if op in (0, 1):
            n = int(rng.integers(1, 20))
            avg, ex = _event(rng, n, fab.num_pes)
            exm = ex.copy()
            if mask is not None:
                exm[:, mask] = np.inf
            key = np.where(np.isnan(avg), -np.inf, avg)
            if op == 0:                  # resident registers
                got, want = fab.map_event(avg, ex), jfab.map_event(avg, ex)
                oracle = heft_rt_numpy(key, exm, mirror)
                mirror = oracle[4]
            else:                        # explicit, registers untouched
                av = rng.integers(0, 9, fab.num_pes).astype(np.float32)
                got = fab.map_event(avg, ex, av, update=False)
                want = jfab.map_event(avg, ex, av, update=False)
                oracle = heft_rt_numpy(key, exm, av)
            _same(got, want)
            _same(got, oracle)
        elif op == 2:
            b, n = int(rng.integers(1, 4)), int(rng.integers(1, 12))
            events = [_event(rng, n, fab.num_pes) for _ in range(b)]
            avg, ex = (np.stack(c) for c in zip(*events))
            av = rng.integers(0, 9, (b, fab.num_pes)).astype(np.float32)
            _same(fab.map_batch(avg, ex, av), jfab.map_batch(avg, ex, av))
        elif op == 3 and fab.num_pes > 1:
            m = rng.random(fab.num_pes) < 0.4
            mask = m if m.any() and not m.all() else None
            fab.set_pe_mask(mask)
            jfab.set_pe_mask(mask)
        elif op == 4:
            joined = float(rng.integers(0, 5))
            for f in (fab, jfab):
                f.grow(f.num_pes + 1, avail=joined)
            mirror = np.append(mirror, joined)
            mask = None
        elif op == 5 and fab.num_pes > 1:
            keep = np.sort(rng.choice(fab.num_pes, size=fab.num_pes - 1,
                                      replace=False))
            for f in (fab, jfab):
                f.shrink(keep)
            mirror = mirror[keep]
            mask = None
        else:
            assert fab.drain_counters() == jfab.drain_counters()
        np.testing.assert_array_equal(_as64(fab.avail), _as64(jfab.avail))
        np.testing.assert_array_equal(_as64(fab.avail), mirror)
    assert fab.drain_counters() == jfab.drain_counters()


@pytest.mark.parametrize("backend", ["cuda", "fused", "numpy"])
def test_from_reference_state_continues_the_jax_stream(backend):
    rng = np.random.default_rng(7)
    jfab = JaxFabric(4, backend="jit", device_counters=True, min_bucket=4)
    for n in (3, 9, 5):
        jfab.map_event(*_event(rng, n, 4))
    jfab.grow(5, avail=2.0)
    jfab.map_event(*_event(rng, 6, 5))
    jfab.set_pe_mask(np.array([False, True, False, False, True]))
    state = {"avail": jfab.avail, "pe_mask": jfab._pe_mask,
             "counters": jfab.drain_counters(reset=False),
             "num_pes": jfab.num_pes, "min_bucket": jfab.min_bucket,
             "min_pe_bucket": jfab.min_pe_bucket,
             "max_bucket": jfab.max_bucket}
    fab = MappingFabric.from_reference_state(state, backend=backend,
                                             device="cpu")
    assert fab.num_pes == 5 and fab.p_bucket == jfab.p_bucket
    assert fab.bucket_size(3) == jfab.bucket_size(3) == 4
    np.testing.assert_array_equal(_as64(fab.avail), _as64(jfab.avail))
    for n in (4, 11, 1, 17):
        avg, ex = _event(rng, n, 5)
        _same(fab.map_event(avg, ex), jfab.map_event(avg, ex))
        np.testing.assert_array_equal(_as64(fab.avail), _as64(jfab.avail))
    fab.set_pe_mask(None)
    jfab.set_pe_mask(None)
    avg, ex = _event(rng, 8, 5)
    _same(fab.map_event(avg, ex), jfab.map_event(avg, ex))
    assert fab.drain_counters() == jfab.drain_counters()


def test_resident_registers_chain_and_explicit_avail_leaves_them():
    rng = np.random.default_rng(3)
    fab = MappingFabric(3, backend="cuda", device="cpu", avail=[1, 0, 2])
    regs = fab._avail
    mirror = np.array([1.0, 0.0, 2.0])
    for n in (5, 9, 2):
        avg, ex = _event(rng, n, 3)
        before = fab.avail.copy()
        fab.map_event(avg, ex, np.zeros(3, np.float32), update=False)
        np.testing.assert_array_equal(fab.avail, before)
        _, _, _, _, new = fab.map_event(avg, ex)
        mirror = heft_rt_numpy(np.where(np.isnan(avg), -np.inf, avg), ex,
                               mirror)[4]
        np.testing.assert_array_equal(_as64(new), mirror)
    assert fab._avail is regs            # one resident tensor, updated in place
    fab.map_event(*_event(rng, 4, 3), avail=np.ones(3), update=True)
    assert fab._avail is regs
    assert fab.events == 7


def test_assign_dispatch_and_policy_fabric_equal_reference():
    rng = np.random.default_rng(9)
    fab = MappingFabric(4, backend="cuda", device="cpu")
    jfab = JaxFabric(4, backend="jit")
    for n in (1, 6, 13):
        _, ex = _event(rng, n, 4)
        av = rng.integers(0, 9, 4).astype(np.float32)
        np.testing.assert_array_equal(fab.assign(ex, av), jfab.assign(ex, av))
        with warnings.catch_warnings():       # all-inf rows: NaN keys
            warnings.simplefilter("ignore", RuntimeWarning)
            avg = np.nanmean(np.where(np.isfinite(ex), ex, np.nan), axis=1)
        cap = rng.integers(0, 3, 4)
        want = j_dispatch(avg, ex, av, cap)
        assert fab.dispatch(avg, ex, av, cap) == want
        assert eft_dispatch_numpy(avg, ex, av, cap) == want
        for g, w in zip(heft_rt_fast(avg, ex, av), j_fast(avg, ex, av)):
            np.testing.assert_array_equal(g, w)
    pol = make_policy_fabric("cuda", device="cpu")
    jpol = j_policy_fabric("jit")
    for p in (3, 3, 5, 2):                   # fleet resizes mid-stream
        ex = rng.integers(1, 20, (7, p)).astype(np.float64)
        av = rng.integers(0, 5, p).astype(np.float64)
        np.testing.assert_array_equal(pol(ex, av), jpol(ex, av))
    assert pol.fabric().num_pes == 2


def test_tick_decision_api_roundtrip():
    rng = np.random.default_rng(12)
    fab = MappingFabric(4, backend="fused", device="cpu", device_counters=True)
    twin = MappingFabric(4, backend="fused", device="cpu",
                         device_counters=True)
    jfab = JaxFabric(4, backend="fused", device_counters=True)
    for f in (fab, twin):
        f.set_pe_mask(np.array([False, False, True, False]))
    for n in (5, 5, 12):
        avg, ex = _event(rng, n, 4)
        a_p, ex_p, valid, av, mask, counters, p_valid = \
            fab.tick_decision_inputs(avg, ex)
        ja, jex, jvalid = jfab.tick_decision_inputs(avg, ex)[:3]
        for g, w in ((a_p, ja), (ex_p, jex), (valid, jvalid)):
            np.testing.assert_array_equal(g, w)
        res = decision_hw(torch.from_numpy(a_p), torch.from_numpy(ex_p), av,
                          mask, out_avail=av)
        accumulate_counters(counters, res.assignment, res.new_avail,
                            torch.from_numpy(valid), p_valid)
        buf = pack_tick_outputs(torch.zeros(0, dtype=torch.int32), res)
        got = fab.commit_tick_decision(n, buf.numpy(), res.new_avail, counters)
        _same(got, twin.map_event(avg, ex))
        np.testing.assert_array_equal(fab.avail, twin.avail)
    assert fab.events == twin.events == 3
    assert fab.drain_counters() == twin.drain_counters()
    with pytest.raises(ValueError):
        MappingFabric(4, backend="cuda", device="cpu").tick_decision_inputs(
            avg, ex)


def test_backend_selection_and_device_rules(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FABRIC_BACKEND", raising=False)
    assert MappingFabric(2, device="cpu").backend == "numpy"
    for backend in ("torch", "cuda", "fused"):
        fab = MappingFabric(2, backend=backend, device="cpu")
        assert fab.backend_effective == "cpu-plain"
    assert MappingFabric(2, backend="numpy", device="cpu").backend_effective \
        == "numpy"
    with pytest.raises(ValueError):              # plain path never on the card
        MappingFabric(2, backend="torch", device="cuda")
    with pytest.raises(ValueError):
        MappingFabric(2, backend="jit", device="cpu")
    monkeypatch.setenv("REPRO_TORCH_FABRIC_BACKEND", "fused")
    assert MappingFabric(2, device="cpu").backend == "fused"
    monkeypatch.setenv("REPRO_TORCH_FABRIC_BACKEND", "bogus")
    with pytest.raises(ValueError):
        MappingFabric(2, device="cpu")
    monkeypatch.delenv("REPRO_TORCH_FABRIC_BACKEND")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):        # never quietly on the CPU
            MappingFabric(2)
    with pytest.raises(ValueError):
        MappingFabric(2, device="cpu").drain_counters()


def test_buckets_and_service_time_matrix_equal_reference():
    for n, k in ((0, 1), (1, 8), (9, 8), (1330, 8), (2048, 8), (5, 4)):
        assert pow2_bucket(n, k) == j_pow2(n, k)
    fab = MappingFabric(5, backend="cuda", device="cpu")
    jfab = JaxFabric(5, backend="jit")
    assert fab.p_bucket == jfab.p_bucket == 8
    for n in (1, 8, 9, 1330):
        assert fab.bucket_size(n) == jfab.bucket_size(n)
    assert fab.bucket_size(1330) == 2048
    with pytest.raises(ValueError):
        fab.bucket_size(1 << 17)
    reqs = make_requests(50.0, 0.5, seed=0)
    fleet = default_fleet()
    np.testing.assert_array_equal(
        service_time_matrix(reqs, fleet, active_params=7e9),
        j_stm(reqs, fleet, active_params=7e9))


def test_observability_is_read_only_and_records_dispatches():
    from repro_torch.obs import MetricsRegistry, Tracer

    rng = np.random.default_rng(21)
    tr, m = Tracer(), MetricsRegistry()
    fab = MappingFabric(4, backend="cuda", device="cpu", tracer=tr,
                        metrics=m, device_counters=True)
    bare = MappingFabric(4, backend="cuda", device="cpu", device_counters=True)
    for n in (5, 5, 30):
        avg, ex = _event(rng, n, 4)
        _same(fab.map_event(avg, ex), bare.map_event(avg, ex))
    assert fab.drain_counters() == bare.drain_counters()
    names = [e.name for e in tr.events()]
    assert names.count("fabric.map_event") == 3
    assert m.histogram("fabric.decision_s", backend="cuda").count == 40
    fab.grow(6)
    assert m.counter("fabric.resizes").value == 1
    assert m.gauge("fabric.num_pes").value == 6
    assert "fabric.resize" in {e.name for e in tr.events()}

"""repro_torch.runtime (the CEDR twin) against the JAX reference runtime.

The port's ``CedrSimulator`` dispatching through ``make_dispatch_fabric(
"cuda", device="cpu")`` (the fused kernel's plain version) and the JAX
``CedrSimulator`` through ``make_dispatch_fabric("jit")`` run the same
seeded workload on the paper's SoC.  Both fabrics decide in float32, so the
comparison is exact: every ``SimResult`` field must be identical (tolerance
0).  The copied apps / workload / overhead modules must equal the
reference's.
"""

import dataclasses

import numpy as np
import pytest

import repro.runtime as ref
import repro_torch.runtime as port
from repro.runtime import apps as ref_apps
from repro_torch.runtime import apps as port_apps


def _assert_same_result(a, b):
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f.name)


@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_cedr_twin_device_backend_equals_jax_jit_fabric(backend):
    pes = port.paper_soc_pe_types()
    arrivals = port.low_latency_arrivals(100, seed=1)
    assert arrivals == ref.low_latency_arrivals(100, seed=1)
    got = port.CedrSimulator(
        pes, dispatch=port.make_dispatch_fabric(backend, device="cpu"),
        overhead=port.HW_MODEL, seed=7).run(arrivals)
    want = ref.CedrSimulator(
        pes, dispatch=ref.make_dispatch_fabric("jit"),
        overhead=ref.HW_MODEL, seed=7).run(arrivals)
    _assert_same_result(got, want)
    assert got.completed_apps == got.num_apps == 40


def test_cedr_twin_host_dispatch_equals_reference_oversubscribed():
    """The default (numpy host) dispatcher on the oversubscribed Fig. 6
    regime: identical results and the same frame-rate ordering."""
    pes = port.paper_soc_pe_types()
    arr = port.high_latency_arrivals(600, seed=1)
    for model in ("SW_MODEL", "HW_MODEL"):
        got = port.CedrSimulator(pes, overhead=getattr(port, model),
                                 seed=7).run(arr)
        want = ref.CedrSimulator(pes, overhead=getattr(ref, model),
                                 seed=7).run(arr)
        _assert_same_result(got, want)
    assert got.max_queue_size > 100


def test_dispatchers_registry_matches_reference():
    assert sorted(port.DISPATCHERS) == sorted(ref.DISPATCHERS)
    pes = port.paper_soc_pe_types()
    arr = port.high_latency_arrivals(150, seed=3)
    for name in ("round_robin", "earliest_idle", "random"):
        got = port.CedrSimulator(pes, dispatch=port.DISPATCHERS[name](),
                                 seed=2).run(arr)
        want = ref.CedrSimulator(pes, dispatch=ref.DISPATCHERS[name](),
                                 seed=2).run(arr)
        _assert_same_result(got, want)


def test_copied_apps_workload_and_overhead_equal_reference():
    assert port_apps.EXEC_TABLE_MS == ref_apps.EXEC_TABLE_MS
    assert port.paper_soc_pe_types() == ref.paper_soc_pe_types()
    assert port.make_soc(2, 3) == ref.make_soc(2, 3)
    for name in ("RC", "TM", "PD", "TX"):
        a, b = port.get_app(name), ref.get_app(name)
        assert a.num_tasks == b.num_tasks and a.frame_kb == b.frame_kb
        assert [(t.name, t.task_type, tuple(t.deps)) for t in a.tasks] == \
            [(t.name, t.task_type, tuple(t.deps)) for t in b.tasks]
        pes = port.paper_soc_pe_types()
        np.testing.assert_array_equal(
            a.exec_matrix(pes, noise=np.random.default_rng(4)),
            b.exec_matrix(pes, noise=np.random.default_rng(4)))
    for rate in (25.0, 310.5, 700.0):
        assert port.frames_per_second(rate, 1280) == \
            ref.frames_per_second(rate, 1280)
        assert port.high_latency_arrivals(rate, seed=5, repeats=2) == \
            ref.high_latency_arrivals(rate, seed=5, repeats=2)
    np.testing.assert_array_equal(port.paper_injection_sweep_mbps(),
                                  ref.paper_injection_sweep_mbps())
    for n in (0, 1, 5, 64, 1330):
        for m in ("sw_overhead_s", "hw_compute_s", "hw_transfer_s",
                  "hw_overhead_s"):
            assert getattr(port, m)(n) == getattr(ref, m)(n)
        assert port.HW_MODEL(n) == ref.HW_MODEL(n)

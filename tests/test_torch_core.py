"""repro_torch.core against the JAX reference ``repro.core``.

The same seeded numpy inputs go through ``repro.core.heft_rt`` (jnp) and the
port's plain PyTorch ``heft_rt``; the tolerance is bitwise (0): every input
is a small integer (or ±inf / NaN / -0.0), exact in float32, so the two must
agree slot for slot, and with ``heft_rt_numpy`` in float64.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hypothesis_compat import given, settings, st

import repro.core as ref
import repro_torch.core as port


def _event(rng, n, p, *, dup_range=4, inf_frac=0.2, special=False):
    avg = rng.integers(0, dup_range, n).astype(np.float32)
    ex = rng.integers(1, 16, (n, p)).astype(np.float32)
    ex[rng.random(n) < inf_frac] = np.inf            # all-inf rows
    ex[rng.random((n, p)) < 0.1] = np.inf            # unsupported pairs
    avail = rng.integers(0, 8, p).astype(np.float32)
    if special:
        r = rng.random(n)
        avg[r < 0.15] = np.nan
        avg[(r >= 0.15) & (r < 0.3)] = -np.inf
        avg[(r >= 0.3) & (r < 0.4)] = -0.0
    return avg, ex, avail


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g, w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 40), p=st.integers(1, 8),
       dup_range=st.integers(1, 6), special=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_heft_rt_bitwise_equal_to_jax(n, p, dup_range, special, seed):
    rng = np.random.default_rng(seed)
    avg, ex, avail = _event(rng, n, p, dup_range=dup_range, special=special)
    valid = rng.random(n) < 0.8
    got = port.heft_rt(torch.from_numpy(avg), torch.from_numpy(ex),
                       torch.from_numpy(avail), torch.from_numpy(valid))
    want = ref.heft_rt(jnp.asarray(avg), jnp.asarray(ex),
                       jnp.asarray(avail), jnp.asarray(valid))
    _assert_bitwise(got, want)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 40), p=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1))
def test_heft_rt_equals_numpy_oracle(n, p, seed):
    rng = np.random.default_rng(seed)
    avg, ex, avail = _event(rng, n, p)
    got = port.heft_rt(torch.from_numpy(avg), torch.from_numpy(ex),
                       torch.from_numpy(avail))
    want = ref.heft_rt_numpy(avg, ex, avail)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.float64),
                                      np.asarray(w, dtype=np.float64))
    # the port's numpy twin is a copy of the reference's
    for g, w in zip(port.heft_rt_numpy(avg, ex, avail), want):
        np.testing.assert_array_equal(g, w)


def test_priority_order_nan_keys_last_like_jnp():
    keys = np.array([1, np.nan, 3, -np.inf, 3, np.nan, 0.0, -0.0],
                    dtype=np.float32)
    valid = np.ones(keys.shape, bool)
    got = port.priority_order(torch.from_numpy(keys), torch.from_numpy(valid))
    want = ref.priority_order(jnp.asarray(keys), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [2, 4, 0, 6, 7, 3, 1, 5]
    assert got.dtype == torch.int32


def test_all_inf_rows_invalid_slots_and_ties():
    avg = np.array([2, 2, 5, 1, 2], dtype=np.float32)
    ex = np.array([[3, 3, 3],
                   [np.inf, np.inf, np.inf],
                   [1, 1, 1],
                   [4, 2, 2],
                   [5, 5, 5]], dtype=np.float32)
    avail = np.zeros(3, np.float32)
    valid = np.array([True, True, True, True, False])
    got = port.heft_rt(*(torch.from_numpy(x) for x in (avg, ex, avail, valid)))
    want = ref.heft_rt(*(jnp.asarray(x) for x in (avg, ex, avail, valid)))
    _assert_bitwise(got, want)
    assert got.order.tolist() == [2, 0, 1, 3, 4]
    # EFT ties go to the lowest PE; the all-inf row and the invalid slot
    # are unschedulable
    assert got.assignment.tolist() == [0, 1, -1, 2, -1]
    assert np.isinf(got.start_time.numpy()[[2, 4]]).all()


@settings(max_examples=10, deadline=None)
@given(b=st.integers(1, 5), n=st.integers(1, 24), p=st.integers(1, 6),
       seed=st.integers(0, 2**31 - 1))
def test_heft_rt_batched_equals_jax_vmap(b, n, p, seed):
    rng = np.random.default_rng(seed)
    events = [_event(rng, n, p, special=True) for _ in range(b)]
    avg, ex, avail = (np.stack(c) for c in zip(*events))
    valid = rng.random((b, n)) < 0.9
    got = port.heft_rt_batched(*(torch.from_numpy(x)
                                 for x in (avg, ex, avail, valid)))
    want = ref.heft_rt_batched(*(jnp.asarray(x)
                                 for x in (avg, ex, avail, valid)))
    _assert_bitwise(got, want)
    with pytest.raises(ValueError):
        port.heft_rt_batched(torch.from_numpy(avg[0]), torch.from_numpy(ex),
                             torch.from_numpy(avail))


def test_eft_assign_equals_jax():
    rng = np.random.default_rng(5)
    ex = rng.integers(1, 9, (12, 5)).astype(np.float32)
    ex[3] = np.inf
    avail = rng.integers(0, 4, 5).astype(np.float32)
    valid = np.arange(12) < 10
    got = port.eft_assign(torch.from_numpy(ex), torch.from_numpy(avail),
                          torch.from_numpy(valid))
    want = ref.eft_assign(jnp.asarray(ex), jnp.asarray(avail),
                          jnp.asarray(valid))
    _assert_bitwise(got, want)


def test_copied_cycle_and_resource_models_equal_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 5, 64, 1330):
        assert port.worst_case_cycles(n) == ref.worst_case_cycles(n)
        assert port.first_decision_worst_case(n) == \
            ref.first_decision_worst_case(n)
        keys = rng.integers(0, 10, n)
        assert dataclasses.asdict(port.simulate_mapping_event(keys)) == \
            dataclasses.asdict(ref.simulate_mapping_event(keys))
        assert port.hw_latency_ns(n, 3.048) == ref.hw_latency_ns(n, 3.048)
    assert port.PAPER_CRITICAL_PATH_NS == ref.PAPER_CRITICAL_PATH_NS
    assert port.PAPER_PER_DECISION_NS == ref.PAPER_PER_DECISION_NS
    for P, D in ((4, 512), (8, 256), (16, 512)):
        d_port, d_ref = port.SchedulerDesign(P=P, D=D), ref.SchedulerDesign(P=P, D=D)
        assert port.total_luts(d_port) == ref.total_luts(d_ref)
        assert port.total_registers(d_port) == ref.total_registers(d_ref)
        assert port.critical_path_ns(d_port) == ref.critical_path_ns(d_ref)
        assert port.utilization(d_port) == ref.utilization(d_ref)

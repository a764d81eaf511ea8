"""repro_torch.obs against the JAX reference ``repro.obs``.

``accumulate_counters`` (PyTorch) and the reference's jnp version fold the
same seeded dispatch outputs, with padded batch rows and padded PE lanes;
the tolerance is bitwise (0): the inputs are small integers, exact in
float32.  The copied metrics / trace / log modules get one behavioural case
each against the reference.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hypothesis_compat import given, settings, st

import repro.obs as ref
import repro_torch.obs as port


@settings(max_examples=20, deadline=None)
@given(b=st.integers(1, 6), d=st.integers(1, 16), p=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1))
def test_accumulate_counters_equals_jax_with_padding(b, d, p, seed):
    rng = np.random.default_rng(seed)
    assignment = rng.integers(-1, p, (b, d)).astype(np.int32)
    new_avail = rng.integers(0, 64, (b, p)).astype(np.float32)
    valid = rng.random((b, d)) < 0.7
    valid[rng.random(b) < 0.3] = False          # padded batch rows
    p_valid = np.arange(p) < max(1, p - int(rng.integers(0, p)))  # padded lanes
    start = rng.integers(0, 9, 4).astype(np.float32)
    want = ref.accumulate_counters(jnp.asarray(start), jnp.asarray(assignment),
                                   jnp.asarray(new_avail), jnp.asarray(valid),
                                   jnp.asarray(p_valid))
    regs = torch.from_numpy(start.copy())
    got = port.accumulate_counters(regs, *(torch.from_numpy(x) for x in
                                           (assignment, new_avail, valid,
                                            p_valid)))
    assert got.data_ptr() == regs.data_ptr()     # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one event (1-D operands) takes the same path as a batch of one
    one = port.accumulate_counters(
        port.zero_counters("cpu"), *(torch.from_numpy(x) for x in
                                     (assignment[0], new_avail[0], valid[0],
                                      p_valid)))
    one_ref = ref.accumulate_counters(ref.zero_counters(),
                                      *(jnp.asarray(x) for x in
                                        (assignment[0], new_avail[0],
                                         valid[0], p_valid)))
    np.testing.assert_array_equal(one.numpy(), np.asarray(one_ref))


def test_host_counter_twin_and_dict_equal_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(-1, 4, (3, 7))
    na = rng.integers(0, 20, (3, 4)).astype(np.float64)
    valid = rng.random((3, 7)) < 0.8
    for args in ((a[0], na[0]), (a, na), (a, na, valid)):
        c_port, c_ref = np.zeros(4), np.zeros(4)
        port.accumulate_counters_np(c_port, *args)
        ref.accumulate_counters_np(c_ref, *args)
        np.testing.assert_array_equal(c_port, c_ref)
        assert port.counters_dict(c_port) == ref.counters_dict(c_ref)
    assert port.COUNTER_NAMES == ref.COUNTER_NAMES
    with pytest.raises(ValueError):
        port.counters_dict(np.zeros(3))


def test_histogram_percentiles_equal_reference():
    samples = [3e-9, 1e-6, 2.5e-6, 4e-3, 0.2, 1.0, 7.5]
    h_port, h_ref = port.Histogram(), ref.Histogram()
    for v in samples:
        h_port.record(v)
        h_ref.record(v)
    h_port.record(1e-5, n=3)
    h_ref.record(1e-5, n=3)
    assert h_port.count == h_ref.count == len(samples) + 3
    for q in (0.5, 0.9, 0.99):
        assert h_port.percentile(q) == h_ref.percentile(q)
    reg = port.MetricsRegistry()
    reg.counter("c", k="v").inc(2)
    reg.histogram("h").record(1e-3)
    snap = reg.snapshot()
    assert json.loads(json.dumps(snap)) == snap


def test_tracer_ring_and_chrome_export(tmp_path):
    tr = port.Tracer(capacity=4)
    for i in range(6):
        tr.instant(f"e{i}", i=i)
    names = [e.name for e in tr.events()]
    assert names == ["e2", "e3", "e4", "e5"]      # newest kept
    with tr.span("work", k=1):
        pass
    path = tmp_path / "t.json"
    tr.export(str(path), metrics=port.MetricsRegistry())
    obj = json.loads(path.read_text())
    assert port.validate_chrome_trace(obj, require_names=["work"]) == \
        ref.validate_chrome_trace(obj, require_names=["work"])
    assert obj["otherData"]["producer"] == "repro_torch.obs"


def test_log_levels(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_LOG", "warning")
    log = port.get_logger("port-test")
    log.info("hidden")
    log.warning("shown")
    out = capsys.readouterr().out
    assert "[port-test] shown" in out and "hidden" not in out
    assert port.log_level() == ref.log_level()
    monkeypatch.setenv("REPRO_LOG", "nope")
    with pytest.raises(ValueError):
        port.log_level()

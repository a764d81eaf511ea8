"""repro_torch.kernels against the JAX reference ``repro.kernels``.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX wrappers run the Pallas kernels in interpret mode (``interpret=True``,
as ``tests/test_kernels.py`` does).  The same seeded numpy inputs, exact in
float32, go through both; the tolerance is bitwise (0).  The CUDA kernels
themselves are held against the same plain versions on the card by
``test_kernels_on_card_match_plain_versions`` (marked ``cuda``, skipped
without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hypothesis_compat import given, settings, st

import repro.kernels as jk
from repro.core import heft_rt as ref_heft_rt
from repro.core import heft_rt_numpy
import repro.kernels.ref as jref
from repro.kernels.fused_decision import pack_tick_outputs as j_pack

import repro_torch.kernels as K
from repro_torch.core import ScheduleResult, heft_rt
from repro_torch.kernels import fused_decision as fd
from repro_torch.kernels import heft_fused as hf
from repro_torch.kernels import ref as pref


def _event(rng, n, p, inf_frac=0.2):
    avg = rng.integers(0, 5, n).astype(np.float32)
    ex = rng.integers(1, 16, (n, p)).astype(np.float32)
    ex[rng.random(n) < inf_frac] = np.inf
    avail = rng.integers(0, 8, p).astype(np.float32)
    return avg, ex, avail


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.dtype == np.float32:
            assert w.dtype == np.float32
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@settings(max_examples=8, deadline=None)
@given(n=st.integers(1, 40), p=st.integers(1, 12),
       seed=st.integers(0, 2**31 - 1))
def test_heft_rt_hw_equals_jax_interpret(n, p, seed):
    rng = np.random.default_rng(seed)
    avg, ex, avail = _event(rng, n, p)
    got = K.heft_rt_hw(*_t(avg, ex, avail))
    want = jk.heft_rt_hw(avg, ex, avail, interpret=True)
    _assert_bitwise(got, want)
    _assert_bitwise(got, heft_rt(*_t(avg, ex, avail)))


@settings(max_examples=8, deadline=None)
@given(n=st.integers(1, 40), p=st.integers(1, 12),
       seed=st.integers(0, 2**31 - 1))
def test_decision_hw_equals_jax_interpret_and_decision_ref(n, p, seed):
    rng = np.random.default_rng(seed)
    avg, ex, avail = _event(rng, n, p)
    mask = rng.random(p) < 0.3
    got = K.decision_hw(*_t(avg, ex, avail, mask))
    want = jk.decision_hw(avg, ex, avail, mask, interpret=True)
    _assert_bitwise(got, want)
    valid = np.ones(n, bool)
    j_ref = jk.decision_ref(*(jnp.asarray(x) for x in (avg, ex, avail, valid,
                                                        mask)))
    p_ref = K.decision_ref(*_t(avg, ex, avail, valid, mask))
    _assert_bitwise(p_ref, j_ref)
    _assert_bitwise(got, p_ref)
    # masked = the numpy oracle on the masked matrix
    exm = ex.copy()
    exm[:, mask] = np.inf
    for g, w in zip(got, jk.decision_ref(jnp.asarray(avg), jnp.asarray(exm),
                                         jnp.asarray(avail), jnp.asarray(valid),
                                         jnp.zeros(p, bool))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_all_false_mask_equals_unmasked_kernel():
    rng = np.random.default_rng(11)
    avg, ex, avail = _event(rng, 33, 7, inf_frac=0.3)
    plain = K.heft_rt_hw(*_t(avg, ex, avail))
    masked = K.decision_hw(*_t(avg, ex, avail, np.zeros(7, bool)))
    _assert_bitwise(masked, plain)


def test_subnormal_registers_and_exec_times():
    """IEEE f32 adds with subnormals, no flush to zero: the port equals the
    float64 ``heft_rt_numpy`` oracle (sums of multiples of 2**-149 are exact
    in both).  The JAX reference on XLA:CPU flushes subnormal sums to zero
    (``heft_rt`` and the interpreted kernel alike), so it is not the oracle
    here; the card's kernel is built without FTZ and held to the same plain
    version by ``chip_smoke.py``."""
    rng = np.random.default_rng(2)
    tiny = np.float32(1e-45)
    avg, ex, avail = _event(rng, 20, 5)
    ex = np.where(np.isfinite(ex), ex * tiny, ex).astype(np.float32)
    avail = (avail * tiny).astype(np.float32)
    assert (avail[avail > 0] < np.finfo(np.float32).tiny).all()
    got = K.heft_rt_hw(*_t(avg, ex, avail))
    for g, w in zip(got, heft_rt_numpy(avg, ex, avail)):
        np.testing.assert_array_equal(g.numpy().astype(np.float64),
                                      np.asarray(w, dtype=np.float64))
    assert (got.new_avail.numpy() > 0).all()   # nothing flushed
    masked = K.decision_hw(*_t(avg, ex, avail, np.zeros(5, bool)))
    _assert_bitwise(masked, got)


def test_pack_unpack_roundtrip_bit_exact_against_jax_packing():
    rng = np.random.default_rng(0)
    n, p = 6, 4
    avg, ex, avail = _event(rng, n, p, inf_frac=0.5)     # plenty of ±inf
    avail = rng.random(p).astype(np.float32)
    avail[1] = -np.inf
    valid, mask = np.ones(n, bool), np.zeros(p, bool)
    toks = rng.integers(0, 64, (3, 1)).astype(np.int32)
    res = K.decision_ref(*_t(avg, ex, avail, valid, mask))
    buf = K.pack_tick_outputs(torch.from_numpy(toks), res).numpy()
    j_res = jk.decision_ref(*(jnp.asarray(x) for x in (avg, ex, avail, valid,
                                                        mask)))
    j_buf = np.asarray(j_pack(jnp.asarray(toks), j_res))
    assert buf.dtype == np.int32
    np.testing.assert_array_equal(buf, j_buf)
    np.testing.assert_array_equal(buf[:3], toks.ravel())
    unpacked = K.unpack_decision(buf[3:], p)
    _assert_bitwise(unpacked, res)
    assert np.isinf(unpacked[2]).any() and np.isneginf(unpacked[4][1])


@settings(max_examples=6, deadline=None)
@given(n=st.integers(1, 33), p=st.integers(1, 9),
       seed=st.integers(0, 2**31 - 1))
def test_plain_ref_twins_equal_jax_refs(n, p, seed):
    rng = np.random.default_rng(seed)
    avg, ex, avail = _event(rng, n, p)
    qids = np.arange(n, dtype=np.int32)
    _assert_bitwise(pref.oddeven_sort_ref(*_t(avg, qids)),
                    jref.oddeven_sort_ref(jnp.asarray(avg), jnp.asarray(qids)))
    _assert_bitwise(pref.eft_select_ref(*_t(ex, avail)),
                    jref.eft_select_ref(jnp.asarray(ex), jnp.asarray(avail)))
    _assert_bitwise(pref.heft_fused_ref(*_t(avg, ex, avail)),
                    jref.heft_fused_ref(jnp.asarray(avg), jnp.asarray(ex),
                                        jnp.asarray(avail)))
    m = n + (n % 2)                          # the brick-wall sim wants even D
    keys = np.concatenate([avg, np.full(m - n, -np.inf, np.float32)])
    payload = np.arange(m, dtype=np.int32)
    _assert_bitwise(pref.oddeven_sort_sim(*_t(keys, payload)),
                    jref.oddeven_sort_sim(jnp.asarray(keys),
                                          jnp.asarray(payload)))


def test_batched_wrappers_equal_per_event_calls():
    rng = np.random.default_rng(4)
    B, n, p = 5, 17, 6
    events = [_event(rng, n, p) for _ in range(B)]
    avg, ex, avail = (np.stack(c) for c in zip(*events))
    mask = np.array([False, True, False, False, True, False])
    batched = K.heft_rt_hw(*_t(avg, ex, avail))
    batched_d = K.decision_hw(*_t(avg, ex, avail, mask))
    for i in range(B):
        one = K.heft_rt_hw(*_t(avg[i], ex[i], avail[i]))
        _assert_bitwise([t[i] for t in batched], one)
        one_d = K.decision_hw(*_t(avg[i], ex[i], avail[i], mask))
        _assert_bitwise([t[i] for t in batched_d], one_d)


def test_out_avail_receives_registers_in_place():
    rng = np.random.default_rng(8)
    avg, ex, avail = _event(rng, 12, 4)
    regs = torch.from_numpy(avail.copy())
    res = K.heft_rt_hw(*_t(avg, ex), regs, out_avail=regs)
    assert res.new_avail.data_ptr() == regs.data_ptr()
    want = jk.heft_rt_hw(avg, ex, avail, interpret=True)
    np.testing.assert_array_equal(regs.numpy(), np.asarray(want[4]))


def test_wrapper_checks_and_cpu_path_launches_nothing():
    K.reset_launch_counts()
    keys = torch.zeros(2, 8)
    ex = torch.ones(2, 8, 3)
    av = torch.zeros(2, 3)
    mask = torch.zeros(3, dtype=torch.bool)
    with pytest.raises(TypeError):
        hf.heft_fused(keys.double(), ex, av)
    with pytest.raises(ValueError):
        hf.heft_fused(keys, ex[:, :, :2], av)
    with pytest.raises(ValueError):
        hf.heft_fused(keys, ex.transpose(1, 2).contiguous().transpose(1, 2), av)
    with pytest.raises(ValueError):
        fd.fused_decision(keys, ex, av, mask[:2])
    res = fd.fused_decision(keys, ex, av, mask)
    assert isinstance(res, ScheduleResult)
    assert K.launch_counts() == {"heft_fused": 0, "fused_decision": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_on_card_match_plain_versions(card):
    rng = np.random.default_rng(0)
    for B, D, P in ((8, 5, 4), (8, 1330, 40), (2, 8192, 4)):
        keys = rng.integers(0, 50, (B, D)).astype(np.float32)
        ex = rng.integers(1, 64, (B, D, P)).astype(np.float32)
        ex[rng.random((B, D)) < 0.05] = np.inf
        av = rng.integers(0, 16, (B, P)).astype(np.float32)
        mask = rng.random(P) < 0.3
        cpu = _t(keys, ex, av)
        dev = [t.to(card) for t in cpu]
        before = dict(K.launch_counts())
        got = hf.heft_fused(*dev)
        got_d = fd.fused_decision(*dev, torch.from_numpy(mask).to(card))
        torch.cuda.synchronize()
        assert K.launch_counts()["heft_fused"] == before["heft_fused"] + 1
        _assert_bitwise([t.cpu() for t in got],
                        pref.heft_fused_ref(*cpu))
        _assert_bitwise([t.cpu() for t in got_d],
                        fd.decision_ref(*cpu, None, torch.from_numpy(mask)))


def test_nan_keys_and_neg_inf_registers_follow_the_software_reference():
    """Where the reference Pallas kernel and ``repro.core.heft_rt`` disagree
    (NaN keys stall its strict-compare transposition sort; a -inf register
    passes its ``fmin < inf`` guard), the port's kernels follow heft_rt:
    NaN keys sort last, and a non-finite finish is unschedulable."""
    avg = np.array([1, np.nan, 3, 2, np.nan, 0], np.float32)
    ex = np.arange(12, dtype=np.float32).reshape(6, 2) + 1
    av = np.zeros(2, np.float32)
    want = ref_heft_rt(jnp.asarray(avg), jnp.asarray(ex), jnp.asarray(av))
    _assert_bitwise(K.heft_rt_hw(*_t(avg, ex, av)), want)
    assert K.heft_rt_hw(*_t(avg, ex, av)).order.tolist() == [2, 3, 0, 5, 1, 4]
    avg, ex = np.array([1, 2], np.float32), np.array([[1, 2], [3, 4]], np.float32)
    av = np.array([-np.inf, 0], np.float32)
    want = ref_heft_rt(jnp.asarray(avg), jnp.asarray(ex), jnp.asarray(av))
    for got in (K.heft_rt_hw(*_t(avg, ex, av)),
                K.decision_hw(*_t(avg, ex, av, np.zeros(2, bool)))):
        _assert_bitwise(got, want)
        assert got.assignment.tolist() == [-1, -1]

"""repro_torch.kernels against the JAX reference ``repro.kernels``.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX wrappers run the Pallas kernels in interpret mode (``interpret=True``,
as ``tests/test_kernels.py`` does).  The same seeded numpy inputs, exact in
float32, go through both; the tolerance is bitwise (0).  The CUDA kernels
themselves are held against the same plain versions on the card by
``test_kernels_on_card_match_plain_versions`` and
``test_queue_kernels_on_card_match_plain_versions`` (marked ``cuda``,
skipped without a card) and by ``chip_smoke.py``.

Where the reference's standalone kernels disagree with its own oracles, a
named test pins what the port does (the reference's faults are in
``ROADMAP.md``, queue 3):

* the sort wrapper pads with ``finfo.min``, which sorts ahead of a real
  ``-inf`` and comes back in the output —
  ``test_sort_neg_inf_nan_and_signed_zero_keys_follow_the_oracle``;
* ``oddeven_sort_ref`` compares int32 keys in float32, so keys above 2**24
  tie; the port (and the Pallas kernel) compares exactly —
  ``test_sort_int32_keys_above_2_24_keep_the_exact_integer_order``;
* NaN keys stall the strict-compare transposition — the same test as the
  first row;
* a ``-inf`` register passes ``eft_select``'s ``fmin < inf`` guard —
  ``test_eft_select_neg_inf_and_subnormal_registers_follow_numpy_oracle``.
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
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

KERNEL_NAMES = ("heft_fused", "fused_decision", "oddeven_sort", "eft_select")


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
    with pytest.raises(TypeError):
        K.oddeven_sort(torch.zeros(3, dtype=torch.bool), torch.zeros(3))
    with pytest.raises(TypeError):
        ops._sort.sort_rows(torch.zeros(1, 3, dtype=torch.float64),
                            torch.zeros(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.oddeven_sort(torch.zeros(3), torch.zeros(4))
    with pytest.raises(ValueError):
        K.eft_select(ex, av[:, :2])
    with pytest.raises(ValueError):
        K.eft_select(ex, av, out_avail=torch.zeros(2, 2))
    with pytest.raises(ValueError):
        ops._eft.eft_rows(ex, av, out_avail=torch.zeros(3, 2).t())
    # An empty queue launches nothing and returns empty tensors.
    ks, ps = K.oddeven_sort(torch.zeros(2, 0), torch.zeros(2, 0))
    assert ks.shape == ps.shape == (2, 0) and ps.dtype == torch.int32
    a, st, fi, na = K.eft_select(torch.zeros(0, 3), torch.ones(3))
    assert a.shape == (0,) and torch.equal(na, torch.ones(3))
    assert K.launch_counts() == dict.fromkeys(KERNEL_NAMES, 0)


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


# ---------------------------------------------------------------------------
# the priority queue and the EFT selector as standalone kernels
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 300), dup_range=st.integers(2, 50),
       seed=st.integers(0, 2**31 - 1))
def test_oddeven_sort_f32_heavy_ties_equals_jax_interpret(n, dup_range, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, dup_range, n).astype(np.float32)
    payload = rng.integers(-1000, 1000, n).astype(np.int32)
    got = K.oddeven_sort(*_t(keys, payload))
    _assert_bitwise(got, jk.oddeven_sort(keys, payload, interpret=True))
    _assert_bitwise(got, jref.oddeven_sort_ref(jnp.asarray(keys),
                                               jnp.asarray(payload)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32"])
def test_oddeven_sort_dtypes_equal_jax_interpret(dtype):
    rng = np.random.default_rng(0)
    if dtype == "int32":
        keys = rng.integers(-1000, 1000, 257).astype(np.int32)
    else:
        keys = rng.normal(0, 100, 257).astype(np.float32)
    payload = np.arange(257, dtype=np.int32)
    j_keys = jnp.asarray(keys, dtype=dtype)
    got_k, got_p = K.oddeven_sort(
        torch.from_numpy(np.array(j_keys.astype(jnp.float32)))
        .to(getattr(torch, dtype)), torch.from_numpy(payload))
    want_k, want_p = jk.oddeven_sort(j_keys, jnp.asarray(payload),
                                     interpret=True)
    assert got_k.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_k.float().numpy(),
                                  np.asarray(want_k.astype(jnp.float32)))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert len(np.unique(np.asarray(want_k.astype(jnp.float32)))) < 257 \
        or dtype == "int32"                       # 16-bit keys do tie


def test_sort_int32_keys_above_2_24_keep_the_exact_integer_order():
    """The Pallas kernel and the port compare int32 keys exactly;
    ``oddeven_sort_ref`` casts them to float32, where 2**24 and 2**24 + 1
    tie and keep slot order."""
    keys = np.array([2**24, 2**24 + 1, 5], np.int32)
    payload = np.arange(3, dtype=np.int32)
    got = K.oddeven_sort(*_t(keys, payload))
    _assert_bitwise(got, jk.oddeven_sort(keys, payload, interpret=True))
    assert got[1].tolist() == [1, 0, 2]
    oracle = jref.oddeven_sort_ref(jnp.asarray(keys), jnp.asarray(payload))
    assert np.asarray(oracle[1]).tolist() == [0, 1, 2]
    rng = np.random.default_rng(3)                # a dense band around 2**24
    keys = rng.integers(2**24 - 40, 2**24 + 40, 300).astype(np.int32)
    payload = np.arange(300, dtype=np.int32)
    got = K.oddeven_sort(*_t(keys, payload))
    _assert_bitwise(got, jk.oddeven_sort(keys, payload, interpret=True))
    want = np.lexsort((payload, -keys.astype(np.int64)))
    np.testing.assert_array_equal(got[1].numpy(), want)


def test_sort_neg_inf_nan_and_signed_zero_keys_follow_the_oracle():
    """Padding sorts after every real slot, -inf and NaN included (the
    Pallas wrapper's finfo.min padding sorts ahead of -inf and is returned);
    NaN keys sort last (the strict-compare transposition never moves them);
    -0.0 ties with +0.0 and comes back as -0.0."""
    keys = np.array([-np.inf, 1, -np.inf, 2], np.float32)
    payload = np.arange(4, dtype=np.int32)
    got = K.oddeven_sort(*_t(keys, payload))
    want = jref.oddeven_sort_ref(jnp.asarray(keys), jnp.asarray(payload))
    _assert_bitwise(got, want)
    assert got[1].tolist() == [3, 1, 0, 2]
    pallas = jk.oddeven_sort(keys, payload, interpret=True)
    assert np.asarray(pallas[1]).tolist() == [3, 1, -1, -1]
    keys = np.array([1, np.nan, 3, 2], np.float32)
    got = K.oddeven_sort(*_t(keys, payload))
    _assert_bitwise(got, jref.oddeven_sort_ref(jnp.asarray(keys),
                                               jnp.asarray(payload)))
    assert got[1].tolist() == [2, 3, 0, 1]
    rng = np.random.default_rng(5)
    keys = rng.integers(-3, 4, 200).astype(np.float32)
    r = rng.random(200)
    keys[r < 0.1] = np.nan
    keys[(r >= 0.1) & (r < 0.2)] = -np.inf
    keys[(r >= 0.2) & (r < 0.3)] = np.inf
    keys[(r >= 0.3) & (r < 0.45)] = -0.0
    payload = np.arange(200, dtype=np.int32)
    want = jref.oddeven_sort_ref(jnp.asarray(keys), jnp.asarray(payload))
    _assert_bitwise(K.oddeven_sort(*_t(keys, payload)), want)
    order = torch.from_numpy(np.asarray(want[1]).astype(np.int64))
    for dt in (torch.bfloat16, torch.float16):
        k = torch.from_numpy(keys).to(dt)
        got = K.oddeven_sort(k, torch.from_numpy(payload))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        # keys gathered from the input bit for bit: -0.0 and NaN as given
        assert torch.equal(got[0].view(torch.int16), k[order].view(torch.int16))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 128), p=st.integers(1, 40),
       inf_frac=st.floats(0.0, 0.4), seed=st.integers(0, 2**31 - 1))
def test_eft_select_equals_jax_interpret(n, p, inf_frac, seed):
    """Bitwise, on the integer grid (ties to the lowest PE) for odd seeds
    and on uniform floats for even ones, with +inf pairs and all-+inf
    rows."""
    rng = np.random.default_rng(seed)
    ex = (rng.integers(1, 16, (n, p)) if seed % 2
          else rng.uniform(1, 100, (n, p))).astype(np.float32)
    ex[rng.random((n, p)) < inf_frac] = np.inf
    ex[rng.random(n) < 0.1] = np.inf
    avail = rng.integers(0, 8, p).astype(np.float32)
    got = K.eft_select(*_t(ex, avail))
    _assert_bitwise(got, jk.eft_select(ex, avail, interpret=True))
    _assert_bitwise(got, jref.eft_select_ref(jnp.asarray(ex),
                                             jnp.asarray(avail)))


def test_eft_tie_breaks_to_lowest_pe_and_all_inf_rows_are_unassigned():
    ex = np.array([[5, 5, 5], [np.inf] * 3, [2, 1, 1]], np.float32)
    got = K.eft_select(*_t(ex, np.zeros(3, np.float32)))
    _assert_bitwise(got, jk.eft_select(ex, np.zeros(3, np.float32),
                                       interpret=True))
    assert got[0].tolist() == [0, -1, 1]
    assert np.isinf(got[1][1].item()) and np.isinf(got[2][1].item())


def test_eft_select_neg_inf_and_subnormal_registers_follow_numpy_oracle():
    """A -inf register gives a -inf finish, which the port's isfinite guard
    rejects (-1, +inf), as heft_rt_numpy does; the Pallas kernel's
    ``fmin < inf`` guard assigns it.  Subnormal registers and exec times add
    without a flush to zero (XLA:CPU flushes, so numpy is the oracle)."""
    ex = np.array([[1, 2], [3, 1]], np.float32)
    av = np.array([-np.inf, 0], np.float32)
    got = K.eft_select(*_t(ex, av))
    keys = -np.arange(2, dtype=np.float32)          # identity priority order
    _, a, st_, fi, na = heft_rt_numpy(keys, ex, av)
    assert got[0].tolist() == a.tolist() == [-1, -1]
    np.testing.assert_array_equal(got[1].numpy(), st_)
    np.testing.assert_array_equal(got[2].numpy(), fi)
    np.testing.assert_array_equal(got[3].numpy(), na)
    pallas = jk.eft_select(ex, av, interpret=True)
    assert np.asarray(pallas[0]).tolist() == [0, 0]
    rng = np.random.default_rng(6)
    tiny = np.float32(1e-45)
    ex = rng.integers(1, 16, (30, 5)).astype(np.float32)
    ex[rng.random(30) < 0.2] = np.inf
    ex = np.where(np.isfinite(ex), ex * tiny, ex).astype(np.float32)
    av = (rng.integers(0, 8, 5) * tiny).astype(np.float32)
    got = K.eft_select(*_t(ex, av))
    want = heft_rt_numpy(-np.arange(30, dtype=np.float32), ex, av)[1:]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.float64),
                                      np.asarray(w, dtype=np.float64))
    assert (got[3].numpy() > 0).all()                # nothing flushed


@settings(max_examples=10, deadline=None)
@given(b=st.integers(1, 4), n=st.integers(1, 40), p=st.integers(1, 12),
       seed=st.integers(0, 2**31 - 1))
def test_sort_gather_select_composes_to_heft_rt_hw(b, n, p, seed):
    """oddeven_sort -> gather the exec rows -> eft_select is the fused
    event, bitwise, batched over leading dims (the composition of
    ``ref.heft_fused_ref``); the registers land in place."""
    rng = np.random.default_rng(seed)
    avg, ex, avail = (np.stack(c) for c in zip(*(_event(rng, n, p)
                                                 for _ in range(b))))
    avg[rng.random((b, n)) < 0.1] = np.nan
    keys, exec_t, av = _t(avg, ex, avail)
    qids = torch.arange(n, dtype=torch.int32).expand(b, n)
    _, order = K.oddeven_sort(keys, qids)
    exec_sorted = torch.gather(
        exec_t, 1, order.long()[..., None].expand(b, n, p))
    regs = av.clone()
    got = K.eft_select(exec_sorted, av, out_avail=regs)
    assert got[3] is regs
    want = K.heft_rt_hw(keys, exec_t, av)
    _assert_bitwise([order, *got], want)
    for i in range(b):
        _assert_bitwise([order[i], *(t[i] for t in got)],
                        heft_rt(*_t(avg[i], ex[i], avail[i])))


@pytest.mark.cuda
def test_queue_kernels_on_card_match_plain_versions(card):
    rng = np.random.default_rng(1)
    before = dict(K.launch_counts())
    for B, D in ((8, 5), (8, 1330), (2, 8192)):
        keys = rng.integers(0, 50, (B, D)).astype(np.float32)
        keys[rng.random((B, D)) < 0.05] = np.nan
        ikeys = rng.integers(2**24 - 9, 2**24 + 9, (B, D)).astype(np.int32)
        payload = rng.integers(-9, 9, (B, D)).astype(np.int32)
        for k in (torch.from_numpy(keys), torch.from_numpy(keys).bfloat16(),
                  torch.from_numpy(ikeys)):
            p = torch.from_numpy(payload)
            got = K.oddeven_sort(k.to(card), p.to(card))
            want = ops._sort.sort_plain(k, p)
            assert torch.equal(got[0].cpu().view(torch.int16 if
                                                 k.element_size() == 2 else
                                                 torch.int32),
                               want[0].view(torch.int16 if
                                            k.element_size() == 2 else
                                            torch.int32))
            assert torch.equal(got[1].cpu(), want[1])
        for P in (4, 40, 1024):
            ex = rng.integers(1, 64, (B, D, P)).astype(np.float32)
            ex[rng.random((B, D)) < 0.05] = np.inf
            av = rng.integers(0, 16, (B, P)).astype(np.float32)
            got = K.eft_select(*(t.to(card) for t in _t(ex, av)))
            _assert_bitwise([t.cpu() for t in got],
                            pref.eft_select_ref(*_t(ex, av)))
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["oddeven_sort"] == before["oddeven_sort"] + 9
    assert after["eft_select"] == before["eft_select"] + 9

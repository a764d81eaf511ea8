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

KERNEL_NAMES = ("heft_fused", "fused_decision", "oddeven_sort", "eft_select",
                "paged_decode_attention")


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


def _key_bits(t):
    """Sort keys as integers of their width, for bitwise comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


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
    """The standalone sort (one warp, shared memory, chunks and scratch
    passes above 4096 slots; f32, bf16, f16 and i32 keys) and the
    standalone drain (no-op rows, -inf registers, the ring at D = 65536 and
    at P = 1024, registers in place) on the card, bitwise against their
    plain versions."""
    rng = np.random.default_rng(1)
    before = dict(K.launch_counts())
    sorts = drains = 0
    for B, D in ((8, 2), (8, 5), (8, 8), (8, 1330), (2, 4097), (2, 8192),
                 (1, 65536)):
        keys = rng.integers(0, 50, (B, D)).astype(np.float32)
        keys[rng.random((B, D)) < 0.05] = np.nan
        ikeys = rng.integers(2**24 - 9, 2**24 + 9, (B, D)).astype(np.int32)
        payload = rng.integers(-9, 9, (B, D)).astype(np.int32)
        f32 = torch.from_numpy(keys)
        for k in (f32, f32.bfloat16(), f32.half(), torch.from_numpy(ikeys)):
            p = torch.from_numpy(payload)
            got = K.oddeven_sort(k.to(card), p.to(card))
            want = ops._sort.sort_plain(k, p)
            assert torch.equal(_key_bits(got[0].cpu()), _key_bits(want[0]))
            assert torch.equal(got[1].cpu(), want[1])
            sorts += 1
        for P in ((4, 40, 1024) if D <= 8192 else (4,)):
            for kind in ("ints", "noop", "neg_inf"):
                ex = rng.integers(1, 64, (B, D, P)).astype(np.float32)
                ex[rng.random((B, D)) < 0.05] = np.inf
                av = rng.integers(0, 16, (B, P)).astype(np.float32)
                if kind == "noop":
                    ex[:] = np.inf
                elif kind == "neg_inf":
                    av[rng.random((B, P)) < 0.3] = -np.inf
                regs = torch.from_numpy(av).to(card)
                got = K.eft_select(torch.from_numpy(ex).to(card), regs,
                                   out_avail=regs)
                assert got[3] is regs
                _assert_bitwise([t.cpu() for t in got],
                                pref.eft_select_ref(*_t(ex, av)))
                drains += 1
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["oddeven_sort"] == before["oddeven_sort"] + sorts
    assert after["eft_select"] == before["eft_select"] + drains


# ---------------------------------------------------------------------------
# the staged drain of the event kernels: its executable spec
# ---------------------------------------------------------------------------

def _sim_event(kind):
    """(avg, exec, avail, mask, tile, special) of one named spec case;
    ``special`` marks inputs the Pallas kernels do not follow (-inf keys,
    non-finite registers, subnormals), held to ``heft_rt_numpy`` instead."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    D, P, tile, special = 40, 4, None, False
    if kind.startswith("wide"):
        P = 13 if kind == "wide_p13" else 40
    elif kind == "p1":
        P = 1
    elif kind == "mask_only_noops":
        P = 5
    avg, ex, avail = _event(rng, D, P, inf_frac=0.15)
    mask = rng.random(P) < 0.4
    mask[rng.integers(P)] = True
    if kind == "inf_rows_mid_and_trailing":
        avg[-8:] = -np.inf                          # padding: drains last
        ex[-8:] = np.inf
        ex[[3, 11, 12]] = np.inf
        special = True
    elif kind == "mask_only_noops":
        rows = rng.random(D) < 0.3
        ex[rows[:, None] & ~mask] = np.inf          # live only on masked lanes
    elif kind in ("neg_inf_and_nan_registers", "wide_p13"):
        avail[0] = -np.inf
        avail[-1] = np.nan
        special = True
    elif kind == "subnormal_exec":
        tiny = np.float32(1e-45)
        ex = np.where(np.isfinite(ex), ex * tiny, ex).astype(np.float32)
        avail = (avail * tiny).astype(np.float32)
        special = True
    elif kind == "tile_divides":
        tile = 8
    elif kind in ("tile_does_not_divide", "wide_ring"):
        tile = 7
    elif kind == "all_noop_event":
        ex[:] = np.inf
    return avg, ex, avail, mask, tile, special


SIM_CASES = ("inf_rows_mid_and_trailing", "mask_only_noops",
             "neg_inf_and_nan_registers", "subnormal_exec", "tile_divides",
             "tile_does_not_divide", "all_noop_event", "wide_ring",
             "wide_p13", "p1")


@pytest.mark.parametrize("kind", SIM_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_heft_event_sim_equals_plain_versions_and_jax_reference(kind, masked):
    """The step-by-step mirror of the staged drain (no-op flags, the prefix
    sum, the tile ring, the step of each width) is bitwise the plain
    versions and the JAX reference: the Pallas kernels in interpret mode,
    or ``heft_rt_numpy`` (float64, exact here) where they part from the
    software scheduler or XLA:CPU flushes subnormals."""
    avg, ex, avail, mask, tile, special = _sim_event(kind)
    pe_mask = torch.from_numpy(mask) if masked else None
    got = pref.heft_event_sim(*_t(avg, ex, avail), pe_mask, tile=tile)
    if masked:
        _assert_bitwise(got, fd.decision_ref(*_t(avg, ex, avail), None,
                                             pe_mask))
    else:
        _assert_bitwise(got, pref.heft_fused_ref(*_t(avg, ex, avail)))
    exm = ex.copy()
    if masked:
        exm[:, mask] = np.inf
    for g, w in zip(got, heft_rt_numpy(avg, exm, avail)):
        np.testing.assert_array_equal(g.numpy().astype(np.float64),
                                      np.asarray(w, dtype=np.float64))
    if not special:
        want = (jk.decision_hw(avg, ex, avail, mask, interpret=True)
                if masked else jk.heft_rt_hw(avg, ex, avail, interpret=True))
        _assert_bitwise(got, want)
    if kind == "all_noop_event" or (masked and kind == "mask_only_noops"):
        live = ~np.isinf(exm).all(axis=1)
        assert (got[1].numpy()[~live[got[0].numpy()]] == -1).all()


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 60), p=st.integers(1, 70), tile=st.integers(1, 64),
       seed=st.integers(0, 2**31 - 1))
def test_heft_event_sim_any_tile_equals_plain_versions(n, p, tile, seed):
    rng = np.random.default_rng(seed)
    avg, ex, avail = _event(rng, n, p, inf_frac=0.3)
    ex[rng.random((n, p)) < 0.2] = np.inf
    mask = rng.random(p) < 0.3
    args = _t(avg, ex, avail)
    _assert_bitwise(pref.heft_event_sim(*args, tile=tile),
                    pref.heft_fused_ref(*args))
    _assert_bitwise(pref.heft_event_sim(*args, torch.from_numpy(mask),
                                        tile=tile),
                    fd.decision_ref(*args, None, torch.from_numpy(mask)))


@pytest.mark.cuda
def test_staged_drain_paths_on_card_match_plain_versions(card):
    """The event kernels' staged drain on the card: the ring of row tiles
    (long queues, large P), no-op rows (all-inf, padding, masked off) beside
    a -inf register, bitwise against the plain versions."""
    rng = np.random.default_rng(3)
    for B, D, P in ((2, 300, 1024), (2, 1330, 200), (1, 8192, 4), (4, 256, 4)):
        keys = rng.integers(0, 50, (B, D)).astype(np.float32)
        ex = rng.integers(1, 64, (B, D, P)).astype(np.float32)
        ex[rng.random((B, D)) < 0.3] = np.inf
        keys[:, -D // 4:] = -np.inf                   # the fabric's padding
        ex[:, -D // 4:] = np.inf
        av = rng.integers(0, 16, (B, P)).astype(np.float32)
        av[:, 0] = -np.inf
        mask = torch.from_numpy(rng.random(P) < 0.3)
        cpu = _t(keys, ex, av)
        dev = [t.to(card) for t in cpu]
        got = hf.heft_fused(*dev)
        got_d = fd.fused_decision(*dev, mask.to(card))
        torch.cuda.synchronize()
        _assert_bitwise([t.cpu() for t in got], pref.heft_fused_ref(*cpu))
        _assert_bitwise([t.cpu() for t in got_d],
                        fd.decision_ref(*cpu, None, mask))


# ---------------------------------------------------------------------------
# the sort's and the standalone drain's executable specs
# ---------------------------------------------------------------------------

SIM_SORT_D = (1, 2, 5, 8, 33, 64, 65, 256, 1330, 2048, 4097, 8192)
SIM_THREADS = (32, 64, 128, 256, 512, 1024)   # every count a launcher uses


def _sort_case(D, dtype, seed):
    """Keys with heavy ties and every special value of the type: NaN, +-inf
    and +-0.0 for floats (small integers, exact in 16 bits); for int32 a
    band above 2**24 (apart in int32, tied in float32) and the extremes."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        k = rng.integers(-40, 40, D).astype(np.int32)
        k[rng.random(D) < 0.4] += 2**24
        k[rng.random(D) < 0.02] = np.iinfo(np.int32).min
        k[rng.random(D) < 0.02] = np.iinfo(np.int32).max
    else:
        k = rng.integers(-6, 6, D).astype(np.float32)
        r = rng.random(D)
        k[r < 0.05] = np.nan
        k[(r >= 0.05) & (r < 0.1)] = -np.inf
        k[(r >= 0.1) & (r < 0.14)] = np.inf
        k[(r >= 0.14) & (r < 0.2)] = -0.0
        k[(r >= 0.2) & (r < 0.25)] = 0.0
    payload = rng.integers(-2**31, 2**31 - 1, D).astype(np.int32)
    return k, payload


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32"])
@pytest.mark.parametrize("D", SIM_SORT_D)
def test_bitonic_sort_sim_equals_plain_versions_and_jax_reference(D, dtype):
    """The mirror of ``sort_queue``'s schedule (keys in registers, shuffles,
    the swizzled shared buffer, chunks and scratch passes above 4096 slots,
    one warp for small queues) at every thread count a launcher gives it is
    bitwise the plain sort, the JAX oracle and the Pallas kernel in
    interpret mode (on keys without NaN and -inf, which the Pallas wrapper
    mishandles: ROADMAP queue 3)."""
    k, payload = _sort_case(D, dtype, seed=D)
    keys = torch.from_numpy(k).to(getattr(torch, dtype))
    p = torch.from_numpy(payload)
    want_k, want_p = ops._sort.sort_plain(keys[None], p[None])
    N = max(2, 1 << (D - 1).bit_length())
    ran = 0
    for threads in SIM_THREADS:
        if threads < min(N, pref.SORT_CHUNK) // pref.sort_grain(N, threads):
            continue                       # fewer than 8 keys a thread
        got_k, got_p, _ = pref.bitonic_sort_sim(keys, p, threads)
        assert torch.equal(_key_bits(got_k), _key_bits(want_k[0]))
        assert torch.equal(got_p, want_p[0])
        ran += 1
    assert ran >= 2
    j_keys = jnp.asarray(k, dtype=dtype)
    if dtype != "int32":    # the JAX oracle compares int32 keys in float32
        jk_, jp_ = jref.oddeven_sort_ref(j_keys, jnp.asarray(payload))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(got_k.float().numpy(),
                                      np.asarray(jk_.astype(jnp.float32)))
        k = np.where(np.isnan(k) | np.isneginf(k), -5.0, k).astype(np.float32)
        keys = torch.from_numpy(k).to(getattr(torch, dtype))
        j_keys = jnp.asarray(k, dtype=dtype)
        got_k, got_p, _ = pref.bitonic_sort_sim(keys, p, 512)
    pk, pp = jk.oddeven_sort(j_keys, jnp.asarray(payload), interpret=True)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(pp))
    np.testing.assert_array_equal(got_k.float().numpy(),
                                  np.asarray(pk.astype(jnp.float32)))


def test_bitonic_sort_sim_largest_bucket_and_its_schedule():
    """The fabric's largest bucket, 65536 slots, at the launchers' 512
    threads: bitwise the plain sort, with 10 passes over the scratch
    buffer.  And the schedule's split: at 2048 slots and 256 threads (8 keys
    each) only the 6 stages of partner distance >= 256 take a barrier, of
    66; a queue of up to 32 E slots sorts in one warp with none but the
    closing two."""
    k, payload = _sort_case(65536, "float32", seed=1)
    keys, p = torch.from_numpy(k), torch.from_numpy(payload)
    got_k, got_p, count = pref.bitonic_sort_sim(keys, p, 512)
    want_k, want_p = ops._sort.sort_plain(keys[None], p[None])
    assert torch.equal(_key_bits(got_k), _key_bits(want_k[0]))
    assert torch.equal(got_p, want_p[0])
    assert count["global"] == 10
    k, payload = _sort_case(2048, "float32", seed=2)
    _, _, count = pref.bitonic_sort_sim(torch.from_numpy(k),
                                        torch.from_numpy(payload), 256)
    assert count == {"register": 30, "shuffle": 30, "shared": 6, "global": 0,
                     "barriers": 6 + 3 + 2}
    for D, threads in ((8, 64), (64, 512), (256, 32)):
        _, _, count = pref.bitonic_sort_sim(
            torch.arange(D, dtype=torch.float32),
            torch.arange(D, dtype=torch.int32), threads)
        assert count["shared"] == count["global"] == 0
        assert count["barriers"] == 2
    with pytest.raises(ValueError):
        pref.bitonic_sort_sim(keys, p, 256)      # 16 keys a thread


def _select_case(kind, P):
    """(exec f32[D, P] in queue order, avail f32[P], tile, special) of one
    named drain case; ``special`` marks inputs held to ``heft_rt_numpy``
    instead of the Pallas kernel (-inf registers, subnormals)."""
    rng = np.random.default_rng(P * 31 + sum(map(ord, kind)))
    D, tile, special = 40, None, False
    ex = rng.integers(1, 16, (D, P)).astype(np.float32)
    ex[rng.random((D, P)) < 0.15] = np.inf
    ex[rng.random(D) < 0.15] = np.inf                 # all-inf rows
    avail = rng.integers(0, 8, P).astype(np.float32)
    if kind == "ring":
        tile = 7
    elif kind == "noop_rows":
        ex[rng.random(D) < 0.5] = np.inf
        ex[-6:] = np.inf                               # trailing no-ops
        tile = 8
    elif kind == "neg_inf_registers":
        avail[rng.random(P) < 0.3] = -np.inf
        avail[0] = -np.inf
        special = True
    elif kind == "subnormal":
        tiny = np.float32(1e-45)
        ex = np.where(np.isfinite(ex), ex * tiny, ex).astype(np.float32)
        avail = (avail * tiny).astype(np.float32)
        special = True
    return ex, avail, tile, special


@pytest.mark.parametrize("kind", ["ints", "ring", "noop_rows",
                                  "neg_inf_registers", "subnormal"])
@pytest.mark.parametrize("P", [1, 3, 4, 8, 13, 40, 200])
def test_eft_select_sim_equals_plain_versions_and_jax_reference(P, kind):
    """The mirror of the standalone drain (the event kernels' staging, no-op
    skipping, tile ring and steps over rows already in queue order) is
    bitwise ``eft_select_ref`` and the JAX reference: the Pallas kernel in
    interpret mode, or ``heft_rt_numpy`` (float64, exact here) where the
    Pallas guard differs (-inf registers) or XLA:CPU flushes subnormals."""
    ex, avail, tile, special = _select_case(kind, P)
    got = pref.eft_select_sim(*_t(ex, avail), tile=tile)
    _assert_bitwise(got, pref.eft_select_ref(*_t(ex, avail)))
    keys = -np.arange(len(ex), dtype=np.float32)     # identity priority order
    for g, w in zip(got, heft_rt_numpy(keys, ex, avail)[1:]):
        np.testing.assert_array_equal(g.numpy().astype(np.float64),
                                      np.asarray(w, dtype=np.float64))
    if special:
        assert (got[0].numpy() == -1).any() or kind == "subnormal"
    else:
        _assert_bitwise(got, jk.eft_select(ex, avail, interpret=True))

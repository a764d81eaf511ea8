"""The port's serving path (``repro_torch.serve``) on the CPU, f32.

* **Paged == dense, bitwise** (mirrors the unmeshed tests of
  ``test_paged_serve.py``): any admission interleaving, pool exhaustion and
  page reuse give each request the tokens of the port's own dense
  ``ServeEngine.generate``; exhaustion queues and never drops; pages move a
  request between engines.
* **The fused tick** (mirrors ``test_fused_decision.py``): the in-tick
  decision equals ``heft_rt_numpy`` slot for slot on f32-exact events, and
  the tick's tokens equal a plain tick's.
* **Against the reference**: one subprocess (``_torch_ref``) runs the JAX
  ``HeftFrontEnd.run_continuous(fused=True)`` on parameters drawn from
  ``np.random.default_rng``; the port, given the same numbers through
  ``params_from_reference``, must return the same tokens and the same
  sequence of mapping decisions, bitwise.
* **The launcher** runs on the CPU in a subprocess and passes its oracle
  check.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_ref import REPO, run_reference, unflatten

from repro_torch.configs import get_smoke_config
from repro_torch.core import heft_rt_numpy
from repro_torch.models import ModelConfig, init_params, params_from_reference
from repro_torch.obs import MetricsRegistry, Tracer, validate_chrome_trace
from repro_torch.sched_integration import (POLICIES, CostCell,
                                           CostModelRegistry, FleetController,
                                           FleetControllerConfig, MappingFabric,
                                           default_fleet,
                                           grown_replica_factory,
                                           make_requests, pow2_bucket,
                                           simulate_serving)
from repro_torch.serve import HeftFrontEnd, ReplicaHandle, ServeEngine

CFG = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=4, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32")

# Module-level lazy singletons instead of fixtures: the hypothesis fallback
# wraps @given tests with a zero-arg signature.
_CACHE: dict = {}


def _params():
    if "params" not in _CACHE:
        _CACHE["params"] = init_params(CFG, torch.Generator().manual_seed(0),
                                       device="cpu")
    return _CACHE["params"]


def _engine(**kw):
    return ServeEngine(CFG, _params(), max_len=32, **kw)


def _oracle():
    if "oracle" not in _CACHE:
        _CACHE["oracle"] = _engine()
    return _CACHE["oracle"]


def _requests(n, rng, smax=32, nt_max=8):
    out = []
    for _ in range(n):
        nt = int(rng.integers(1, nt_max))
        s0 = int(rng.integers(2, smax - nt))
        out.append((rng.integers(1, CFG.vocab_size, size=s0).astype(np.int32),
                    nt))
    return out


def _drain(eng, reqs, order):
    """Admit ``reqs`` in ``order`` (FIFO, queue on refusal) and run the
    admission / decode / retire loop until every request retires; returns
    the outputs and the number of refusals."""
    pending = list(order)
    slot_req, out, refused = {}, {}, 0
    guard = 0
    while len(out) < len(reqs):
        while pending:
            slot = eng.admit(*reqs[pending[0]])
            if slot is None:
                refused += 1
                break
            slot_req[slot] = pending.pop(0)
        eng.decode_tick()
        for slot in eng.finished_slots():
            out[slot_req.pop(slot)] = eng.retire(slot)
        guard += 1
        assert guard < 10_000, "paged drain did not converge"
    return out, refused


def _event(rng, n, p, inf_frac=0.15):
    """Small-integer event: every finish time exact in f32, with occasional
    all-inf rows."""
    avg = rng.integers(0, 4, n).astype(np.float64)     # duplicate keys
    ex = rng.integers(1, 16, (n, p)).astype(np.float64)
    ex[rng.random(n) < inf_frac] = np.inf
    return avg, ex


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# paged == dense, bitwise
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_random_interleaving_bit_identical_to_dense(seed):
    """Any admission interleaving (a tiny pool forcing queueing and page
    reuse) reproduces the dense oracle token for token."""
    rng = np.random.default_rng(seed)
    reqs = _requests(5, rng)
    oracle = [_oracle().generate(p[None], nt)[0] for p, nt in reqs]
    eng = _engine()
    eng.start_paged(max_batch=int(rng.integers(2, 5)), page_size=8)
    out, _ = _drain(eng, reqs, rng.permutation(len(reqs)).tolist())
    for i in range(len(reqs)):
        np.testing.assert_array_equal(out[i], oracle[i])
    pool = eng.paged.pool
    assert pool.allocated == pool.freed
    assert pool.free_pages == pool.num_pages


def test_exhaustion_queues_never_drops():
    """A pool with room for ONE sequence still serves everything, strictly
    serialized and token-identical; admit() refuses instead of dropping."""
    rng = np.random.default_rng(3)
    reqs = _requests(4, rng)
    eng = _engine()
    eng.start_paged(max_batch=4, page_size=8, num_pages=4)   # 4 pages = 1 seq
    out, refused = _drain(eng, reqs, range(len(reqs)))
    assert refused > 0
    for i, (p, nt) in enumerate(reqs):
        np.testing.assert_array_equal(out[i],
                                      _oracle().generate(p[None], nt)[0])
    assert eng.paged.pool.allocated == eng.paged.pool.freed


def test_admit_rejects_impossible_and_validates():
    eng = _engine()
    with pytest.raises(RuntimeError, match="start_paged"):
        eng.admit(np.ones(4, dtype=np.int32), 2)
    eng.start_paged(max_batch=2, page_size=8)
    with pytest.raises(ValueError):                # S0+nt > max_len
        eng.admit(np.ones(30, dtype=np.int32), 8)
    with pytest.raises(ValueError):                # new_tokens < 1
        eng.admit(np.ones(4, dtype=np.int32), 0)
    with pytest.raises(ValueError):                # page_size ∤ max_len
        _engine().start_paged(page_size=7)
    with pytest.raises(ValueError, match="lanes"):  # more slots than lanes
        _engine(lanes=2).start_paged(max_batch=3, page_size=8)
    with pytest.raises(ValueError, match="num_pages"):
        _engine().start_paged(max_batch=2, page_size=8, num_pages=3)


def test_free_pages_accounting():
    eng = _engine()
    eng.start_paged(max_batch=2, page_size=8)      # 8 pages total
    assert eng.free_pages() == 8
    slot = eng.admit(np.arange(1, 10, dtype=np.int32), 4)   # 13 tok → 2 pages
    assert eng.free_pages() == 6
    while not eng.finished_slots():
        eng.decode_tick()
    eng.retire(slot)
    assert eng.free_pages() == 8
    assert eng.paged.pool.allocated == eng.paged.pool.freed == 2
    assert eng.decode_tick() == {}                 # nothing in flight


def test_snapshot_restore_moves_request_between_engines():
    """Kill-and-recover at page granularity: a mid-decode snapshot on
    engine A restores on engine B and finishes token-identically."""
    rng = np.random.default_rng(7)
    (p, nt), = _requests(1, rng, nt_max=8)
    nt = max(nt, 4)
    oracle = _oracle().generate(p[None], nt)[0]
    a = _engine()
    a.start_paged(max_batch=2, page_size=8)
    slot = a.admit(p, nt)
    a.decode_tick()
    snap = a.snapshot_pages(slot)
    b = _engine()
    b.start_paged(max_batch=2, page_size=8)
    b.admit(np.arange(1, 20, dtype=np.int32), 4)   # occupy other pages first
    slot_b = b.restore_pages(snap)
    assert slot_b is not None
    while slot_b not in b.finished_slots():
        b.decode_tick()
    np.testing.assert_array_equal(b.retire(slot_b), oracle)


def test_dense_caches_snapshot_restore_and_step_resume():
    """start/step resumed on another engine from a host snapshot equals an
    uninterrupted generate (the chaos tier's recovery unit)."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
    want = _oracle().generate(prompt[None], 8)
    eng = _engine()
    logits, caches = eng.start(prompt[None])
    toks = []
    for i in range(4):
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks.append(tok.numpy())
        logits, caches = eng.step(caches, tok[:, None], 12 + i)
    snap = eng.snapshot_caches(caches)
    saved_logits = logits.numpy().copy()
    other = _engine()
    caches = other.restore_caches(snap)
    logits = torch.from_numpy(saved_logits)
    for i in range(4, 8):
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks.append(tok.numpy())
        logits, caches = other.step(caches, tok[:, None], 12 + i)
    np.testing.assert_array_equal(np.stack(toks, axis=1), want[:, 12:])


def test_generate_batches_and_samples_with_an_explicit_generator():
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, CFG.vocab_size, (3, 6)).astype(np.int32)
    batch = _oracle().generate(prompts, 5)
    for b in range(3):
        np.testing.assert_array_equal(
            batch[b], _oracle().generate(prompts[b:b + 1], 5)[0])
    wide = _engine(lanes=2).generate(prompts, 5)   # more prompts than lanes
    assert wide.shape == (3, 11)
    with pytest.raises(ValueError, match="Generator"):
        _oracle().generate(prompts, 3, greedy=False)
    draws = [_oracle().generate(prompts, 5, greedy=False,
                                generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[0][:, :6], prompts)


# ---------------------------------------------------------------------------
# Mamba state, hybrid MoE and MLA in the paged runtime
# ---------------------------------------------------------------------------

STATE_ARCHS = ["falcon_mamba_7b", "jamba_v0_1_52b", "deepseek_v2_236b"]
CHUNKABLE = [1, 2, 3, 4, 8, 12, 16]    # the smoke configs' Mamba chunk: 4


def _arch_params(arch):
    if arch not in _CACHE:
        _CACHE[arch] = init_params(get_smoke_config(arch),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    return _CACHE[arch]


def _arch_engine(arch, **kw):
    """Four decode lanes: with MoE layers no token can be dropped there."""
    return ServeEngine(get_smoke_config(arch), _arch_params(arch), max_len=32,
                       lanes=4, **kw)


def _arch_requests(n, rng, vocab):
    return [(rng.integers(1, vocab, int(rng.choice(CHUNKABLE)))
             .astype(np.int32), int(rng.integers(1, 9))) for _ in range(n)]


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_models_random_interleaving_bit_identical_to_dense(arch):
    """Random admission orders, pool sizes and slot counts at four lanes:
    every request's tokens are bitwise the dense ``generate``'s, and pages
    and state slots come back."""
    cfg = get_smoke_config(arch)
    oracle = _arch_engine(arch)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        reqs = _arch_requests(5, rng, cfg.vocab_size)
        eng = _arch_engine(arch)
        max_batch = int(rng.integers(2, 5))
        eng.start_paged(max_batch=max_batch, page_size=8,
                        num_pages=int(rng.choice([4, 8, 4 * max_batch])))
        out, _ = _drain(eng, reqs, rng.permutation(len(reqs)).tolist())
        for i, (p, nt) in enumerate(reqs):
            np.testing.assert_array_equal(out[i],
                                          oracle.generate(p[None], nt)[0])
        pool = eng.paged.pool
        assert pool.allocated == pool.freed
        assert pool.slots_allocated == pool.slots_freed == len(reqs)
        assert pool.free_slots == max_batch


def test_state_pool_slots_hold_the_prefill_state_and_come_back():
    arch = "falcon_mamba_7b"
    cfg = get_smoke_config(arch)
    eng = _arch_engine(arch)
    rt = eng.start_paged(max_batch=2, page_size=8)
    pool = rt.pool
    assert set(pool.pools) == {"conv", "ssm"}
    assert pool.pools["ssm"].shape == (cfg.num_layers, 3, cfg.ssm.d_inner,
                                       cfg.ssm.d_state)
    assert pool.pools["conv"].shape == (cfg.num_layers, 3,
                                        cfg.ssm.d_conv - 1, cfg.ssm.d_inner)
    prompt = np.arange(1, 9, dtype=np.int32)
    with pytest.raises(ValueError, match="multiple"):   # 6 tokens, chunk 4
        eng.admit(prompt[:6], 2)
    assert pool.free_slots == 2 and pool.slots_allocated == 0
    slot = eng.admit(prompt, 4)
    _, dense = eng.start(prompt[None])
    for name in ("conv", "ssm"):
        assert torch.equal(pool.pools[name][:, slot], dense[name][:, 0])
    other = eng.admit(prompt[:4], 4)
    assert eng.admit(prompt[:4], 4) is None              # no slot left
    assert pool.slots_allocated == 2 and pool.free_slots == 0
    while len(eng.finished_slots()) < 2:
        eng.decode_tick()
    eng.retire(slot)
    eng.retire(other)
    assert pool.slots_allocated == pool.slots_freed == 2
    assert pool.allocated == pool.freed


def test_snapshot_restore_moves_a_mamba_request_between_engines():
    """jamba: the request's pages (its attention layer) and state rows (its
    Mamba layers) move mid-decode to another engine, which finishes it
    token-identically."""
    arch = "jamba_v0_1_52b"
    cfg = get_smoke_config(arch)
    prompt = np.random.default_rng(7).integers(1, cfg.vocab_size, 12) \
        .astype(np.int32)
    oracle = _arch_engine(arch).generate(prompt[None], 8)[0]
    a = _arch_engine(arch)
    a.start_paged(max_batch=2, page_size=8)
    slot = a.admit(prompt, 8)
    a.decode_tick()
    a.decode_tick()
    snap = a.snapshot_pages(slot)
    n_m = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.num_layers))
    assert snap["pages"]["ssm"].shape == (n_m, cfg.ssm.d_inner,
                                          cfg.ssm.d_state)
    assert snap["pages"]["k"].shape[:3] == (1, 4, 8)
    b = _arch_engine(arch)
    b.start_paged(max_batch=2, page_size=8)
    b.admit(np.arange(1, 9, dtype=np.int32), 4)         # slot 0 taken first
    slot_b = b.restore_pages(snap)
    assert slot_b == 1
    while slot_b not in b.finished_slots():
        b.decode_tick()
    np.testing.assert_array_equal(b.retire(slot_b), oracle)


# ---------------------------------------------------------------------------
# the graphed tick's fixed buffers
# ---------------------------------------------------------------------------

def _serve_ticks(eng, reqs, order, seed, fab=None, moves=()):
    """Drive ``eng``'s paged runtime: admit ``reqs`` in ``order`` (FIFO,
    queueing on a refusal), tick once an iteration, every other tick
    carrying a mapping event on ``fab`` where one is given, and retire what
    finished.  At the iterations in ``moves`` the lowest active slot is
    snapshot, dropped and restored (it comes back on other pages).  Returns
    the outputs by request, every tick's tokens and every decision."""
    rng = np.random.default_rng(seed)
    pending = list(order)
    slot_req, out, ticks, decisions = {}, {}, [], []
    it = 0
    while len(out) < len(reqs):
        while pending:
            slot = eng.admit(*reqs[pending[0]])
            if slot is None:
                break
            slot_req[slot] = pending.pop(0)
        active = eng.paged.active_slots()
        if it in moves and active:
            snap = eng.snapshot_pages(active[0])
            req = slot_req.pop(active[0])
            eng.retire(active[0])
            slot = eng.restore_pages(snap)
            assert slot is not None
            slot_req[slot] = req
        if fab is not None and it % 2 == 0:
            avg, ex = _event(rng, int(rng.integers(2, 10)), fab.num_pes)
            toks, decision = eng.decode_tick((avg, ex, fab))
            if toks:
                decisions.append(decision)
        else:
            toks = eng.decode_tick()
        ticks.append(toks)
        for slot in eng.finished_slots():
            out[slot_req.pop(slot)] = eng.retire(slot)
        it += 1
        assert it < 10_000, "paged drain did not converge"
    return out, ticks, decisions


def _same_decisions(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        for x, y in zip(da, db):
            np.testing.assert_array_equal(_bits(x), _bits(y))


def _graph_vs_eager(make, reqs, order, seed, moves, device):
    """The same traffic through an eager runtime and a graphed one (on the
    CPU: the captured body called over the fixed buffers), each with its
    own fused fabric.  Returns both runs and both runtimes' counts."""
    runs = []
    for graphed in (False, True):
        eng, rt = make()
        rt._graphed = graphed
        fab = MappingFabric(4, backend="fused", device=device,
                            device_counters=True)
        runs.append((*_serve_ticks(eng, reqs, order, seed, fab, moves),
                     dict(rt.tick_graph)))
    (out_e, ticks_e, dec_e, n_e), (out_g, ticks_g, dec_g, n_g) = runs
    assert ticks_g == ticks_e
    _same_decisions(dec_g, dec_e)
    assert dec_g
    for i in range(len(reqs)):
        np.testing.assert_array_equal(out_g[i], out_e[i])
    taken = sum(1 for t in ticks_e if t)
    assert n_e == {"captures": 0, "replays": 0, "eager": taken}
    assert n_g == {"captures": 1, "replays": taken, "eager": 0}
    return out_g, taken


@pytest.mark.parametrize("arch", ["dense", "falcon_mamba_7b"])
def test_fixed_buffer_tick_is_the_eager_tick_and_the_oracle(arch):
    """The graphed tick's body over its fixed buffers, with its warm-up on
    the scratch lanes, gives the eager tick's tokens and fused decisions
    bit for bit, and each request the dense oracle's sequence, under random
    admission orders, pool sizes that force queueing and page reuse, and
    a slot snapshot, dropped and restored mid-decode."""
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        if arch == "dense":
            reqs, oracle, lanes = _requests(5, rng), _oracle(), 8
        else:
            reqs = _arch_requests(5, rng, get_smoke_config(arch).vocab_size)
            oracle, lanes = _arch_engine(arch), 4
        max_batch = int(rng.integers(2, lanes + 1))
        num_pages = int(rng.choice([4, 8, 4 * max_batch]))

        def make():
            eng = _engine() if arch == "dense" else _arch_engine(arch)
            return eng, eng.start_paged(max_batch=max_batch, page_size=8,
                                        num_pages=num_pages)

        out, _ = _graph_vs_eager(make, reqs,
                                 rng.permutation(len(reqs)).tolist(), seed,
                                 {1, 4}, "cpu")
        for i, (p, nt) in enumerate(reqs):
            np.testing.assert_array_equal(out[i],
                                          oracle.generate(p[None], nt)[0])


def test_rebind_drops_the_tick_graph_and_moved_pools_capture_again():
    eng = _engine()
    rt = eng.start_paged(max_batch=2, page_size=8)
    assert rt._graphed is False and rt._graph is None       # the CPU
    rt._graphed = True
    prompt = np.arange(1, 8, dtype=np.int32)
    eng.admit(prompt, 6)
    toks = [eng.decode_tick()]
    g = rt._graph
    assert g is not None and g.toks is not None and g.graph is None
    rt.rebind()
    assert rt._graph is None and rt._graphed is False
    rt._graphed = True
    toks.append(eng.decode_tick())
    assert rt._graph is not g and rt.tick_graph["captures"] == 2
    for name in list(rt.pool.pools):                        # pools moved
        rt.pool.pools[name] = rt.pool.pools[name].clone()
    toks.append(eng.decode_tick())
    assert rt.tick_graph == {"captures": 3, "replays": 3, "eager": 0}
    while not eng.finished_slots():
        toks.append(eng.decode_tick())
    slot, = eng.finished_slots()
    np.testing.assert_array_equal(eng.retire(slot),
                                  _oracle().generate(prompt[None], 6)[0])
    assert [t[slot] for t in toks] == \
        _oracle().generate(prompt[None], 6)[0][len(prompt) + 1:].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek_7b", "falcon_mamba_7b",
                                  "deepseek_v2_236b", "jamba_v0_1_52b",
                                  "gemma2_9b"])
def test_graph_replay_is_the_eager_tick_on_the_card(arch, dtype):
    """On the card: over 64 ticks and more, with admissions, retires, page
    reuse and a slot moved between them, the CUDA graph's replays give the
    eager tick's tokens and fused decisions bit for bit; one capture a
    runtime, one replay a tick taken.  GQA (deepseek_7b), Mamba, MLA with
    MoE (deepseek_v2_236b), the Mamba / attention / MoE hybrid (jamba) and
    gemma2's scaled embedding, soft caps and local windows, at smoke
    widths, four lanes.  (A page snapshot is numpy, which has no bfloat16:
    slots move in the float32 cases.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured on one")
    cfg = get_smoke_config(arch).with_(param_dtype=dtype,
                                       compute_dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(25)
    reqs = [(rng.integers(1, cfg.vocab_size, int(rng.choice(CHUNKABLE)))
             .astype(np.int32), int(rng.integers(6, 30))) for _ in range(24)]

    def make():
        eng = ServeEngine(cfg, params, max_len=64, lanes=4)
        return eng, eng.start_paged(max_batch=4, page_size=8, num_pages=20)

    moves = {7, 30} if dtype == "float32" else ()
    _, taken = _graph_vs_eager(make, reqs, range(len(reqs)), 25, moves,
                               "cuda")
    assert taken >= 64


# ---------------------------------------------------------------------------
# the fused tick
# ---------------------------------------------------------------------------

def test_decode_tick_sched_contract_and_counters():
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, CFG.vocab_size, 6).astype(np.int32)
    fab = MappingFabric(4, backend="fused", device="cpu",
                        device_counters=True)
    eng, plain = _engine(), _engine()
    for e in (eng, plain):
        e.start_paged(max_batch=2, page_size=8)
        assert e.admit(prompt, 8) is not None
    mirror = np.zeros(4)
    host = np.zeros(4)
    for _ in range(6):
        n = int(rng.integers(2, 10))
        avg, ex = _event(rng, n, 4)
        out, decision = eng.decode_tick((avg, ex, fab))
        assert out == plain.decode_tick()          # identical decode
        want = heft_rt_numpy(avg, ex, mirror)
        mirror = want[4]
        for got, w in zip(decision, want):
            np.testing.assert_array_equal(
                np.asarray(got, dtype=np.float64), w)
        host[0] += 1
        host[1] += int((want[1] >= 0).sum())
        host[2] += n
        host[3] += float(np.float32(mirror.max()) - np.float32(mirror.min()))
    np.testing.assert_array_equal(fab.avail, mirror)
    ctr = fab.drain_counters()
    assert [ctr[k] for k in ("events", "decisions", "occupancy")] == \
        list(host[:3])
    assert ctr["t_avail_spread"] == pytest.approx(host[3])
    idle = _engine()
    idle.start_paged(max_batch=2, page_size=8)
    assert idle.decode_tick((np.zeros(2), np.ones((2, 4)), fab)) == ({}, None)


def test_fused_tick_requires_a_fused_fabric():
    eng = _engine()
    eng.start_paged(max_batch=2, page_size=8)
    eng.admit(np.arange(1, 6, dtype=np.int32), 3)
    fab = MappingFabric(2, backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="fused"):
        eng.decode_tick((np.zeros(2), np.ones((2, 2)), fab))
    front = HeftFrontEnd([ReplicaHandle("r0", _engine())])
    with pytest.raises(ValueError, match="fused"):
        front.run_continuous([(np.arange(1, 5, dtype=np.int32), 2)],
                             fused=True, max_batch=2, page_size=8,
                             num_pages=8)


@pytest.mark.parametrize("fused", [False, True])
def test_run_continuous_matches_oracle_and_balances(fused):
    rng = np.random.default_rng(11)
    reqs = _requests(6, rng)
    fleet = [ReplicaHandle(f"replica{i}", _engine(), speed=s)
             for i, s in enumerate([1.0, 0.7])]
    fab = (MappingFabric(2, backend="fused", device="cpu",
                         device_counters=True) if fused else None)
    front = HeftFrontEnd(fleet, fabric=fab)
    outs, stats = front.run_continuous(
        reqs, arrival_ticks=[0, 0, 1, 2, 2, 5],
        max_batch=2, page_size=8, num_pages=8)
    for i, (p, nt) in enumerate(reqs):
        np.testing.assert_array_equal(outs[i],
                                      _oracle().generate(p[None], nt)[0])
    assert stats["allocated"] == stats["freed"]
    assert sum(stats["processed"].values()) == len(reqs)
    assert stats["fused_decisions"] + stats["host_decisions"] == \
        (len(reqs) if fused else 0)
    assert len(stats["latency_s"]) == len(reqs)
    assert all(t > 0 for t in stats["latency_s"])
    if fused:
        assert stats["fused_decisions"] > 0
        assert fab.drain_counters()["decisions"] == len(reqs)
    with pytest.raises(ValueError, match="arrival_ticks"):
        front.run_continuous(reqs, arrival_ticks=[0])
    with pytest.raises(ValueError, match="never be admitted"):
        HeftFrontEnd([ReplicaHandle("r", _engine())]).run_continuous(
            [(np.ones(30, np.int32), 6)], max_batch=1, page_size=8,
            num_pages=4)


def test_run_batch_schedules_and_traces():
    rng = np.random.default_rng(2)
    reqs = _requests(4, rng)
    tracer, metrics = Tracer(), MetricsRegistry()
    fleet = [ReplicaHandle(f"r{i}", _engine(tracer=tracer), speed=s)
             for i, s in enumerate([1.0, 2.0])]
    front = HeftFrontEnd(fleet, tracer=tracer, metrics=metrics)
    outs, counts = front.run_batch(reqs)
    for (p, nt), o in zip(reqs, outs):
        np.testing.assert_array_equal(o[0], _oracle().generate(p[None], nt)[0])
    assert sum(counts.values()) == len(reqs)
    names = {e.name for e in tracer.events()}
    assert {"frontend.schedule", "frontend.generate", "engine.prefill",
            "engine.decode_step", "frontend.queue_depth"} <= names
    assert metrics.histogram("frontend.decision_s").count == len(reqs)
    # the host path decides as the heft_rt_numpy oracle does
    ex = front.exec_estimates(reqs)
    for r in fleet:
        r.avail_at = 0.0
    want = heft_rt_numpy(ex.mean(axis=1), ex, np.zeros(2))
    assert front.schedule(reqs) == [(int(o), int(a))
                                    for o, a in zip(want[0], want[1])]


class _Eng:           # estimate-only stand-in; never executed
    pass


def test_front_end_set_unreachable_masks_and_clears():
    front = HeftFrontEnd([ReplicaHandle("a", _Eng()),
                          ReplicaHandle("b", _Eng(), speed=2.0)],
                         fabric=MappingFabric(2, backend="numpy",
                                              device="cpu"))
    reqs = [(np.zeros(10, np.int32), 4), (np.zeros(6, np.int32), 2)]
    front.set_unreachable(["a", "ghost"])      # unknown names are ignored
    assert np.isinf(front.exec_estimates(reqs)[:, 0]).all()
    assert all(p == 1 for _, p in front.schedule(reqs))
    front.set_unreachable([])
    assert front.fabric._pe_mask is None
    assert np.isfinite(front.exec_estimates(reqs)).all()
    front.set_unreachable(["b"])
    front.remove_replica("b")
    assert front.unreachable == set() and front.fabric._pe_mask is None


def test_front_end_dynamic_registry_resizes_fabric():
    front = HeftFrontEnd([ReplicaHandle("a", _Eng()),
                          ReplicaHandle("b", _Eng(), speed=2.0)],
                         fabric=MappingFabric(2, backend="numpy",
                                              device="cpu"))
    reqs = [(np.zeros(10, np.int32), 4), (np.zeros(6, np.int32), 2)]
    front.schedule(reqs)
    front.add_replica(ReplicaHandle("c", _Eng(), speed=4.0, avail_at=0.125))
    assert front.fabric.num_pes == 3
    assert front.fabric.avail[2] == 0.125
    assert all(0 <= p < 3 for _, p in front.schedule(reqs))
    removed = front.remove_replica("a")
    assert removed.name == "a" and front.fabric.num_pes == 2
    assert all(0 <= p < 2 for _, p in front.schedule(reqs))
    with pytest.raises(KeyError):
        front.remove_replica("a")


def test_front_end_uses_registry_columns():
    """Covered replicas get cost-model Exec_TID columns, the others the
    host-scale fallback (test_serve_sharded.py)."""
    fast = ReplicaHandle("fast", _Eng(), speed=4.0, arch="t",
                         mesh_shape=(2, 2), compute_tflops=4.0, hbm_gbps=4.0)
    slow = ReplicaHandle("slow", _Eng(), speed=1.0)
    reg = CostModelRegistry([
        CostCell("t", "prefill", (2, 2), tokens_per_step=8,
                 flops_per_device=16e12 / 4, bytes_per_device=0.0),
        CostCell("t", "decode", (2, 2), tokens_per_step=1,
                 flops_per_device=0.0, bytes_per_device=8e9 / 4),
    ])
    front = HeftFrontEnd([fast, slow], cost_registry=reg)
    reqs = [(np.zeros(10, np.int32), 4), (np.zeros(20, np.int32), 2)]
    ex = front.exec_estimates(reqs)
    want_fast = np.array([10 * (16e12 / 8) / 4e12 + 4 * 8e9 / 4e9,
                          20 * (16e12 / 8) / 4e12 + 2 * 8e9 / 4e9])
    np.testing.assert_allclose(ex[:, 0], want_fast, rtol=1e-12)
    want_slow = np.array([1e-4 * 10 + 2e-3 * 4, 1e-4 * 20 + 2e-3 * 2])
    np.testing.assert_allclose(ex[:, 1], want_slow, rtol=1e-12)
    plan = front.schedule(reqs)
    assert sorted(i for i, _ in plan) == [0, 1]


# ---------------------------------------------------------------------------
# the simulator twin's slots (test_paged_serve.py)
# ---------------------------------------------------------------------------

def test_slots1_bit_identical_and_slots_help():
    def load():
        return make_requests(30.0, 6.0, seed=0)

    base = simulate_serving(default_fleet(), load(),
                            POLICIES["heft_rt"](device="cpu"),
                            active_params=7e9)
    again = simulate_serving([dataclasses.replace(r, slots=1)
                              for r in default_fleet()], load(),
                             POLICIES["heft_rt"](device="cpu"),
                             active_params=7e9)
    np.testing.assert_array_equal(base.finish_times, again.finish_times)
    np.testing.assert_array_equal(base.final_avail, again.final_avail)
    assert base.p99_latency == again.p99_latency
    multi = simulate_serving([dataclasses.replace(r, slots=4)
                              for r in default_fleet()], load(),
                             POLICIES["heft_rt"](device="cpu"),
                             active_params=7e9)
    assert multi.p99_latency <= base.p99_latency + 1e-12


def test_multislot_straggler_remap_guard():
    fleet = [dataclasses.replace(r, slots=2) for r in default_fleet()]
    ctl = FleetController(
        FleetControllerConfig(straggler_factor=1.01,
                              straggler_min_backlog_s=0.0),
        grown_replica_factory("g", (2, 2)))
    with pytest.raises(ValueError, match="multi-slot"):
        simulate_serving(fleet, make_requests(400.0, 4.0, seed=0),
                         POLICIES["heft_rt"](device="cpu"),
                         active_params=7e9, controller=ctl)


def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert pow2_bucket(1, min_bucket=8) == 8


# ---------------------------------------------------------------------------
# against the JAX reference's front end
# ---------------------------------------------------------------------------

REF_SCRIPT = '''
import jax, jax.numpy as jnp
from repro.models.config import ModelConfig
from repro.models.model import param_shapes
from repro.sched_integration.fabric import MappingFabric
from repro.serve import HeftFrontEnd, ReplicaHandle, ServeEngine

CFG = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=4, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32")
rng = np.random.default_rng(21)
params_np = rand_tree(param_shapes(CFG), rng)
out = flat_tree(params_np, "params", {})
params = jax.tree.map(jnp.asarray, params_np)
reqs = []
for i in range(6):
    nt = int(rng.integers(1, 8))
    s0 = int(rng.integers(2, 32 - nt))
    p = rng.integers(1, 64, size=s0).astype(np.int32)
    reqs.append((p, nt))
    out[f"req|{i}"] = p
decisions = []
orig = HeftFrontEnd._adopt_decision
def record(self, n, decision):
    decisions.append(decision)
    return orig(self, n, decision)
HeftFrontEnd._adopt_decision = record
fleet = [ReplicaHandle(f"replica{i}", ServeEngine(CFG, params, max_len=32),
                       speed=s) for i, s in enumerate([1.0, 0.7, 1.4])]
front = HeftFrontEnd(fleet, fabric=MappingFabric(3, backend="fused",
                                                 device_counters=True))
outs, stats = front.run_continuous(reqs, arrival_ticks=ARRIVALS,
                                   max_batch=2, page_size=8, num_pages=8)
for i, o in enumerate(outs):
    out[f"out|{i}"] = o
for k, d in enumerate(decisions):
    for name, x in zip(("order", "assignment", "start", "finish",
                        "new_avail"), d):
        out[f"dec|{k}|{name}"] = np.asarray(x)
for k in ("ticks", "fused_decisions", "host_decisions", "allocated",
          "freed"):
    out[f"stat|{k}"] = np.asarray(stats[k])
out["stat|processed"] = np.asarray([stats["processed"][r.name]
                                    for r in fleet])
ctr = front.fabric.drain_counters()
out["counters"] = np.asarray([ctr[k] for k in sorted(ctr)], np.float64)
np.savez(OUT, **out)
'''
ARRIVALS = [0, 0, 1, 2, 2, 4]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(f"ARRIVALS = {ARRIVALS!r}\n" + REF_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "serve.npz")


def test_fused_run_continuous_equals_the_reference_front_end(ref):
    params = params_from_reference(CFG, unflatten(ref, "params"),
                                   device="cpu")
    reqs = [(ref[f"req|{i}"], int(ref[f"out|{i}"].size - ref[f"req|{i}"].size))
            for i in range(len(ARRIVALS))]
    fleet = [ReplicaHandle(f"replica{i}",
                           ServeEngine(CFG, params, max_len=32), speed=s)
             for i, s in enumerate([1.0, 0.7, 1.4])]
    fab = MappingFabric(3, backend="fused", device="cpu",
                        device_counters=True)
    front = HeftFrontEnd(fleet, fabric=fab)
    decisions = []
    adopt = front._adopt_decision

    def record(n, decision):
        decisions.append(decision)
        return adopt(n, decision)

    front._adopt_decision = record
    outs, stats = front.run_continuous(reqs, arrival_ticks=ARRIVALS,
                                       max_batch=2, page_size=8, num_pages=8)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, ref[f"out|{i}"])
        np.testing.assert_array_equal(
            o, fleet[0].engine.generate(reqs[i][0][None], reqs[i][1])[0])
    n_ref = sum(1 for k in ref if k.startswith("dec|") and k.endswith("|order"))
    assert len(decisions) == n_ref > 0
    for k, d in enumerate(decisions):
        for name, x in zip(("order", "assignment", "start", "finish",
                            "new_avail"), d):
            np.testing.assert_array_equal(_bits(x), _bits(ref[f"dec|{k}|{name}"]),
                                          err_msg=f"decision {k} {name}")
    for k in ("ticks", "fused_decisions", "host_decisions", "allocated",
              "freed"):
        assert stats[k] == int(ref[f"stat|{k}"]), k
    assert [stats["processed"][r.name] for r in fleet] == \
        ref["stat|processed"].tolist()
    ctr = fab.drain_counters()
    np.testing.assert_array_equal(
        np.asarray([ctr[k] for k in sorted(ctr)], np.float64), ref["counters"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_paged_fused_on_the_cpu_and_checks_the_oracle(tmp_path):
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--paged", "--fused-scheduler", "--requests", "4", "--new-tokens",
         "4", "--trace", str(trace)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    assert "request 0 verified token-identical to the dense oracle" in out
    assert "fused in-tick" in out
    doc = json.loads(trace.read_text())
    validate_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"engine.decode_tick", "engine.admit"} <= names
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--fused-scheduler"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode != 0 and "requires --paged" in proc.stderr


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *args], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)


def test_launcher_serves_jamba_paged_fused_through_the_oracle_check():
    """The hybrid Mamba / attention / MoE model through the launcher, with
    prompt lengths its Mamba layers can chunk (the random 8-47 cannot)."""
    proc = _launch("--arch", "jamba-v0.1-52b", "--paged", "--fused-scheduler",
                   "--requests", "4", "--new-tokens", "4",
                   "--prompt-lens", "8,12,16,32")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    assert "request 0 verified token-identical to the dense oracle" in out
    assert "fused in-tick" in out


def test_launcher_refuses_falcon_mamba_prompts_it_cannot_chunk():
    """The launcher's random prompts (8-47 tokens; the first has 42) do not
    split into falcon-mamba's scan chunks: the run raises the reference's
    prompt-length error instead of serving (ROADMAP queue 3)."""
    proc = _launch("--arch", "falcon-mamba-7b", "--paged", "--requests", "2",
                   "--new-tokens", "2")
    assert proc.returncode != 0
    assert ("a Mamba prefill of 42 tokens must be at most the scan chunk (4) "
            "or a multiple of it") in proc.stderr

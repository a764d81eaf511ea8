"""Decode attention read from the KV pages in place
(``kernels.paged_decode_attention``) and the decode tick built on it.

On the CPU, where the wrapper runs its plain version:

* the plain version against ``decode_attention`` over a dense cache that a
  random page table scatters into pages, bitwise: positions 0 ..
  max_len - 1, scratch lanes, G = 1 and G > 1, gemma2's local window and
  soft cap; and the contiguous form (no table);
* the wrapper refuses what the kernel does not take;
* a decode step over page pools and their page table is the plain step
  over the same values, bitwise;
* the tick with K / V read in place (the card's path, taken here with
  ``PagedRuntime._set_paths(True)``): every request bitwise the dense
  ``generate`` under random admission orders, queueing, page reuse and a
  slot moved mid-decode; ``tick_kv`` and the ``tick.kv`` counter count a
  paged tick for every tick taken, and none for falcon-mamba-7b or
  deepseek-v2-lite, which cache no ``k`` / ``v``.

The bound the kernel is held to (``paged_attention.tolerance``) holds the
same attention summed in another order and rejects planted faults.

On the card (``-m cuda``; they skip here), at deepseek-7b's and gemma2's
widths: the kernel against its plain version within that bound, and the
kernel given each planted fault's operands outside it; a
lane's output bitwise whatever its batch-mates, graphed or eager, paged or
contiguous; the same greedy tokens as the plain path; and the paged tick
bitwise the dense ``generate`` through the kernel.  Nothing here imports
JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_v2_lite, get_smoke_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import ModelConfig, init_params
from repro_torch.models.attention import (PAGES, PageTable, decode_attention,
                                          decode_partials, merge_partials,
                                          plain_decode_attention)
from repro_torch.models.model import decode_step, init_cache
from repro_torch.obs import Tracer
from repro_torch.serve import ServeEngine

CFG = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=4, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32")
CHUNKABLE = [4, 8, 12, 16]          # prompts the smoke Mamba chunk (4) takes
_CACHE: dict = {}

# (H, KV, hd, soft cap, window): G = 1, G = 4, G = 7, gemma2's smoke
SHAPES = [(4, 4, 16, None, None), (8, 2, 16, None, None),
          (7, 1, 8, None, None), (4, 2, 32, 50.0, 8)]


def _paged(rng, lanes, H, KV, hd, ps, max_len, dtype=torch.float32,
           device="cpu"):
    """q, a dense (lanes, max_len, KV, hd) K / V, the same values in pools
    of ``lanes * pages_per_lane + 1`` pages through a random page table
    (lane 0 a scratch lane: every entry the scratch page, its dense rows
    that page's tiled), and positions covering 0 and max_len - 1."""
    pp = max_len // ps
    scratch = lanes * pp

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    q = randn(lanes, H, hd)
    kp, vp = randn(scratch + 1, ps, KV, hd), randn(scratch + 1, ps, KV, hd)
    table = torch.from_numpy(rng.permutation(scratch).astype(np.int32)
                             .reshape(lanes, pp)).to(device)
    table[0] = scratch
    dense_k = kp[table.long()].flatten(1, 2).clone()
    dense_v = vp[table.long()].flatten(1, 2).clone()
    pos = rng.integers(0, max_len, lanes).astype(np.int32)
    pos[0], pos[1] = 0, max_len - 1
    return (q, kp, vp, table, torch.from_numpy(pos).to(device), dense_k,
            dense_v)


@pytest.mark.parametrize("shape", SHAPES, ids=["g1", "g4", "g7", "gemma2"])
def test_plain_version_is_decode_attention_over_the_pages(shape):
    H, KV, hd, cap, window = shape
    kw = dict(scale=hd ** -0.5, attn_cap=cap, window=window)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        q, kp, vp, table, pos, dk, dv = _paged(rng, 6, H, KV, hd, 4, 32)
        want = decode_attention(q[:, None], dk, dv, pos, **kw)[:, 0]
        got = pa.paged_decode_attention(q, kp, vp, table, pos, **kw)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got, want)
        assert torch.equal(
            pa.paged_decode_attention(q, dk, dv, None, pos, **kw), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    q, kp, vp, table, pos, dk, dv = _paged(rng, 3, 4, 2, 8, 4, 16)
    kw = dict(scale=0.5, attn_cap=None, window=None)
    before = pa.KERNEL.launches
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, kp, vp, table, pos.long(), **kw)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, kp, vp, table.long(), pos, **kw)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.half(), kp.half(), vp.half(), table,
                                  pos, **kw)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, kp.double(), vp, table, pos, **kw)
    with pytest.raises(ValueError):      # 3 query heads over 2 KV heads
        pa.paged_decode_attention(q[:, :3].contiguous(), kp, vp, table, pos,
                                  **kw)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp[:, :2], table, pos, **kw)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, table[:2], pos, **kw)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, table, pos[:2], **kw)
    with pytest.raises(ValueError):      # a contiguous cache: a page a lane
        pa.paged_decode_attention(q, kp, vp, None, pos, **kw)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), kp, vp, table, pos, **kw)
    pa.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert pa.KERNEL.launches == before          # the CPU launches nothing


@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_9b"])
def test_a_step_given_a_page_table_is_the_plain_step(arch):
    """A decode step over page pools and a :class:`PageTable` (the paged
    tick's form) against the plain step over the same values in a dense
    cache: the logits bitwise, and the new token written to its page."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    lanes, max_len, ps = 4, 32, 8
    pp, pages = max_len // ps, lanes * (max_len // ps) + 1
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (lanes, 1))
                           .astype(np.int32))
    pos = torch.tensor([0, 5, 17, 31], dtype=torch.int32)
    table = torch.from_numpy(rng.permutation(pages - 1).astype(np.int32)
                             .reshape(lanes, pp))
    caches = init_cache(cfg, lanes, max_len, device="cpu")
    pools = {}
    for name, c in caches.items():
        c.copy_(torch.from_numpy(rng.standard_normal(c.shape).astype(
            np.float32)).to(c.dtype))
        pools[name] = torch.zeros((c.shape[0], pages, ps, *c.shape[3:]),
                                  dtype=c.dtype)
        pools[name][:, table.long()] = c.unflatten(2, (pp, ps))
    rows = (table[torch.arange(lanes), (pos // ps).long()].long() * ps
            + (pos % ps).long())
    want, plain = decode_step(params, caches, tok, pos, cfg)
    got, paged = decode_step(params, {**pools, PAGES: PageTable(table, rows)},
                             tok, pos, cfg)
    assert torch.equal(got, want)
    for name in plain:
        assert torch.equal(paged[name][:, table.long()].flatten(2, 3),
                           plain[name])


def _flash(q, dk, dv, pos, chunk, **kw):
    """The same attention summed in another order, as the kernel does:
    flash-decode's partials over ``chunk``-slot slices, merged."""
    n = dk.shape[1] // chunk
    parts = [decode_partials(q[:, None], dk[:, c * chunk:(c + 1) * chunk],
                             dv[:, c * chunk:(c + 1) * chunk], pos,
                             k_offset=c * chunk, **kw) for c in range(n)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    out = merge_partials(m, l, o,
                         lambda t, op: t.amax(0) if op == "max" else t.sum(0))
    B, _, KV, G, hd = out.shape[0], 1, out.shape[1], out.shape[2], \
        out.shape[-1]
    return out.reshape(B, KV * G, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["g1", "g4", "g7", "gemma2"])
def test_the_bound_holds_another_sum_order_and_rejects_planted_faults(
        shape, dtype):
    """``paged_attention.tolerance``: the attention summed in another order
    (flash-decode's chunked partials, as the kernel sums) lies within it;
    each of ``paged_attention.planted_faults`` lies outside it."""
    H, KV, hd, cap, window = shape
    kw = dict(scale=hd ** -0.5, attn_cap=cap, window=window)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        q, kp, vp, table, pos, dk, dv = _paged(rng, 6, H, KV, hd, 4, 32,
                                               dtype=dtype)
        bound = pa.tolerance(q, kp, vp, table, pos, **kw)
        want = pa.paged_decode_attention_ref(q, kp, vp, table, pos, **kw)
        other = _flash(q, dk, dv, pos, 8, **kw)
        assert not torch.equal(other, want) or dtype == torch.bfloat16
        assert bool(((other.float() - want.float()).abs() <= bound).all())
        for name, fpos, fkw in pa.planted_faults(pos, 32, kw):
            faulted = pa.paged_decode_attention_ref(q, kp, vp, table, fpos,
                                                    **fkw)
            err = (faulted.float() - want.float()).abs()
            assert not bool((err <= bound).all()), name


# ---------------------------------------------------------------------------
# the tick with K / V read in place
# ---------------------------------------------------------------------------

def _arch(arch):
    """(config, parameters) of a smoke config ("dense": the serving tests'
    four-head model), built once."""
    if arch not in _CACHE:
        cfg = (CFG if arch == "dense" else deepseek_v2_lite.smoke()
               if arch == "deepseek_v2_lite" else get_smoke_config(arch))
        _CACHE[arch] = cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    return _CACHE[arch]


def _requests(rng, vocab, n):
    return [(rng.integers(1, vocab, int(rng.choice(CHUNKABLE)))
             .astype(np.int32), int(rng.integers(1, 9))) for _ in range(n)]


def _drain(eng, reqs, order, move_at=()):
    """Admit ``reqs`` in ``order`` (FIFO, queueing on a refusal), tick and
    retire until all are out; before the ticks in ``move_at`` the lowest
    active slot is snapshot, dropped and restored (on other pages).
    Returns the outputs and the ticks taken."""
    pending, slot_req, out, taken, it = list(order), {}, {}, 0, 0
    while len(out) < len(reqs):
        while pending:
            slot = eng.admit(*reqs[pending[0]])
            if slot is None:
                break
            slot_req[slot] = pending.pop(0)
        active = eng.paged.active_slots()
        if it in move_at and active:
            snap = eng.snapshot_pages(active[0])
            req = slot_req.pop(active[0])
            eng.retire(active[0])
            slot_req[eng.restore_pages(snap)] = req
        taken += bool(eng.decode_tick())
        for slot in eng.finished_slots():
            out[slot_req.pop(slot)] = eng.retire(slot)
        it += 1
        assert it < 10_000, "paged drain did not converge"
    return out, taken


@pytest.mark.parametrize("arch", ["dense", "gemma2_9b", "jamba_v0_1_52b",
                                  "yi_34b"])
def test_in_place_tick_is_the_dense_generate(arch):
    """The card's tick (graphed, K / V read from the pages) on the plain
    version: at four lanes, random admission orders and pool sizes that
    force queueing and page reuse, and a slot moved mid-decode, every
    request is bitwise the dense ``generate``; one paged tick a tick."""
    cfg, params = _arch(arch)
    oracle = ServeEngine(cfg, params, max_len=32, lanes=4)
    for seed in range(3):
        rng = np.random.default_rng(200 + seed)
        reqs = _requests(rng, cfg.vocab_size, 5)
        eng = ServeEngine(cfg, params, max_len=32, lanes=4)
        max_batch = int(rng.integers(2, 5))
        rt = eng.start_paged(max_batch=max_batch, page_size=8,
                             num_pages=int(rng.choice([4, 8,
                                                       4 * max_batch])))
        assert rt._kv_in_place is False              # the CPU
        rt._set_paths(True)
        assert rt._kv_in_place and rt._graphed
        out, taken = _drain(eng, reqs, rng.permutation(len(reqs)).tolist(),
                            move_at={2})
        for i, (p, nt) in enumerate(reqs):
            np.testing.assert_array_equal(out[i],
                                          oracle.generate(p[None], nt)[0])
        assert rt.tick_kv["paged"] == taken == rt.tick_graph["replays"]
        assert rt.pool.allocated == rt.pool.freed


@pytest.mark.parametrize("arch", ["deepseek_7b", "falcon_mamba_7b",
                                  "deepseek_v2_lite"])
def test_tick_kv_counts_paged_ticks_where_k_and_v_are_cached(arch):
    """``tick_kv`` and one ``tick.kv`` counter a tick: the cumulative
    ``paged`` ticks (each tick of a model caching ``k`` / ``v``, on the
    card's paths; none for the state and latent caches, none on the CPU's
    own paths), the tick's ``live_slots`` (its active lanes' positions +
    1) and ``slots`` (lanes x max_len)."""
    cfg, params = _arch(arch)
    kv = arch == "deepseek_7b"
    for card_paths in (False, True):
        tr = Tracer()
        eng = ServeEngine(cfg, params, max_len=32, lanes=4, tracer=tr)
        rt = eng.start_paged(max_batch=3, page_size=8)
        rt._set_paths(card_paths)
        assert rt._kv_in_place == (card_paths and kv)
        rng = np.random.default_rng(7)
        for prompt, _ in _requests(rng, cfg.vocab_size, 2):
            eng.admit(prompt, 6)
        live, ticks = [], 0
        while rt.active_slots():
            live.append(sum(rt.slots[s].write_pos + 1
                            for s in rt.active_slots()))
            eng.decode_tick()
            ticks += 1
        counters = [e.args for e in tr.events() if e.name == "tick.kv"]
        assert all(e.ph == "C" for e in tr.events() if e.name == "tick.kv")
        paged = list(range(1, ticks + 1)) if card_paths and kv \
            else [0] * ticks
        assert counters == [{"paged": n, "live_slots": s, "slots": 4 * 32}
                            for n, s in zip(paged, live)]
        assert rt.tick_kv == counters[-1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


# (H, KV, hd, dtype, page size, max_len, soft cap, window): deepseek-7b's
# widths, gemma2-9b's global and local layers, a G of 7, float32
CARD_SHAPES = {
    "deepseek-7b": (32, 32, 128, torch.bfloat16, 16, 2048, None, None),
    "gemma2-global": (16, 8, 256, torch.bfloat16, 16, 4608, 50.0, None),
    "gemma2-local": (16, 8, 256, torch.bfloat16, 16, 4608, 50.0, 4096),
    "g7": (56, 8, 128, torch.bfloat16, 16, 1024, None, None),
    "f32": (32, 32, 128, torch.float32, 16, 2048, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_kernel_is_its_plain_version_and_row_invariant_on_the_card(card,
                                                                   name):
    """Against the plain version (the pages gathered, float32 einsums) on
    the same card tensors, element by element within
    ``paged_attention.tolerance`` (stated in its docstring before any run:
    two spacings of the output's dtype at the element's size, plus the
    float32 sums' ``(live slots + hd) · 2^-23 · Σ p|v|``); the kernel given
    the operands of each planted fault (a lane's last slot one past or
    short, the window one wider or narrower, the soft cap before the scale)
    lies outside it.  Bitwise: each lane alone, among rolled batch-mates,
    from a contiguous cache of the same values, and from a CUDA graph's
    replay."""
    H, KV, hd, dt, ps, max_len, cap, window = CARD_SHAPES[name]
    kw = dict(scale=hd ** -0.5, attn_cap=cap, window=window)
    rng = np.random.default_rng(29)
    q, kp, vp, table, pos, dk, dv = _paged(rng, 8, H, KV, hd, ps, max_len,
                                           dtype=dt, device=card)
    got = pa.paged_decode_attention(q, kp, vp, table, pos, **kw)
    want = pa.paged_decode_attention_ref(q, kp, vp, table, pos, **kw)
    bound = pa.tolerance(q, kp, vp, table, pos, **kw)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    for fault, fpos, fkw in pa.planted_faults(pos, max_len, kw):
        faulted = pa.paged_decode_attention(q, kp, vp, table, fpos, **fkw)
        err = (faulted.float() - want.float()).abs()
        assert not bool((err <= bound).all()), fault
    for b in range(8):
        alone = pa.paged_decode_attention(q[b:b + 1], kp, vp, table[b:b + 1],
                                          pos[b:b + 1], **kw)
        assert torch.equal(alone, got[b:b + 1])
    roll = [torch.roll(t, 3, 0) for t in (q, table, pos)]
    assert torch.equal(pa.paged_decode_attention(roll[0], kp, vp, roll[1],
                                                 roll[2], **kw),
                       torch.roll(got, 3, 0))
    assert torch.equal(pa.paged_decode_attention(q, dk, dv, None, pos, **kw),
                       got)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = pa.paged_decode_attention(q, kp, vp, table, pos, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)


def _card_model(arch, dtype):
    cfg = get_smoke_config(arch).with_(param_dtype=dtype, compute_dtype=dtype)
    return cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_9b"])
def test_kernel_gives_the_plain_paths_greedy_tokens_on_the_card(card, arch):
    """float32 smoke models: the engine's ``generate`` (the kernel) and the
    same engine under ``plain_decode_attention`` make the same tokens."""
    cfg, params = _card_model(arch, "float32")
    eng = ServeEngine(cfg, params, max_len=64, lanes=4)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, (3, 12)).astype(np.int32)
    before = pa.KERNEL.launches
    with plain_decode_attention():
        plain = eng.generate(prompts, 40)
    assert pa.KERNEL.launches == before
    np.testing.assert_array_equal(eng.generate(prompts, 40), plain)
    assert pa.KERNEL.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_9b",
                                  "jamba_v0_1_52b"])
def test_paged_tick_is_the_dense_generate_on_the_card(card, arch, dtype):
    """The card's own paths (graphed, K / V read in place) against the
    dense ``generate``, both through the kernel: every request bitwise,
    with queueing, page reuse and a slot moved mid-decode (float32: a
    page snapshot is numpy, which has no bfloat16)."""
    cfg, params = _card_model(arch, dtype)
    oracle = ServeEngine(cfg, params, max_len=64, lanes=4)
    rng = np.random.default_rng(29)
    reqs = [(rng.integers(1, cfg.vocab_size, int(rng.choice(CHUNKABLE)))
             .astype(np.int32), int(rng.integers(6, 40))) for _ in range(12)]
    eng = ServeEngine(cfg, params, max_len=64, lanes=4)
    rt = eng.start_paged(max_batch=4, page_size=8, num_pages=20)
    assert rt._kv_in_place and rt._graphed
    out, taken = _drain(eng, reqs, range(len(reqs)),
                        move_at={5, 17} if dtype == "float32" else ())
    for i, (p, nt) in enumerate(reqs):
        np.testing.assert_array_equal(out[i], oracle.generate(p[None], nt)[0])
    assert rt.tick_kv["paged"] == taken == rt.tick_graph["replays"]

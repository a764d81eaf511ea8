"""Attention blocks: GQA (local/global windows, softcap, qk-norm) and MLA.

Counterpart of ``repro.models.attention``.

* Prefill attention is *chunked* with an online-softmax accumulator (the
  flash-attention recurrence in plain PyTorch): a loop over query chunks,
  and inside it over the causally reachable key chunks only.  Local-window
  layers (Gemma-2) also lower-bound the key-chunk loop.
* Decode attends one query against the whole cache, ``Smax`` slots, with a
  scalar position or one position per row.  On the card, GQA decode runs
  ``kernels.paged_decode_attention`` (the hand-written kernel, which reads
  each row's slots only up to its position) in place of
  :func:`decode_attention`; on the CPU and on ``meta`` stand-ins it runs
  :func:`decode_attention`, the kernel's plain version.  The cache's device
  decides, nothing else (:func:`plain_decode_attention` excepted, the
  yardstick the kernel is held against on the card).  A contiguous cache
  reads as one page a row; given a :class:`PageTable` under the caches'
  ``"pages"`` key (the paged tick's, ``serve/paging.py``), the caches are
  the page pools themselves: the new token is written to its page and the
  pages are read in place.
* MLA (DeepSeek-V2) caches only the compressed latent (``kv_lora_rank`` +
  the RoPE dims).  Prefill expands it to per-head K / V and runs the
  chunked attention; decode folds ``w_uk`` into the query, attends in the
  latent space and applies ``w_uv`` after.  A config carrying a YaRN
  ``rope_scaling`` (DeepSeek-V2-Lite) rotates the RoPE dims at YaRN's
  frequencies and scales the softmax by its ``mscale²``, in prefill and
  decode alike.

Scores, softmax and the value sum are explicit ``einsum`` / ``softmax`` in
float32 with the reference's ``NEG`` mask: masked slots get ``NEG`` before
the softmax, so ``exp`` makes them exactly 0 whatever (finite) stale values
the cache holds there.  That keeps a row's result independent of the other
rows and of the cache beyond its position, which the paged serving path
relies on (``serve/paging.py``).  The ``x @ W`` projections are plain
``torch.matmul``.  Cache writes are in place: the caller's cache tensors
hold the new token after a decode step.

Under a mesh policy (``repro_torch.dist``) the parameters are ``DTensor``s
and the ``attn_heads`` / ``attn_kv`` hints lay q, k and v out, by default
with their heads over ``model``, as the reference's do.  The attention
core (the cache writes at per-row positions, the masked softmax) has no
``DTensor`` sharding rule; it runs on each rank's local shards
(``dist.hints.local_call``) in a layout per argument, so every layout of
the dry run's variants (``experiments/port/hillclimb.py``) computes the
meshless function:

* prefill / train: q as ``attn_heads`` says (heads, or query positions,
  over ``model``), K / V whole along the sequence with q's head split; a
  rank's queries sit at a global offset, which the causal mask and the
  window use.  The cache is filled in its own layout.
* decode: in the cache's layout (one query position cannot split).  A
  cache split on its sequence (flash-decode) has each rank attend its key
  slice; the slices' softmax partials are combined by log-sum-exp, with
  collectives over the ranks inside the core.

Without a policy every hint and ``local_call`` is an identity.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.hints import (checkpointed, current_policy, is_dtensor,
                                    local_call, reduce_over, shard_hint,
                                    shard_offset, split_over, whole_along)
from repro_torch.dist.sharding import P, placements_for, spec_of
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_ref)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, apply_rope_yarn,
                                       dense_init, dtype_of, param, rms_norm,
                                       softcap, yarn_scales)

NEG = -2.3e38  # practical -inf for f32 masking


# The caches' key of a decode step's PageTable.
PAGES = "pages"


class PageTable(NamedTuple):
    """A decode step's caches ``k`` / ``v`` are page pools (L, pages,
    page_size, KV, hd): ``table`` (lanes, pages_per_lane) int32 holds the
    lanes' page ids, ``rows`` (lanes,) int64 the pool row (``page *
    page_size + slot``) each lane's new token goes to."""

    table: torch.Tensor
    rows: torch.Tensor


_plain_decode = False


@contextlib.contextmanager
def plain_decode_attention():
    """Within it, GQA decode attention runs its plain version on every
    device: :func:`decode_attention` (a paged step: the pages gathered,
    then :func:`decode_attention`).  The yardstick the card's kernel is held
    against, and the path a count of a step's torch ops on the card must
    take to equal the count on ``meta`` stand-ins (the kernel is one launch
    that torch does not see)."""
    global _plain_decode
    prev, _plain_decode = _plain_decode, True
    try:
        yield
    finally:
        _plain_decode = prev


def _kernel_decodes(cache: torch.Tensor) -> bool:
    """Whether GQA decode attention over ``cache`` runs the kernel: on the
    card, outside :func:`plain_decode_attention`."""
    return cache.device.type == "cuda" and not _plain_decode


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache tensor (the ``ShapeDtypeStruct`` of the
    reference)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class GQAttention(nn.Module):
    """``wq`` / ``wk`` / ``wv`` / ``wo``, plus f32 ``q_norm`` / ``k_norm``
    with qk-norm (Chameleon)."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = param(dense_init((D, H * hd), dt, generator, device))
        self.wk = param(dense_init((D, KV * hd), dt, generator, device))
        self.wv = param(dense_init((D, KV * hd), dt, generator, device))
        self.wo = param(dense_init((H * hd, D), dt, generator, device))
        if cfg.qk_norm:
            self.q_norm = param(torch.zeros(hd, dtype=torch.float32,
                                            device=device))
            self.k_norm = param(torch.zeros(hd, dtype=torch.float32,
                                            device=device))


def init_gqa_params(cfg: ModelConfig, *, generator, device) -> GQAttention:
    return GQAttention(cfg, generator=generator, device=device)


def _qk_chunk_scores(qc_, kc_, scale, cap):
    """qc_: (B,Q,N,G,d) scores against kc_: (B,K,N,d), in f32."""
    s = torch.einsum("bqngd,bknd->bngqk", qc_.to(torch.float32),
                     kc_.to(torch.float32)) * scale
    return softcap(s, cap) if cap is not None else s


def _q_block(qblk, k, v, start: int, lo: int, hi: int, *, kc: int,
             scale: float, attn_cap: float | None,
             window: int | None) -> torch.Tensor:
    """The query block (B,qc,KV,G,d) whose first query sits at global
    position ``start``, against key chunks ``lo`` .. ``hi - 1`` →
    (B,qc,KV,G,dv)."""
    B, qc, KV, G, _ = qblk.shape
    dv = v.shape[-1]
    dev = qblk.device
    qpos = start + torch.arange(qc, device=dev)
    m = torch.full((B, KV, G, qc), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, qc, dv), dtype=torch.float32, device=dev)
    for j in range(lo, hi):
        kblk = k[:, j * kc:(j + 1) * kc]
        vblk = v[:, j * kc:(j + 1) * kc]
        s = _qk_chunk_scores(qblk, kblk, scale, attn_cap)      # (B,KV,G,qc,kc)
        kpos = j * kc + torch.arange(kc, device=dev)
        mask = kpos[None, :] <= qpos[:, None]                  # causal
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))               # (B,KV,G,qc)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bngqk,bknd->bngqd", p, vblk.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]           # (B,KV,G,qc,dv)
    return out.permute(0, 3, 1, 2, 4)                          # (B,qc,KV,G,dv)


def chunked_causal_attention(
    q: torch.Tensor,            # (B, Sq, H, d): queries q_offset .. + Sq
    k: torch.Tensor,            # (B, S, KV, d): the whole sequence
    v: torch.Tensor,            # (B, S, KV, d)
    *,
    scale: float,
    attn_cap: float | None,
    window: int | None,         # None → global causal
    q_chunk: int | None = None,
    kv_chunk: int = 512,
    differentiable: bool = False,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax chunked attention with decoupled q/kv chunk sizes; only
    the causally reachable key chunks (and, with a window, only those inside
    it) are touched.

    The sequence's q blocks are ``q_chunk`` positions long (``S`` for
    ``"full"``).  ``q`` may hold a slice of the sequence's queries, those at
    global positions ``q_offset`` onwards (a rank's share under a
    query-position layout), against every key: each of its blocks then
    sweeps the key chunks its whole q block reaches, and the causal mask
    and the local window use the global positions.  So every rank of such
    a layout does the work of its share of the q block, as GSPMD's
    partition of the block does.

    The loop is differentiable as it stands.  The reference's
    ``differentiable=True`` sweeps every key chunk of a global layer under
    the mask instead (its reachable-only loop has a dynamic bound that does
    not reverse-differentiate); a fully masked chunk adds exactly zero to
    the online softmax, so both compute the same function.  What the port
    keeps of that flag is the reference's per-q-block remat: with it, and
    gradients on, each q block is recomputed in the backward
    (``torch.utils.checkpoint``), so the backward holds one block row of
    probabilities at a time.  ``q_chunk`` defaults to the policy's
    ``__attn_q_chunk__`` (``"full"``: one q block), else 512."""
    B, Sq, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    if q_chunk is None:
        q_chunk = (current_policy() or {}).get("__attn_q_chunk__", 512)
        if q_chunk == "full":
            q_chunk = S
    qcg = min(q_chunk, S)          # the sequence's q block
    qc = min(qcg, Sq)              # this call's q block
    kc = min(kv_chunk, S)
    if S % qcg or S % kc or Sq % qc or q_offset % qc:
        raise ValueError(f"sequence length {S} (queries {q_offset} .. "
                         f"{q_offset + Sq}) must be a multiple of the "
                         f"chunks ({qcg}, {kc})")
    qs = q.reshape(B, Sq // qc, qc, KV, G, d)
    remat = differentiable and torch.is_grad_enabled()
    kw = dict(kc=kc, scale=scale, attn_cap=attn_cap, window=window)
    outs = []
    for i in range(Sq // qc):
        start = q_offset + i * qc
        b0 = start // qcg * qcg    # the sequence's q block holding it
        lo = 0 if window is None else max(0, (b0 - window) // kc)
        hi = (b0 + qcg + kc - 1) // kc
        if remat:
            outs.append(checkpointed(_q_block, qs[:, i], k, v, start, lo,
                                     hi, **kw))
        else:
            outs.append(_q_block(qs[:, i], k, v, start, lo, hi, **kw))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, dv)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (B, 1, H, d)
    k_cache: torch.Tensor,      # (B, Smax, KV, d)
    v_cache: torch.Tensor,      # (B, Smax, KV, d)
    pos,                        # int / () tensor shared, or (B,) one per row
    *,
    scale: float,
    attn_cap: float | None,
    window: int | None,
) -> torch.Tensor:
    """One-query attention against the cache.

    ``pos`` is the position of the token being decoded (the slots ``<= pos``
    are valid): one shared position for lockstep batched decode, or a
    ``(B,)`` vector for continuous batching, where every row sits at its own
    position.  Rows are independent either way.
    """
    B, _, H, d = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, d)
    s = _qk_chunk_scores(qg, k_cache, scale, attn_cap)         # (B,KV,G,1,Smax)
    kpos = torch.arange(Smax, device=q.device)
    rows = torch.as_tensor(pos, device=q.device).reshape(-1)   # (1,) or (B,)
    mask = kpos[None, :] <= rows[:, None]
    if window is not None:
        mask &= (rows[:, None] - kpos[None, :]) < window
    s = torch.where(mask[:, None, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, d).to(q.dtype)


def decode_partials(
    q: torch.Tensor,            # (B, 1, H, d)
    k_cache: torch.Tensor,      # (B, Sl, KV, d): global slots k_offset ..
    v_cache: torch.Tensor,      # (B, Sl, KV, d)
    pos,
    *,
    k_offset: int,
    scale: float,
    attn_cap: float | None,
    window: int | None,
):
    """Flash-decode's share of one key slice: :func:`decode_attention`'s
    scores on the slots ``k_offset`` .. ``k_offset + Sl - 1`` (masked by
    their global positions), as the softmax partials ``(m, l, o)``: the row
    max (B,KV,G,1), the sum of ``exp(s - m)`` (B,KV,G,1) and the
    unnormalised value sum (B,KV,G,1,d).  :func:`merge_partials` combines
    the slices' partials into the attention over all of them."""
    B, _, H, d = q.shape
    Sl, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, d)
    s = _qk_chunk_scores(qg, k_cache, scale, attn_cap)         # (B,KV,G,1,Sl)
    mask = _slot_mask(pos, k_offset, Sl, window, q.device)     # (1|B, Sl)
    m, p, l = _partial_softmax(s, mask[:, None, None, None, :])
    o = torch.einsum("bngqk,bknd->bngqd", p, v_cache.to(torch.float32))
    return m, l, o


def merge_partials(m, l, o, reduce) -> torch.Tensor:
    """The attention of several key slices from their softmax partials
    (:func:`decode_partials`): the log-sum-exp combine ``M = max m``,
    ``o = Σ o·e^(m-M) / Σ l·e^(m-M)``.  ``reduce(t, op)`` reduces over the
    slices with ``op`` "max" or "sum": over a stacked leading dim, or an
    all-reduce over the ranks that hold them (``dist.hints.reduce_over``).
    A slice whose slots are all masked has ``l = o = 0`` and adds
    nothing."""
    M = reduce(m, "max")
    w = torch.exp(m - M)
    den = reduce(l * w, "sum")
    num = reduce(o * w[..., None], "sum")
    return num / den[..., None]


def _slot_mask(pos, offset: int, n: int, window, device) -> torch.Tensor:
    """(1|B, n): the slots ``offset`` .. ``offset + n - 1`` a decode row at
    ``pos`` attends to."""
    kpos = offset + torch.arange(n, device=device)
    rows = torch.as_tensor(pos, device=device).reshape(-1)
    mask = kpos[None, :] <= rows[:, None]
    if window is not None:
        mask &= (rows[:, None] - kpos[None, :]) < window
    return mask


def _partial_softmax(s, mask):
    """``(m, p, l)`` of scores ``s`` over their last dim under ``mask``:
    the row max (last dim dropped), ``exp(s - m)`` with masked slots
    exactly 0, and its row sum."""
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return m, p, p.sum(dim=-1)


def _write_token(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write each row's (B, ...) token at its position, in place."""
    B = cache.shape[0]
    p = torch.as_tensor(pos, device=cache.device).reshape(-1).expand(B)
    cache[torch.arange(B, device=cache.device), p] = new.to(cache.dtype)


def _write_owned(cache: torch.Tensor, new: torch.Tensor, pos,
                 offset: int) -> None:
    """:func:`_write_token` into a cache shard holding the global slots
    ``offset`` .. ``offset + Sl - 1``: only the rows whose position falls
    in it write."""
    B, Sl = cache.shape[:2]
    p = torch.as_tensor(pos, device=cache.device).reshape(-1).expand(B)
    local = p - offset
    own = ((local >= 0) & (local < Sl)).reshape(B, *[1] * (new.dim() - 1))
    rows = torch.arange(B, device=cache.device)
    idx = local.clamp(0, Sl - 1)
    cache[rows, idx] = torch.where(own, new.to(cache.dtype), cache[rows, idx])


def _whole_seq(spec):
    """``spec`` with its sequence dim (dim 1) unsplit."""
    return P(*(None if d == 1 else e for d, e in enumerate(spec)))


def _fill_cache(news, caches, S: int) -> None:
    """Prefill: write each new (B, S, ...) tensor into the first S slots of
    its cache, in place and in the cache's own layout (a rank writes the
    slots of its shard), whatever layout the attention ran in."""
    ref = caches[0]
    cspec = spec_of(ref)
    offset = shard_offset(ref, 1)

    def fill(*t):
        n = len(t) // 2
        for new, cache in zip(t[:n], t[n:]):
            hi = min(S, offset + cache.shape[1])
            if hi > offset:
                cache[:, :hi - offset] = new[:, offset:hi].to(cache.dtype)

    specs = ((_whole_seq(cspec),) * len(news) + (cspec,) * len(caches)
             if len(cspec) else (P(),) * (len(news) + len(caches)))
    local_call(fill, tuple(news) + tuple(caches), specs, None)


def _heads_view(t, n: int):
    """(B, S, n·d) projection output → (B, S, n, d).  Its flat columns may
    split over the model axis at a point that is not a head boundary (a
    layout that leaves the heads unsplit runs the unpadded model, whose
    head count the axis need not divide): they are gathered first, since
    a ``DTensor`` cannot unflatten an uneven split."""
    if is_dtensor(t):
        k = math.prod(t.device_mesh.size(i) for i, p in
                      enumerate(t.placements)
                      if p.is_shard() and p.dim == t.ndim - 1)
        if n % k:
            t = whole_along(t, -1)
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)


def gqa_block(
    params: GQAttention,
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    *,
    window: int | None,
    positions: torch.Tensor,      # (S,) or (B, 1)
    cache: dict | None = None,    # {'k': (B,Smax,KV,d), 'v': ...}, in place
    decode_pos=None,
    differentiable: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    one = (1,) if decode_pos is not None else ()
    q = shard_hint(_heads_view(x @ params.wq, H), "attn_heads", whole=one)
    k = shard_hint(_heads_view(x @ params.wk, KV), "attn_heads", whole=one)
    v = shard_hint(_heads_view(x @ params.wv, KV), "attn_heads", whole=one)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kw = dict(scale=hd ** -0.5, attn_cap=cfg.attn_softcap, window=window)

    if decode_pos is not None:
        if cache is None or S != 1:
            raise ValueError("decode takes one token a row and a cache")
        pages = cache.get(PAGES)
        if pages is not None:
            out = _paged_decode(q, k, v, cache["k"], cache["v"], pages,
                                decode_pos, kw)
        else:
            out = _gqa_decode(q, k, v, cache["k"], cache["v"], decode_pos, kw)
    else:
        # gathering K / V once here replaces a gather a key chunk
        k = shard_hint(k, "attn_kv")
        v = shard_hint(v, "attn_kv")
        heads = _heads_spec()
        # q as the policy lays it out (heads, or query positions, over
        # model); K / V whole along the sequence, heads split as q's
        q_off = shard_offset(q, 1, heads)

        def core(q, k, v):
            return chunked_causal_attention(q, k, v, q_offset=q_off,
                                            differentiable=differentiable,
                                            **kw)

        kv = _whole_seq(heads)
        out = local_call(core, (q, k, v), (heads, kv, kv), heads)
        if cache is not None:     # prefill: fill the cache's first S slots
            _fill_cache((k, v), (cache["k"], cache["v"]), S)
    y = _out_proj(out, params.wo)
    return y, cache


def _paged_decode(q, k, v, k_pool, v_pool, pages: PageTable, pos, kw):
    """One decode step's attention read from the page pools in place: each
    lane's new K / V written to its pool row (``pages.rows``; scratch lanes
    all write the scratch page), then the kernel over the lanes' pages up
    to their positions (``pos``, int32 (lanes,)); off the card the pages
    gathered and :func:`decode_attention`."""
    for pool, new in ((k_pool, k), (v_pool, v)):
        pool.view(-1, *pool.shape[2:])[pages.rows] = new[:, 0].to(pool.dtype)
    attend = (paged_decode_attention if _kernel_decodes(k_pool)
              else paged_decode_attention_ref)
    return attend(q[:, 0], k_pool, v_pool, pages.table, pos, **kw)[:, None]


def _gqa_decode(q, k, v, ck, cv, pos, kw):
    """One decode step's attention in the cache's layout: q and the new
    K / V take the cache's batch and head split (one query position cannot
    split, so a query-position policy runs on the cache's heads, as GSPMD
    partitions it).  A cache split on its sequence (flash-decode) has each
    rank write the token only where it owns the slot and attend its key
    slice; the slices' softmax partials are combined over the ranks
    (:func:`merge_partials`: one all-reduce max and two all-reduce sums of
    (B, H, 1)- and (B, H, d)-sized partials a layer, inside the core).
    Unsplit, it is :func:`decode_attention` on local heads, on the card
    ``paged_decode_attention`` over the cache as one page a row."""
    cspec = spec_of(ck)
    qspec = _whole_seq(cspec) if len(cspec) else P()
    seq = split_over(ck, 1)
    if not seq:
        def core(q, k, v, ck, cv):
            _write_token(ck, k[:, 0], pos)
            _write_token(cv, v[:, 0], pos)
            if not _kernel_decodes(ck):
                return decode_attention(q, ck, cv, pos, **kw)
            lane_pos = torch.as_tensor(pos, dtype=torch.int32,
                                       device=q.device)
            lane_pos = lane_pos.reshape(-1).expand(q.shape[0]).contiguous()
            return paged_decode_attention(q[:, 0], ck, cv, None, lane_pos,
                                          **kw)[:, None]
    else:
        offset = shard_offset(ck, 1)

        def core(q, k, v, ck, cv):
            _write_owned(ck, k[:, 0], pos, offset)
            _write_owned(cv, v[:, 0], pos, offset)
            m, l, o = decode_partials(q, ck, cv, pos, k_offset=offset, **kw)
            out = merge_partials(m, l, o,
                                 lambda t, op: reduce_over(t, op, seq))
            B, KV, G, _, d = out.shape
            return out.permute(0, 3, 1, 2, 4).reshape(B, 1, KV * G,
                                                      d).to(q.dtype)

    return local_call(core, (q, k, v, ck, cv), (qspec,) * 3 + (cspec,) * 2,
                      qspec)


def _out_proj(out, wo):
    """The attention output (B, S, H, dv) through the row-parallel ``wo``,
    its heads flattened and laid out as ``wo``'s rows are (the sequence
    whole): the layout a head-split core leaves it in.  A query-position
    core's output takes one redistribution here; left S-split, DTensor
    would compute ``wo``'s gradient whole on every rank of the model
    axis (its strategy weighs collectives, not compute)."""
    B, S = out.shape[:2]
    flat = out.reshape(B, S, -1)
    if is_dtensor(flat) and is_dtensor(wo):
        mesh = flat.device_mesh
        spec = P(spec_of(flat)[0], None, spec_of(wo)[0])
        flat = flat.redistribute(mesh, placements_for(mesh, spec, 3))
    return flat @ wo


def _heads_spec():
    """The policy's head layout (``attn_heads``), the layout the attention
    core runs in on local heads; replicated without one."""
    return (current_policy() or {}).get("attn_heads") or P()


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    dt = dtype_of(cfg.compute_dtype)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": CacheSpec(shape, dt), "v": CacheSpec(shape, dt)}


# ===========================================================================
# MLA (DeepSeek-V2)
# ===========================================================================

class MLAttention(nn.Module):
    """The latent projections ``w_dkv`` (+ f32 ``kv_norm``), ``w_kr``,
    ``w_uk`` / ``w_uv`` (kv_lora, H, ·) and ``wo``; queries through
    ``w_dq`` / f32 ``q_norm`` / ``w_uq`` with a q LoRA, else ``wq``."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, H, R = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
        nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        vd = cfg.v_head_dim

        def dense(shape):
            return param(dense_init(shape, dt, generator, device))

        self.w_dkv = dense((D, R))
        self.kv_norm = param(torch.zeros(R, dtype=torch.float32,
                                         device=device))
        self.w_kr = dense((D, rope_d))
        self.w_uk = dense((R, H, nope))
        self.w_uv = dense((R, H, vd))
        self.wo = dense((H * vd, D))
        if cfg.q_lora_rank > 0:
            self.w_dq = dense((D, cfg.q_lora_rank))
            self.q_norm = param(torch.zeros(cfg.q_lora_rank,
                                            dtype=torch.float32,
                                            device=device))
            self.w_uq = dense((cfg.q_lora_rank, H, nope + rope_d))
        else:
            self.wq = dense((D, H, nope + rope_d))


def init_mla_params(cfg: ModelConfig, *, generator, device) -> MLAttention:
    return MLAttention(cfg, generator=generator, device=device)


def _mla_queries(params: MLAttention, x, cfg: ModelConfig, positions, *,
                 whole=()):
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank > 0:
        cq = rms_norm(x @ params.w_dq, params.q_norm, cfg.norm_eps)
        q = torch.einsum("bsr,rhd->bshd", cq, params.w_uq)
    else:
        q = torch.einsum("bsd,dhe->bshe", x, params.wq)
    q = shard_hint(q, "attn_heads", whole=whole)
    return q[..., :nope], _mla_rope(q[..., nope:], positions, cfg)


def _mla_rope(x, positions, cfg: ModelConfig):
    """MLA's rotary dims: YaRN where the config carries a ``rope_scaling``
    (``configs/deepseek_v2_lite.py``), else :func:`apply_rope` as it is."""
    s = getattr(cfg, "rope_scaling", None)
    if s is None:
        return apply_rope(x, positions, cfg.rope_theta)
    return apply_rope_yarn(x, positions, cfg.rope_theta, s)


def _mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale: ``(nope + rope)^-0.5``, times YaRN's ``mscale²``
    under a ``rope_scaling`` (DeepSeek-V2's attention temperature)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    s = getattr(cfg, "rope_scaling", None)
    return scale if s is None else scale * yarn_scales(s)[1]


def mla_block(
    params: MLAttention,
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,      # (S,) or (B, 1)
    cache: dict | None = None,    # {'ckv': (B,Smax,R), 'kr': (B,Smax,rope)}
    decode_pos=None,
    differentiable: bool = False,
    **_unused,
) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    H, vd = cfg.num_heads, cfg.v_head_dim
    rope_d = cfg.qk_rope_head_dim
    scale = _mla_scale(cfg)
    f32 = torch.float32

    one = (1,) if decode_pos is not None else ()
    q_nope, q_rope = _mla_queries(params, x, cfg, positions, whole=one)
    ckv = rms_norm(x @ params.w_dkv, params.kv_norm, cfg.norm_eps)  # (B,S,R)
    kr = _mla_rope((x @ params.w_kr)[:, :, None, :], positions,
                   cfg)[:, :, 0, :]                             # (B,S,rope)

    heads = _heads_spec()
    if decode_pos is not None:
        if cache is None or S != 1:
            raise ValueError("decode takes one token a row and a cache")
        # the latent cache has no head dim: q keeps the policy's head split
        # (none under a query-position policy, whose one query cannot
        # split: every rank then runs every head, as GSPMD's partition
        # does) and the cache's batch split
        cspec = spec_of(cache["ckv"])
        b_ax = cspec[0] if len(cspec) else None
        h_ax = heads[2] if len(heads) > 2 else None
        qspec, up = P(b_ax, None, h_ax, None), P(None, h_ax, None)
        lat = P(b_ax, None, None)
        seq = split_over(cache["ckv"], 1)
        offset = shard_offset(cache["ckv"], 1)

        def core(q_nope, q_rope, ckv, kr, ckv_c, kr_c, w_uk, w_uv):
            if seq:
                _write_owned(ckv_c, ckv[:, 0], decode_pos, offset)
                _write_owned(kr_c, kr[:, 0], decode_pos, offset)
            else:
                _write_token(ckv_c, ckv[:, 0], decode_pos)
                _write_token(kr_c, kr[:, 0], decode_pos)
            # absorbed decode: w_uk folds into q, the attention runs over
            # the latent cache, w_uv applies after
            q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
            s = (torch.einsum("bshr,btr->bhst", q_abs.to(f32), ckv_c.to(f32))
                 + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                                kr_c.to(f32))) * scale
            mask = _slot_mask(decode_pos, offset, ckv_c.shape[1], None,
                              ckv_c.device)[:, None, None, :]
            if seq:
                # flash-decode: this rank's key slice, combined over the
                # ranks by log-sum-exp (see _gqa_decode)
                m, p, l = _partial_softmax(s, mask)            # (B,H,1)
                o = torch.einsum("bhst,btr->bhsr", p, ckv_c.to(f32))
                o_lat = merge_partials(
                    m, l, o, lambda t, op: reduce_over(t, op, seq)
                ).permute(0, 2, 1, 3)                          # (B,1,H,R)
            else:
                s = torch.where(mask, s, NEG)
                p = torch.softmax(s, dim=-1)
                o_lat = torch.einsum("bhst,btr->bshr", p, ckv_c.to(f32))
            return torch.einsum("bshr,rhd->bshd", o_lat.to(x.dtype), w_uv)

        out = local_call(core, (q_nope, q_rope, ckv, kr, cache["ckv"],
                                cache["kr"], params.w_uk, params.w_uv),
                         (qspec, qspec, lat, lat, cspec, cspec, up, up),
                         qspec)
    else:
        # prefill: expand to per-head K / V and run the chunked attention,
        # q as the policy lays it out, K / V whole along the sequence
        k_nope = shard_hint(torch.einsum("bsr,rhd->bshd", ckv, params.w_uk),
                            "attn_heads")
        v = shard_hint(torch.einsum("bsr,rhd->bshd", ckv, params.w_uv),
                       "attn_heads")
        kv = _whole_seq(heads)
        lat = P(heads[0], None, None) if len(heads) else P()
        q_off = shard_offset(q_nope, 1, heads)

        def core(q_nope, q_rope, k_nope, v, kr):
            k = torch.cat([k_nope, kr[:, :, None, :].expand(
                *k_nope.shape[:3], rope_d)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            return chunked_causal_attention(q, k, v, scale=scale,
                                            attn_cap=None, window=None,
                                            differentiable=differentiable,
                                            q_offset=q_off)

        out = local_call(core, (q_nope, q_rope, k_nope, v, kr),
                         (heads, heads, kv, kv, lat), heads)
        if cache is not None:     # prefill: fill the cache's first S slots
            _fill_cache((ckv, kr), (cache["ckv"], cache["kr"]), S)
    y = _out_proj(out, params.wo)
    return y, cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    dt = dtype_of(cfg.compute_dtype)
    return {"ckv": CacheSpec((batch, max_len, cfg.kv_lora_rank), dt),
            "kr": CacheSpec((batch, max_len, cfg.qk_rope_head_dim), dt)}

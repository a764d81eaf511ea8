"""Attention blocks: GQA (local/global windows, softcap, qk-norm) and MLA.

Counterpart of ``repro.models.attention``.

* Prefill attention is *chunked* with an online-softmax accumulator (the
  flash-attention recurrence in plain PyTorch): a loop over query chunks,
  and inside it over the causally reachable key chunks only.  Local-window
  layers (Gemma-2) also lower-bound the key-chunk loop.
* Decode attends one query against the whole cache, ``Smax`` slots, with a
  scalar position or one position per row.
* MLA (DeepSeek-V2) caches only the compressed latent (``kv_lora_rank`` +
  the RoPE dims).  Prefill expands it to per-head K / V and runs the
  chunked attention; decode folds ``w_uk`` into the query, attends in the
  latent space and applies ``w_uv`` after.

Scores, softmax and the value sum are explicit ``einsum`` / ``softmax`` in
float32 with the reference's ``NEG`` mask: masked slots get ``NEG`` before
the softmax, so ``exp`` makes them exactly 0 whatever (finite) stale values
the cache holds there.  That keeps a row's result independent of the other
rows and of the cache beyond its position, which the paged serving path
relies on (``serve/paging.py``).  The ``x @ W`` projections are plain
``torch.matmul``.  Cache writes are in place: the caller's cache tensors
hold the new token after a decode step.

Under a mesh policy (``repro_torch.dist``) the parameters are ``DTensor``s
and the ``attn_heads`` / ``attn_kv`` hints lay q, k and v out with their
heads over ``model``, as the reference's do.  The attention core (the
cache writes at per-row positions, the masked softmax) has no ``DTensor``
sharding rule; it is independent per head, so it runs on each rank's
local heads (``dist.hints.local_call``) and writes the rank's shard of
the head-sharded cache in place.  Without a policy every hint and
``local_call`` is an identity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.hints import current_policy, local_call, shard_hint
from repro_torch.dist.sharding import P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, dtype_of, param,
                                       rms_norm, softcap)

NEG = -2.3e38  # practical -inf for f32 masking


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


def _q_block(qblk, k, v, i: int, *, qc: int, kc: int, scale: float,
             attn_cap: float | None, window: int | None) -> torch.Tensor:
    """Query block ``i`` (B,qc,KV,G,d) against its reachable key chunks →
    (B,qc,KV,G,dv)."""
    B, _, KV, G, _ = qblk.shape
    dv = v.shape[-1]
    dev = qblk.device
    qpos = i * qc + torch.arange(qc, device=dev)
    m = torch.full((B, KV, G, qc), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, qc, dv), dtype=torch.float32, device=dev)
    lo = 0 if window is None else max(0, (i * qc - window) // kc)
    hi = ((i + 1) * qc + kc - 1) // kc
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
    q: torch.Tensor,            # (B, S, H, d)
    k: torch.Tensor,            # (B, S, KV, d)
    v: torch.Tensor,            # (B, S, KV, d)
    *,
    scale: float,
    attn_cap: float | None,
    window: int | None,         # None → global causal
    q_chunk: int | None = None,
    kv_chunk: int = 512,
    differentiable: bool = False,
) -> torch.Tensor:
    """Online-softmax chunked attention with decoupled q/kv chunk sizes; only
    the causally reachable key chunks (and, with a window, only those inside
    it) are touched.

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
    B, S, H, d = q.shape
    KV = k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    if q_chunk is None:
        q_chunk = (current_policy() or {}).get("__attn_q_chunk__", 512)
        if q_chunk == "full":
            q_chunk = S
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    if S % qc or S % kc:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"chunks ({qc}, {kc})")
    qs = q.reshape(B, S // qc, qc, KV, G, d)
    remat = differentiable and torch.is_grad_enabled()
    kw = dict(qc=qc, kc=kc, scale=scale, attn_cap=attn_cap, window=window)
    outs = []
    for i in range(S // qc):
        if remat:
            outs.append(checkpoint(_q_block, qs[:, i], k, v, i,
                                   use_reentrant=False, **kw))
        else:
            outs.append(_q_block(qs[:, i], k, v, i, **kw))
    out = torch.cat(outs, dim=1).reshape(B, S, H, dv)
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


def _write_token(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write each row's (B, ...) token at its position, in place."""
    B = cache.shape[0]
    p = torch.as_tensor(pos, device=cache.device).reshape(-1).expand(B)
    cache[torch.arange(B, device=cache.device), p] = new.to(cache.dtype)


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
    q = shard_hint((x @ params.wq).reshape(B, S, H, hd), "attn_heads")
    k = shard_hint((x @ params.wk).reshape(B, S, KV, hd), "attn_heads")
    v = shard_hint((x @ params.wv).reshape(B, S, KV, hd), "attn_heads")
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = hd ** -0.5
    heads = _heads_spec()

    if decode_pos is not None:
        if cache is None or S != 1:
            raise ValueError("decode takes one token a row and a cache")

        def core(q, k, v, ck, cv):
            _write_token(ck, k[:, 0], decode_pos)
            _write_token(cv, v[:, 0], decode_pos)
            return decode_attention(q, ck, cv, decode_pos, scale=scale,
                                    attn_cap=cfg.attn_softcap, window=window)

        out = local_call(core, (q, k, v, cache["k"], cache["v"]),
                         (heads,) * 5, heads)
    else:
        # gathering K / V once here replaces a gather a key chunk
        k = shard_hint(k, "attn_kv")
        v = shard_hint(v, "attn_kv")

        def core(q, k, v, *cache_kv):
            out = chunked_causal_attention(q, k, v, scale=scale,
                                           attn_cap=cfg.attn_softcap,
                                           window=window,
                                           differentiable=differentiable)
            if cache_kv:          # prefill: fill the cache's first S slots
                ck, cv = cache_kv
                ck[:, :S] = k.to(ck.dtype)
                cv[:, :S] = v.to(cv.dtype)
            return out

        args = (q, k, v) + ((cache["k"], cache["v"]) if cache is not None
                            else ())
        out = local_call(core, args, (heads,) * len(args), heads)
    y = out.reshape(B, S, H * hd) @ params.wo
    return y, cache


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


def _mla_queries(params: MLAttention, x, cfg: ModelConfig, positions):
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank > 0:
        cq = rms_norm(x @ params.w_dq, params.q_norm, cfg.norm_eps)
        q = torch.einsum("bsr,rhd->bshd", cq, params.w_uq)
    else:
        q = torch.einsum("bsd,dhe->bshe", x, params.wq)
    q = shard_hint(q, "attn_heads")
    return q[..., :nope], apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)


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
    scale = (cfg.qk_nope_head_dim + rope_d) ** -0.5
    f32 = torch.float32

    q_nope, q_rope = _mla_queries(params, x, cfg, positions)
    ckv = rms_norm(x @ params.w_dkv, params.kv_norm, cfg.norm_eps)  # (B,S,R)
    kr = apply_rope((x @ params.w_kr)[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]                     # (B,S,rope)

    heads = _heads_spec()
    up = P(None, heads[2], None) if len(heads) > 2 else P()  # (R, H, ·)
    if decode_pos is not None:
        if cache is None or S != 1:
            raise ValueError("decode takes one token a row and a cache")

        def core(q_nope, q_rope, ckv, kr, ckv_c, kr_c, w_uk, w_uv):
            _write_token(ckv_c, ckv[:, 0], decode_pos)
            _write_token(kr_c, kr[:, 0], decode_pos)
            # absorbed decode: w_uk folds into q, the attention runs over
            # the latent cache, w_uv applies after
            q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
            s = (torch.einsum("bshr,btr->bhst", q_abs.to(f32), ckv_c.to(f32))
                 + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                                kr_c.to(f32))) * scale
            kpos = torch.arange(ckv_c.shape[1], device=ckv_c.device)
            rows = torch.as_tensor(decode_pos,
                                   device=ckv_c.device).reshape(-1)
            mask = kpos[None, :] <= rows[:, None]              # (1|B, Smax)
            s = torch.where(mask[:, None, None, :], s, NEG)
            p = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhst,btr->bshr", p, ckv_c.to(f32))
            return torch.einsum("bshr,rhd->bshd", o_lat.to(x.dtype), w_uv)

        out = local_call(core, (q_nope, q_rope, ckv, kr, cache["ckv"],
                                cache["kr"], params.w_uk, params.w_uv),
                         (heads, heads, None, None, None, None, up, up),
                         heads)
    else:
        # prefill: expand to per-head K / V and run the chunked attention
        k_nope = shard_hint(torch.einsum("bsr,rhd->bshd", ckv, params.w_uk),
                            "attn_heads")
        v = shard_hint(torch.einsum("bsr,rhd->bshd", ckv, params.w_uv),
                       "attn_heads")

        def core(q_nope, q_rope, k_nope, v, kr, *cache_lat):
            k = torch.cat([k_nope, kr[:, :, None, :].expand(
                *k_nope.shape[:3], rope_d)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            out = chunked_causal_attention(q, k, v, scale=scale,
                                           attn_cap=None, window=None,
                                           differentiable=differentiable)
            if cache_lat:         # prefill: fill the cache's first S slots
                ckv, kr, ckv_c, kr_c = cache_lat
                ckv_c[:, :S] = ckv.to(ckv_c.dtype)
                kr_c[:, :S] = kr.to(kr_c.dtype)
            return out

        args = (q_nope, q_rope, k_nope, v, kr)
        specs = (heads,) * 4 + (None,)
        if cache is not None:
            args += (ckv, kr, cache["ckv"], cache["kr"])
            specs += (None,) * 4
        out = local_call(core, args, specs, heads)
    y = out.reshape(B, S, H * vd) @ params.wo
    return y, cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    dt = dtype_of(cfg.compute_dtype)
    return {"ckv": CacheSpec((batch, max_len, cfg.kv_lora_rank), dt),
            "kr": CacheSpec((batch, max_len, cfg.qk_rope_head_dim), dt)}

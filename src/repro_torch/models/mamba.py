"""Mamba-1 (selective SSM) block: Falcon-Mamba's and Jamba's mamba layers.

Counterpart of ``repro.models.mamba``.  The prefill runs the reference's
two-level chunked scan:

* an outer loop over sequence chunks of ``Q = min(chunk, S)`` positions
  carries the ``(B, d_inner, N)`` float32 boundary state;
* inside a chunk, the affine recurrence ``h_t = decay_t * h_{t-1} + bx_t``
  is scanned over the Q positions.  The reference uses
  ``lax.associative_scan``; PyTorch has none, so this is a Hillis-Steele
  doubling scan of the same combine (``(a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 +
  b2)``): ``ceil(log2 Q)`` vector passes, each composing every position with
  the one ``2**k`` before it.  The associative scan groups the products
  differently, so the two agree to float32 rounding, not bitwise (the
  tests state the bound).

Decode is the one-step recurrence with a rolling conv state.  Falcon-Mamba
RMS-normalizes B, C and Δ (``bcdt_rms``).

Like the reference (``mamba.py:117``), a prefill of S tokens needs ``S <=
chunk`` or ``S % chunk == 0``; other lengths raise.  There is no padding:
the reference has none either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.hints import (current_policy, local_call, shard_hint,
                                    summed)
from repro_torch.dist.sharding import P
from repro_torch.models.attention import CacheSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of, param


def _dt_rank(cfg: ModelConfig) -> int:
    r = cfg.ssm.dt_rank
    return r if r > 0 else -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """``in_proj``, the depthwise conv (``conv_w``, f32 ``conv_b``),
    ``x_proj``, ``dt_proj`` with an f32 ``dt_bias``, the f32 ``A_log`` and
    ``D``, and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        s = cfg.ssm
        D, dI, N = cfg.d_model, s.d_inner, s.d_state
        R = _dt_rank(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = param(dense_init((D, 2 * dI), dt, generator, device))
        self.conv_w = param(dense_init((s.d_conv, dI), dt, generator, device,
                                       scale=0.5))
        self.conv_b = param(torch.zeros(dI, **f32))
        self.x_proj = param(dense_init((dI, R + 2 * N), dt, generator, device))
        self.dt_proj = param(dense_init((R, dI), dt, generator, device))
        self.dt_bias = param(torch.full((dI,), -4.6, **f32))  # softplus ≈ 0.01
        self.A_log = param(torch.log(
            torch.arange(1, N + 1, **f32).expand(dI, N).contiguous()))
        self.D = param(torch.ones(dI, **f32))
        self.out_proj = param(dense_init((dI, D), dt, generator, device))


def init_mamba_params(cfg: ModelConfig, *, generator, device) -> Mamba:
    return Mamba(cfg, generator=generator, device=device)


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x.
    (``torch.nn.functional.softplus`` returns x itself above 20.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv of kernel K as K shifted adds in f32.

    x: (B, S, dI); w: (K, dI); state: (B, K-1, dI), the trailing inputs of
    the previous segment.  Returns (y in x's dtype, new_state)."""
    B, S, dI = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, dI), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)      # (B, S+K-1, dI)
    y = torch.zeros((B, S, dI), dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + S].to(torch.float32) * w[i].to(torch.float32)
    y = y + b
    return y.to(x.dtype), xp[:, -(K - 1):]


def _ssm_inputs(params: Mamba, u: torch.Tensor, cfg: ModelConfig):
    """u: (B, L, dI) → Δ (B, L, dI), B_t (B, L, N), C_t (B, L, N), f32."""
    N = cfg.ssm.d_state
    R = _dt_rank(cfg)
    # the partial sums over d_inner's shards reduced here, once: left to
    # DTensor, the layout of the product with the column-split dt_proj
    # gathers dt_proj whole instead, a full-width product on every rank
    proj = summed((u @ params.x_proj).to(torch.float32))  # (B, L, R+2N)
    dt_r, B_t, C_t = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    if cfg.ssm.bcdt_rms:
        eps = cfg.norm_eps
        dt_r, B_t, C_t = _rms(dt_r, eps), _rms(B_t, eps), _rms(C_t, eps)
    delta = _softplus(dt_r @ params.dt_proj.to(torch.float32)
                      + params.dt_bias)                 # (B, L, dI)
    return delta, B_t, C_t


def _chunk_recurrence(h0: torch.Tensor, decay: torch.Tensor,
                      bx: torch.Tensor) -> torch.Tensor:
    """h0: (B, dI, N); decay / bx: (B, Q, dI, N).  Every h_t, (B, Q, dI, N),
    by a doubling scan over the Q axis (see the module docstring)."""
    a, b = decay, bx
    Q = a.shape[1]
    for k in range(math.ceil(math.log2(Q)) if Q > 1 else 0):
        s = 1 << k
        # position t composes with position t - s, the earlier one first
        a, b = (torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1))
    return a * h0[:, None] + b


def _check_chunkable(S: int, cfg: ModelConfig) -> None:
    """Raise unless a prefill of S tokens splits into the scan's chunks."""
    Q = min(cfg.ssm.chunk, S)
    if S % Q:
        raise ValueError(
            f"{cfg.name}: a Mamba prefill of {S} tokens must be at most the "
            f"scan chunk ({cfg.ssm.chunk}) or a multiple of it, as in the "
            f"reference (S % Q == 0 with S={S}, Q={Q})")


def selective_scan(params: Mamba, u: torch.Tensor, cfg: ModelConfig,
                   h0: torch.Tensor | None = None):
    """u: (B, S, dI) post-conv activations → (y (B, S, dI), h_final).

    The recurrence is independent per row and channel, so on a mesh it
    runs on each rank's rows and d_inner shard (``local_call`` in the
    ``mamba_inner`` layout): its many small elementwise ops skip
    ``DTensor``'s dispatch."""
    S = u.shape[1]
    N = cfg.ssm.d_state
    _check_chunkable(S, cfg)
    Q = min(cfg.ssm.chunk, S)
    A = -torch.exp(params.A_log)                        # (dI, N) f32
    delta, B_t, C_t = _ssm_inputs(params, u, cfg)

    def scan(u, delta, B_t, C_t, A, Dp, *h0):
        uf = u.to(torch.float32)
        h = h0[0] if h0 else torch.zeros((u.shape[0], u.shape[2], N),
                                         dtype=torch.float32, device=u.device)
        ys = []
        for c in range(S // Q):
            sl = slice(c * Q, (c + 1) * Q)
            d_c, b_c, c_c, u_c = (delta[:, sl], B_t[:, sl], C_t[:, sl],
                                  uf[:, sl])
            decay = torch.exp(d_c[..., None] * A)       # (B, Q, dI, N)
            bx = (d_c * u_c)[..., None] * b_c[:, :, None, :]
            hs = _chunk_recurrence(h, decay, bx)
            ys.append(torch.einsum("bqdn,bqn->bqd", hs, c_c))
            h = hs[:, -1]
        y = torch.cat(ys, dim=1) + uf * Dp
        return y.to(u.dtype), h

    inner = (current_policy() or {}).get("mamba_inner") or P()
    b = inner[0] if len(inner) else None
    m = inner[2] if len(inner) > 2 else None
    chan, rows, state = P(b, None, m), P(b, None, None), P(b, m, None)
    args = (u, delta, B_t, C_t, A, params.D) + (() if h0 is None else (h0,))
    specs = (chan, chan, rows, rows, P(m, None), P(m)) + (state,)
    return local_call(scan, args, specs[:len(args)], (chan, state))


def mamba_block(
    params: Mamba,
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    *,
    cache: dict | None = None,    # {'conv': (B,K-1,dI), 'ssm': (B,dI,N)}
    decode_pos=None,
) -> tuple[torch.Tensor, dict | None]:
    """Prefill (``decode_pos`` None) or one decode step.  With a cache, the
    step starts from its state and writes the new state into it in place;
    the position does not enter (a Mamba layer has none)."""
    S = x.shape[1]
    # on a mesh each rank's in_proj columns are its d_inner shard of u then
    # of z (dist.sharding.pad_params), so the split is the rank's own
    inner = (current_policy() or {}).get("mamba_inner") or P()
    u, z = local_call(lambda t: t.chunk(2, dim=-1), (x @ params.in_proj,),
                      (inner,), (inner, inner))
    u = shard_hint(u, "mamba_inner")
    conv_state = cache["conv"] if cache is not None else None
    u_c, new_conv = _causal_conv(u, params.conv_w, params.conv_b, conv_state)
    u_c = F.silu(u_c)
    if decode_pos is not None:
        if cache is None or S != 1:
            raise ValueError("decode takes one token a row and a cache")
        delta, B_t, C_t = _ssm_inputs(params, u_c, cfg)
        A = -torch.exp(params.A_log)
        decay = torch.exp(delta[:, 0, :, None] * A)                 # (B,dI,N)
        bx = (delta[:, 0] * u_c[:, 0].to(torch.float32))[..., None] \
            * B_t[:, 0, None, :]
        h = decay * cache["ssm"] + bx
        y = torch.einsum("bdn,bn->bd", h, C_t[:, 0])[:, None, :]   # (B,1,dI)
        y = (y + u_c.to(torch.float32) * params.D).to(x.dtype)
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, h = selective_scan(params, u_c, cfg, h0)
    if cache is not None:
        # in place on each rank's shard of d_inner (the cache's layout)
        m = inner[2] if len(inner) > 2 else None
        conv_spec, ssm_spec = P(None, None, m), P(None, m, None)
        local_call(lambda c, n: c.copy_(n), (cache["conv"], new_conv),
                   (conv_spec, conv_spec), None)
        local_call(lambda c, n: c.copy_(n), (cache["ssm"], h),
                   (ssm_spec, ssm_spec), None)
    out = (y * F.silu(z)) @ params.out_proj
    return out, cache


def mamba_cache_spec(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    return {"conv": CacheSpec((batch, s.d_conv - 1, s.d_inner),
                              dtype_of(cfg.compute_dtype)),
            "ssm": CacheSpec((batch, s.d_inner, s.d_state), torch.float32)}

"""Mixture-of-Experts with GShard-style grouped capacity dispatch, shared
experts and an optional dense residual branch (Arctic).

Counterpart of ``repro.models.moe`` on one device:

1. the tokens reshape to ``(G, T_l, D)``; top-k routing, the
   position-in-expert prefix sums and the capacity drop all happen within a
   group;
2. each group scatters its tokens into an ``(E*C + 1, D)`` buffer whose last
   row takes the dropped tokens;
3. the experts run a batched SwiGLU over their ``G*C`` rows;
4. the rows return to their groups and combine, in float32, with the
   renormalized router probabilities (a dropped token's weight is 0).

Under a mesh policy (``repro_torch.dist``) the hint sites lay the group
and expert-row tensors out as the policy says, and dispatch and combine run
on each rank's local groups (``dist.hints.local_call`` over the group dim,
the counterpart of the reference's ``_maybe_shard_map``): the capacity
scatter and gather have no ``DTensor`` rule, and every group is
independent.  The policy's ``__moe_groups__`` sets the group count; without
one it is ``_num_groups``.  Without a policy every hint is an identity and
the local functions run as they are.

**Capacity makes a token's output depend on its neighbours.**  An expert
takes ``C = capacity_for(cfg, T_l)`` tokens a group, at least 4.  At decode
a group is the tick's lanes (padded lanes included), and a token picks an
expert at most once, so with 4 lanes or fewer no token is ever dropped;
with more lanes a token can be dropped because its batch-mates chose the
same expert first, exactly as in the reference's buckets.  The semantics
are the reference's, unchanged.

Routing ties: ``jax.lax.top_k`` puts the lower expert index first among
equal probabilities; ``torch.topk`` promises no order, so the experts are
ranked by a stable descending sort instead.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.hints import current_policy, local_call, shard_hint
from repro_torch.dist.sharding import P
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn_block, init_ffn_params
from repro_torch.models.layers import dense_init, dtype_of, param


class Experts(nn.Module):
    """The stacked expert SwiGLUs: ``w_gate`` / ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        m = cfg.moe
        E, D, Fd = m.num_experts, cfg.d_model, m.expert_d_ff
        self.w_gate = param(dense_init((E, D, Fd), dt, generator, device))
        self.w_up = param(dense_init((E, D, Fd), dt, generator, device))
        self.w_down = param(dense_init((E, Fd, D), dt, generator, device))


class MoE(nn.Module):
    """f32 ``router`` (D, E), ``experts``, and the optional ``shared``
    experts' and ``dense`` residual's FFNs."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        m = cfg.moe
        self.router = param(dense_init((cfg.d_model, m.num_experts),
                                       torch.float32, generator, device,
                                       scale=0.02))
        self.experts = Experts(cfg, generator=generator, device=device)
        if m.num_shared_experts > 0:
            self.shared = init_ffn_params(
                cfg, generator=generator, device=device,
                d_ff=m.shared_d_ff or m.expert_d_ff * m.num_shared_experts)
        if m.dense_residual:
            self.dense = init_ffn_params(
                cfg, generator=generator, device=device,
                d_ff=m.dense_residual_d_ff or cfg.d_ff)


def init_moe_params(cfg: ModelConfig, *, generator, device) -> MoE:
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    return MoE(cfg, generator=generator, device=device)


def _num_groups(T: int) -> int:
    """Group count: the largest power of two <= min(T // 8, 256), so a
    group holds at least 8 tokens (the reference's fallback without a
    mesh policy)."""
    g = 1
    while g * 2 <= min(T // 8, 256):
        g *= 2
    return g


def _group_count(T: int) -> int:
    """The policy's ``__moe_groups__`` when it divides the tokens (the
    count for which the (B, S, D) → (G, T_l, D) regroup splits at existing
    shard boundaries), else :func:`_num_groups`."""
    g = (current_policy() or {}).get("__moe_groups__")
    if g and T % g == 0:
        return g
    return _num_groups(T)


def _group_specs():
    """(G, ·, ·) and (K, G, T_l) layouts of the dispatch: the policy's
    ``moe_groups`` group axes, replicated without it."""
    gspec = (current_policy() or {}).get("moe_groups")
    if gspec is None:
        return P(), P()
    return P(gspec[0], None, None), P(None, gspec[0], None)


def capacity_for(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * tokens_per_group * m.top_k / m.num_experts)
    return max(4, c)


def _route(params: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """xt (G, T_l, D) → (router logits f32 (G, T_l, E), probabilities,
    renormalized gates (G, T_l, K), expert ids (G, T_l, K))."""
    K = cfg.moe.top_k
    # the product in the tokens' dtype, accumulated in f32 (the reference's
    # preferred_element_type): bf16 values are exact in f32
    logits = xt.to(torch.float32) @ \
        params.router.to(xt.dtype).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :K], expert_ids[..., :K]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    return logits, probs, gate_vals, expert_ids


def moe_block(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) → (out (B, S, D), metrics {aux_loss, z_loss,
    expert_load}), the load-balance and z losses (f32 scalars) and the
    tokens each expert kept (f32 (E,))."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    G = _group_count(T)
    Tl = T // G
    C = capacity_for(cfg, Tl)

    xt = shard_hint(x.reshape(G, Tl, D), "moe_groups")
    g3, kg = _group_specs()

    def route(xt, router):
        out = _route(SimpleNamespace(router=router), xt, cfg)
        return (*out, F.one_hot(out[3][..., 0], E).to(torch.float32))

    logits, probs, gate_vals, expert_ids, first = local_call(
        route, (xt, params.router), (g3, P()), (g3,) * 5)
    logits = shard_hint(logits, "moe_logits")

    # load-balance and z losses (Switch / GShard)
    me = probs.mean(dim=(0, 1))
    ce = first.mean(dim=(0, 1))
    aux_loss = m.router_aux_weight * E * (me * ce).sum()
    z_loss = m.router_z_weight * torch.logsumexp(logits, dim=-1) \
        .square().mean()

    def dispatch(xt, expert_ids):
        """Per-group capacity dispatch into (g, E*C + 1, D), row E*C taking
        the drops → (buf, dests (K, g, Tl), keeps (K, g, Tl), the tokens
        each expert kept (g, E))."""
        g, dev = xt.shape[0], xt.device
        buf = torch.zeros((g, E * C + 1, D), dtype=xt.dtype, device=dev)
        grows = torch.arange(g, device=dev)[:, None]
        counts = torch.zeros((g, E), dtype=torch.int64, device=dev)
        kept = torch.zeros((g, E), dtype=torch.int64, device=dev)
        dests, keeps = [], []
        for k in range(K):
            ids_k = expert_ids[..., k]                             # (g, Tl)
            onehot = F.one_hot(ids_k, E)                           # (g,Tl,E)
            pos_k = onehot.cumsum(dim=1) - onehot                  # exclusive
            pos = pos_k.gather(2, ids_k[..., None])[..., 0] \
                + counts.gather(1, ids_k)
            keep = pos < C
            dest = torch.where(keep, ids_k * C + pos, E * C)
            buf[grows, dest] = xt
            dests.append(dest)
            keeps.append(keep)
            counts = torch.clamp_max(counts + onehot.sum(dim=1), C)
            kept = kept + (onehot * keep[..., None]).sum(dim=1)
        return buf, torch.stack(dests), torch.stack(keeps), kept

    def combine(flat, dests, keeps, gate_vals):
        """(g, E*C + 1, D) expert rows back to (g, Tl, D), in f32, weighted
        by the renormalized gates (a dropped token's weight is 0)."""
        g, dev = flat.shape[0], flat.device
        grows = torch.arange(g, device=dev)[:, None]
        combined = torch.zeros((g, Tl, D), dtype=torch.float32, device=dev)
        for k in range(K):
            wk = (gate_vals[..., k] * keeps[k]).to(torch.float32)
            picked = flat[grows, dests[k]]                         # (g,Tl,D)
            combined = combined + picked.to(torch.float32) * wk[..., None]
        return combined

    buf, dests, keeps, kept = local_call(dispatch, (xt, expert_ids),
                                         (g3, g3), (g3, kg, kg, g3))
    total_kept = kept.sum(dim=0)

    # expert-major rows (E, G*C, D) → batched SwiGLU
    rows = buf[:, :E * C].reshape(G, E, C, D).transpose(0, 1)
    rows = shard_hint(rows, "moe_rows4")
    rows = shard_hint(rows.reshape(E, G * C, D), "moe_rows")
    w = params.experts
    h = F.silu(torch.bmm(rows, w.w_gate)) * torch.bmm(rows, w.w_up)
    expert_out = shard_hint(torch.bmm(h, w.w_down), "moe_rows")   # (E, R, D)

    # back to groups, plus the zero row the drops read; combine in f32
    back = shard_hint(expert_out.reshape(E, G, C, D).transpose(0, 1),
                      "moe_groups4")
    flat = torch.cat([back.reshape(G, E * C, D),
                      torch.zeros((G, 1, D), dtype=back.dtype,
                                  device=back.device)], dim=1)
    combined = local_call(combine, (flat, dests, keeps, gate_vals),
                          (g3, kg, kg, g3), g3)

    out = combined.to(x.dtype).reshape(B, S, D)
    # shared experts / dense residual run on the layer-boundary layout
    if hasattr(params, "shared") or hasattr(params, "dense"):
        xb = shard_hint(x, "layer_boundary")
        out = shard_hint(out, "layer_boundary")
        if hasattr(params, "shared"):
            out = out + ffn_block(params.shared, xb, cfg)
        if hasattr(params, "dense"):
            out = out + ffn_block(params.dense, xb, cfg)
    metrics = {"aux_loss": aux_loss, "z_loss": z_loss,
               "expert_load": total_kept.to(torch.float32)}
    return out, metrics

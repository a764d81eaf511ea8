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

The reference wraps dispatch and combine in ``shard_map`` over the group
dim when a mesh policy is installed (``_maybe_shard_map``) and lets the
policy set the group count (``__moe_groups__``).  Neither exists here until
the port has ``dist/`` (ROADMAP queue 1, item 11): without a mesh the
reference runs the local functions as they are and takes the group count
from ``_num_groups``, which is what this module does.

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

import torch
import torch.nn.functional as F
from torch import nn

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
    G = _num_groups(T)
    Tl = T // G
    C = capacity_for(cfg, Tl)
    dev = x.device

    xt = x.reshape(G, Tl, D)
    logits, probs, gate_vals, expert_ids = _route(params, xt, cfg)

    # load-balance and z losses (Switch / GShard)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_ids[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux_loss = m.router_aux_weight * E * (me * ce).sum()
    z_loss = m.router_z_weight * torch.logsumexp(logits, dim=-1) \
        .square().mean()

    # per-group capacity dispatch into (G, E*C + 1, D); row E*C: the drops
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    grows = torch.arange(G, device=dev)[:, None]
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    dests, keeps = [], []
    total_kept = torch.zeros(E, dtype=torch.int64, device=dev)
    for k in range(K):
        ids_k = expert_ids[..., k]                                 # (G, Tl)
        onehot = F.one_hot(ids_k, E)                               # (G,Tl,E)
        pos_k = onehot.cumsum(dim=1) - onehot                      # exclusive
        pos = pos_k.gather(2, ids_k[..., None])[..., 0] \
            + counts.gather(1, ids_k)
        keep = pos < C
        dest = torch.where(keep, ids_k * C + pos, E * C)
        buf[grows, dest] = xt
        dests.append(dest)
        keeps.append(keep)
        counts = torch.clamp_max(counts + onehot.sum(dim=1), C)
        total_kept = total_kept + (onehot * keep[..., None]).sum(dim=(0, 1))

    # expert-major rows (E, G*C, D) → batched SwiGLU
    rows = buf[:, :E * C].reshape(G, E, C, D).transpose(0, 1) \
        .reshape(E, G * C, D)
    w = params.experts
    h = F.silu(torch.bmm(rows, w.w_gate)) * torch.bmm(rows, w.w_up)
    expert_out = torch.bmm(h, w.w_down)                            # (E, R, D)

    # back to groups, plus the zero row the drops read; combine in f32
    back = expert_out.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    flat = torch.cat([back, torch.zeros((G, 1, D), dtype=back.dtype,
                                        device=dev)], dim=1)
    combined = torch.zeros((G, Tl, D), dtype=torch.float32, device=dev)
    for k in range(K):
        wk = (gate_vals[..., k] * keeps[k]).to(torch.float32)
        picked = flat[grows, dests[k]]                             # (G,Tl,D)
        combined = combined + picked.to(torch.float32) * wk[..., None]

    out = combined.to(x.dtype).reshape(B, S, D)
    if hasattr(params, "shared"):
        out = out + ffn_block(params.shared, x, cfg)
    if hasattr(params, "dense"):
        out = out + ffn_block(params.dense, x, cfg)
    metrics = {"aux_loss": aux_loss, "z_loss": z_loss,
               "expert_load": total_kept.to(torch.float32)}
    return out, metrics

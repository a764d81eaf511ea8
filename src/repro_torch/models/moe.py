"""Mixture-of-Experts with GShard-style grouped capacity dispatch, or
dropless, shared experts and an optional dense residual branch (Arctic).

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

**Dropless** (``moe.capacity_factor`` None; DeepSeek-V2-Lite, as the
published model serves): no capacity and no groups.  The ``T·top_k``
(token, expert) pairs are sorted by expert and the experts' SwiGLU runs on
the routed rows only, as one grouped product over the experts whose
per-expert row offsets stay on the device (no host sync, so a graphed tick
captures it): ``torch._grouped_mm`` for bfloat16 on the card, elsewhere
each row against its own expert's weights.  The rows come back to their
(token, k) places and combine in float32 in k order.  The gates are the
top-k softmax probabilities, renormalised only where the config's
``norm_topk_prob`` says so (a builder's field; default True), times its
``routed_scaling_factor`` (default 1).  No token is dropped, so a token's
output depends on its batch-mates only through the grouped product's row
placement: bitwise not at all for the row-by-row product, and on the card
only as far as the grouped GEMM's rows are computed alike wherever they
sit (PERF.md, PR 28).  Meshes run the capacity path only.

Routing ties: ``jax.lax.top_k`` puts the lower expert index first among
equal probabilities; ``torch.topk`` promises no order, so the experts are
ranked by a stable descending sort instead.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.hints import (current_policy, local_call, shard_hint,
                                    sharding_policy)
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


# the hint sites that lay out the group dim, and that dim's entry in each
_GROUP_DIM = {"moe_groups": 0, "moe_groups4": 0, "moe_logits": 0,
              "moe_rows": 1, "moe_rows4": 1}


def _group_shards(pol: dict) -> tuple[int, tuple]:
    """(ranks, axes) the policy splits the group dim over: the product of
    the mesh sizes of the axes its ``moe_groups`` (else ``moe_rows4``)
    layout names for that dim."""
    mesh = pol.get("__mesh__")
    spec = pol.get("moe_groups") or pol.get("moe_rows4")
    if mesh is None or spec is None:
        return 1, ()
    entry = spec[_GROUP_DIM["moe_groups" if "moe_groups" in pol
                           else "moe_rows4"]]
    axes = entry if isinstance(entry, tuple) else (entry,)
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n, axes


def _group_layout(T: int) -> tuple[int, dict | None]:
    """(G, policy): the group count and, where the group dim cannot split
    over the ranks the policy puts it on, the policy to run the block
    under instead.

    G is the policy's ``__moe_groups__`` when it divides the tokens (the
    count for which the (B, S, D) → (G, T_l, D) regroup splits at existing
    shard boundaries), else :func:`_num_groups`, raised to a multiple of
    the group dim's ranks when the tokens allow it (GSPMD pads a group dim
    its ranks do not divide; a whole group a rank is the same work).  When
    they do not (fewer tokens than ranks: a batch of one over a data axis),
    the group dim is kept whole on every rank, which is the work a rank
    does on GSPMD's padded dim too: the returned policy drops its axes from
    the group dims' layouts.  So does a single group."""
    pol = current_policy() or {}
    g = pol.get("__moe_groups__")
    if g and T % g == 0:
        return g, None
    g = _num_groups(T)
    n, axes = _group_shards(pol)
    if not axes or (g > 1 and g % n == 0):
        return g, None
    g2 = math.lcm(g, n)
    if g2 > 1 and T % g2 == 0:
        return g2, None
    # a group dim of one cannot be split (DTensor will not view a sharded
    # singleton dim away, even over a mesh dim of one)

    def drop(spec, dim):
        entry = spec[dim]
        kept = tuple(a for a in (entry if isinstance(entry, tuple)
                                 else (entry,)) if a not in axes)
        out = list(spec)
        out[dim] = kept if len(kept) > 1 else (kept[0] if kept else None)
        return P(*out)

    return g, {k: (drop(v, _GROUP_DIM[k]) if k in _GROUP_DIM else v)
               for k, v in pol.items()}


def _group_specs():
    """(G, ·, ·) and (K, G, T_l) layouts of the dispatch: the group axes of
    the policy's ``moe_groups`` or, without it, of ``moe_rows4`` (the
    batch's: the groups are the batch's rows regrouped, so each rank
    routes its own tokens); replicated without either."""
    pol = current_policy() or {}
    if pol.get("moe_groups") is not None:
        g = pol["moe_groups"][0]
    elif pol.get("moe_rows4") is not None:
        g = pol["moe_rows4"][1]
    else:
        return P(), P()
    return P(g, None, None), P(None, g, None)


def capacity_for(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * tokens_per_group * m.top_k / m.num_experts)
    return max(4, c)


def _top_k(router: torch.Tensor, xt: torch.Tensor, K: int):
    """xt (..., D) → (router logits f32 (..., E), probabilities, the top-K
    probabilities (..., K), their expert ids (..., K))."""
    # the product in the tokens' dtype, accumulated in f32 (the reference's
    # preferred_element_type): bf16 values are exact in f32
    logits = xt.to(torch.float32) @ router.to(xt.dtype).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    return logits, probs, gate_vals[..., :K], expert_ids[..., :K]


def _renormalized(gates: torch.Tensor) -> torch.Tensor:
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)


def _route(params: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """xt (G, T_l, D) → (router logits f32 (G, T_l, E), probabilities,
    renormalized gates (G, T_l, K), expert ids (G, T_l, K))."""
    logits, probs, gates, ids = _top_k(params.router, xt, cfg.moe.top_k)
    return logits, probs, _renormalized(gates), ids


def moe_block(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) → (out (B, S, D), metrics {aux_loss, z_loss,
    expert_load}), the load-balance and z losses (f32 scalars) and the
    tokens each expert kept (f32 (E,))."""
    if dropless(cfg):
        return _dropless(params, x, cfg)
    B, S, _ = x.shape
    G, whole = _group_layout(B * S)
    if whole is not None:
        with sharding_policy(whole):
            return _moe(params, x, cfg, G)
    return _moe(params, x, cfg, G)


def _moe(params: MoE, x: torch.Tensor, cfg: ModelConfig, G: int
         ) -> tuple[torch.Tensor, dict]:
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
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


# ---------------------------------------------------------------------------
# dropless routing
# ---------------------------------------------------------------------------

_ROUTES = contextvars.ContextVar("moe_routes", default=None)


def dropless(cfg: ModelConfig) -> bool:
    """Whether the config's MoE layers run without capacity."""
    return cfg.moe is not None and cfg.moe.capacity_factor is None


@contextlib.contextmanager
def recording_routes():
    """Collect, in layer order, the (T, top_k) expert ids of every dropless
    MoE layer run inside the block (the served path counts the experts a
    tick or a prefill read from them)."""
    log = []
    token = _ROUTES.set(log)
    try:
        yield log
    finally:
        _ROUTES.reset(token)


def distinct_experts(routes: list, live: torch.Tensor | None,
                     num_experts: int) -> torch.Tensor:
    """The experts the ``live`` rows (bool (T,); all where None) of each
    recorded layer routed to, counted once a layer and summed over the
    layers: an int32 scalar on the routes' device."""
    ids = torch.stack(routes)                                # (L, T, K)
    if live is not None:                 # dead rows' picks to a spare column
        ids = torch.where(live[None, :, None], ids, num_experts)
    hit = torch.zeros((ids.shape[0], num_experts + 1), dtype=torch.int32,
                      device=ids.device)
    hit.scatter_(1, ids.flatten(1), 1)
    return hit[:, :num_experts].sum().to(torch.int32)


def route_dropless(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """xt (T, D) → (router logits f32 (T, E), probabilities, gates f32
    (T, K), expert ids (T, K)): the top-k by a stable descending sort, the
    gates renormalised only under ``norm_topk_prob``, times
    ``routed_scaling_factor``."""
    logits, probs, gates, ids = _top_k(router, xt, cfg.moe.top_k)
    if getattr(cfg, "norm_topk_prob", True):
        gates = _renormalized(gates)
    scale = getattr(cfg, "routed_scaling_factor", 1.0)
    return logits, probs, gates * scale, ids


def grouped_swiglu(xs: torch.Tensor, ids: torch.Tensor, offs: torch.Tensor,
                   w: Experts) -> torch.Tensor:
    """The experts' SwiGLU of rows sorted by expert: ``xs`` (N, D), their
    expert ids ``ids`` (N,) and the end offsets of each expert's rows
    ``offs`` (E,) int32 → (N, D).  bfloat16 on the card: three grouped
    GEMMs over the device offsets.  Elsewhere (the CPU, float32) each row
    is a product of its own against its expert's weights, so no row's
    result depends on the others."""
    if xs.is_cuda and xs.dtype == torch.bfloat16:
        h = F.silu(torch._grouped_mm(xs, w.w_gate, offs=offs)) * \
            torch._grouped_mm(xs, w.w_up, offs=offs)
        return torch._grouped_mm(h, w.w_down, offs=offs)
    rows = xs[:, None]
    h = F.silu(torch.bmm(rows, w.w_gate[ids])) * torch.bmm(rows, w.w_up[ids])
    return torch.bmm(h, w.w_down[ids])[:, 0]


def _dropless(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, dict]:
    """:func:`moe_block` without capacity (the module docstring)."""
    if current_policy():
        raise NotImplementedError(f"{cfg.name}: dropless MoE runs without "
                                  f"a mesh policy only")
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    xt = x.reshape(B * S, D)
    logits, probs, gates, ids = route_dropless(params.router, xt, cfg)
    log = _ROUTES.get()
    if log is not None:
        log.append(ids)

    flat = ids.reshape(-1)                                   # (T·K,)
    sorted_ids, order = torch.sort(flat, stable=True)
    counts = F.one_hot(flat, E).sum(dim=0)                   # (E,)
    offs = counts.cumsum(0).to(torch.int32)
    ys = grouped_swiglu(xt[order // K], sorted_ids, offs, params.experts)
    y = torch.empty_like(ys)
    y[order] = ys                                            # (token, k) order
    y = y.view(B * S, K, D)
    combined = torch.zeros((B * S, D), dtype=torch.float32, device=x.device)
    for k in range(K):
        combined = combined + y[:, k].to(torch.float32) * gates[:, k, None]
    out = combined.to(x.dtype).reshape(B, S, D)
    if hasattr(params, "shared"):
        out = out + ffn_block(params.shared, x, cfg)
    if hasattr(params, "dense"):
        out = out + ffn_block(params.dense, x, cfg)

    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0], E).to(torch.float32).mean(dim=0)
    aux_loss = m.router_aux_weight * E * (me * ce).sum()
    z_loss = m.router_z_weight * torch.logsumexp(logits, dim=-1) \
        .square().mean()
    return out, {"aux_loss": aux_loss, "z_loss": z_loss,
                 "expert_load": counts.to(torch.float32)}

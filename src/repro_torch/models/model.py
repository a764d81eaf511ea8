"""Model entry points: init, forward, loss, prefill, decode.

Counterpart of ``repro.models.model``.  The parameters are one
:class:`Transformer` module: ``embed``, ``final_norm`` (f32), ``lm_head``
(unless the embeddings are tied) and ``layers``, the sub-layers in layer
order.  The caches are one tensor per leaf name, stacked over the layers
that have the leaf (``models/transformer.py``): ``{"k": (L_attn, B, Smax,
KV, hd), "v": ...}``, MLA's ``ckv`` / ``kr`` ``(L_attn, B, Smax, ·)``,
Mamba's ``conv`` ``(L_mamba, B, K-1, d_inner)`` and ``ssm`` ``(L_mamba, B,
d_inner, N)`` in f32; the steps write them in place.

Entry points take the parameters first, as the reference's do; the module's
own ``forward`` is the same function.  ``init_params`` runs on the card
unless the caller names another device.

The parameters are made without gradients (``layers.param``), so serving
builds no graphs; a trainer turns them on for its own model.  ``loss_fn``
is the training objective: the chunked cross-entropy plus the MoE layers'
auxiliary and z losses.  The reference's ``_embed_lookup`` custom VJP only
keeps the embedding gradient sharded; the lookup here is ``F.embedding``,
whose backward, a scatter-add of the cotangent into the embedding's rows,
is the same function.  (Indexing, ``embed[tokens]``, computes the same
forward, but its backward's CPU scatter-add sums duplicate tokens in an
order that varies from run to run above a few hundred tokens, which would
break the trainer's bitwise restart.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.dist.hints import current_policy, shard_hint
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dtype_of, embed_init, param, rms_norm,
                                       softcap)
from repro_torch.models.transformer import apply_stack, init_layers, layer_plan


class Transformer(nn.Module):
    """The decoder's parameters (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = param(embed_init((cfg.vocab_size, cfg.d_model), dt,
                                      generator, device))
        self.final_norm = param(torch.zeros(cfg.d_model, dtype=torch.float32,
                                            device=device))
        if not cfg.tie_embeddings:
            self.lm_head = param(embed_init((cfg.d_model, cfg.vocab_size), dt,
                                            generator, device))
        self.layers = nn.ModuleList(init_layers(cfg, generator=generator,
                                                device=device))

    def forward(self, tokens, **kw):
        return forward(self, tokens, self.cfg, **kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                *, device=None) -> Transformer:
    """Random parameters with the reference's scales, drawn in a fixed order
    from ``generator`` (a ``torch.Generator`` on ``device``; by default one
    seeded with 0).  ``device=None`` is the card; ``"meta"`` allocates
    nothing and draws nothing (:func:`param_specs`)."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return Transformer(cfg, generator=generator, device=dev)


def param_specs(cfg: ModelConfig) -> Transformer:
    """The parameters' shapes and dtypes without allocating: the model on
    the ``meta`` device."""
    return init_params(cfg, device="meta")


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Parameter name → shape (drives ``param_count``)."""
    return {name: tuple(p.shape)
            for name, p in param_specs(cfg).named_parameters()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class _EmbedGradHint(torch.autograd.Function):
    """Identity forward; the backward lays the embedding's cotangent out as
    the hint site ``embed_grad`` says (the reference's hint inside its
    embedding VJP, which keeps the (V, D) gradient sharded)."""

    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return shard_hint(g, "embed_grad")


def _embed_weight(params: Transformer):
    w = params.embed
    if current_policy() and w.requires_grad and torch.is_grad_enabled():
        return _EmbedGradHint.apply(w)
    return w


def _embed_tokens(params: Transformer, tokens, cfg: ModelConfig):
    x = F.embedding(tokens, _embed_weight(params))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x.to(dtype_of(cfg.compute_dtype))


def _unembed(params: Transformer, x, cfg: ModelConfig):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return softcap(x @ head, cfg.logit_softcap)


def forward(params: Transformer, tokens, cfg: ModelConfig, *, caches=None,
            decode_pos=None, remat: bool = True,
            differentiable: bool = False):
    """tokens (B,S) → (hidden (B,S,D), caches, metrics).  ``metrics`` holds
    the MoE layers' ``aux_loss`` / ``z_loss`` / ``expert_load`` summed over
    the layers, and is empty without MoE layers.  ``remat`` recomputes each
    layer in the backward, ``differentiable`` each attention q block (both
    only with gradients on; see ``apply_stack`` and
    ``chunked_causal_attention``)."""
    B, S = tokens.shape
    x = shard_hint(_embed_tokens(params, tokens, cfg), "layer_boundary")
    if decode_pos is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    else:
        pos = torch.as_tensor(decode_pos, dtype=torch.int32, device=x.device)
        # a shared position → (S,); one per row (continuous batching) →
        # (B, 1), broadcastable against the (..., S) layout of apply_rope
        positions = pos.expand(S) if pos.dim() == 0 else pos[:, None]
    x, caches, metrics = apply_stack(params.layers, x, cfg,
                                     positions=positions, caches=caches,
                                     decode_pos=decode_pos, remat=remat,
                                     differentiable=differentiable)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, caches, metrics


def logits_fn(params: Transformer, tokens, cfg: ModelConfig,
              remat: bool = True):
    x, _, metrics = forward(params, tokens, cfg, remat=remat)
    return _unembed(params, x, cfg), metrics


def _ce_chunk(params: Transformer, hc, yc, cfg: ModelConfig) -> torch.Tensor:
    """Σ (logsumexp - gold) over one chunk, on f32 logits."""
    logits = shard_hint(_unembed(params, hc, cfg), "logits").to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_cross_entropy(params: Transformer, hidden, labels,
                          cfg: ModelConfig, chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE without materializing (B,S,V) f32 logits: the
    sequence goes in chunks of ``chunk`` positions, each chunk's f32 logits
    are reduced at once, and with gradients on each chunk is recomputed in
    the backward (``torch.utils.checkpoint``), so one chunk of logits is
    alive at a time."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"cross-entropy chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk, params, hidden[:, sl], labels[:, sl],
                              cfg, use_reentrant=False)
        else:
            part = _ce_chunk(params, hidden[:, sl], labels[:, sl], cfg)
        total = total + part
    return total / (B * S)


def loss_fn(params: Transformer, tokens, labels, cfg: ModelConfig,
            remat: bool = True):
    """``(loss, metrics)``: loss = ce + aux_loss + z_loss (the MoE terms
    where there are MoE layers); metrics = ``{ce, aux_loss, z_loss,
    expert_load}`` (just ``ce`` without MoE layers)."""
    hidden, _, metrics = forward(params, tokens, cfg, remat=remat,
                                 differentiable=True)
    ce = chunked_cross_entropy(params, hidden, labels, cfg)
    loss = ce
    if metrics:
        loss = loss + metrics["aux_loss"] + metrics["z_loss"]
    return loss, {"ce": ce, **metrics}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Leaf name → ``CacheSpec``: one tensor per leaf name, stacked over the
    layers of the kind that has it (see the module docstring)."""
    plan = layer_plan(cfg)
    out = {}
    for kind in ("attn", "mamba"):
        n = sum(s["kind"] == kind for s in plan)
        if not n:
            continue
        if kind == "mamba":
            spec = mamba_mod.mamba_cache_spec(cfg, batch)
        elif cfg.attn_type == "mla":
            spec = attn_mod.mla_cache_spec(cfg, batch, max_len)
        else:
            spec = attn_mod.gqa_cache_spec(cfg, batch, max_len)
        out.update({name: attn_mod.CacheSpec((n,) + s.shape, s.dtype)
                    for name, s in spec.items()})
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    dev = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for name, s in cache_specs(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

def prefill_step(params: Transformer, tokens, cfg: ModelConfig,
                 max_len: int | None = None, caches=None):
    """tokens (B,S) → (last-token logits (B,V), filled caches).  ``caches``:
    zeroed caches to fill (a mesh-backed replica passes them laid out on
    its slice); fresh ones on the tokens' device by default."""
    B, S = tokens.shape
    if caches is None:
        caches = init_cache(cfg, B, max_len or S, device=tokens.device)
    hidden, caches, _ = forward(params, tokens, cfg, caches=caches)
    logits = _unembed(params, hidden[:, -1:, :], cfg)[:, 0, :]
    return logits, caches


def decode_step(params: Transformer, caches, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens (B,1); pos: the position of this token, one
    shared (an int or a 0-d tensor) or one per row (a (B,) int tensor, for
    continuous batching).  Rows are independent, except through the MoE
    capacity above 4 rows (``models/moe.py``).  The caches are updated in
    place.  Returns (logits (B,V), caches)."""
    hidden, caches, _ = forward(params, tokens, cfg, caches=caches,
                                decode_pos=pos)
    logits = _unembed(params, hidden[:, -1:, :], cfg)[:, 0, :]
    return logits, caches


# ---------------------------------------------------------------------------
# FLOP accounting (roofline: MODEL_FLOPS = 6·N·D train / 2·N·D inference)
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, tokens: int, *, train: bool = True,
                active_only: bool = True) -> float:
    n = cfg.active_param_count() if active_only else cfg.param_count()
    mult = 6.0 if train else 2.0
    return mult * n * tokens

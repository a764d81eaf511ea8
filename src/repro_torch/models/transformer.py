"""Decoder stacks: pre-norm residual sub-layers over a repeating pattern.

Counterpart of ``repro.models.transformer``.  The reference stacks each
stage's parameters on a leading axis and runs the stack as one ``lax.scan``;
here the layers are an ``nn.ModuleList`` in layer order and the stack is a
loop: first the leading dense layers (DeepSeek-V2's
``first_dense_layers``), then the stages, layer ``first_dense_layers + s *
period + j`` being slot ``j`` of stage ``s``.

With ``remat`` (training), each layer is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint(stage_body,
nothing_saveable)`` recomputes each stage: the backward keeps one layer's
input a layer.  The reference's ``_residual_barrier`` keeps XLA from
hoisting f32 converts into its scan's saved residuals; eager PyTorch saves
what the layer returns, so it has no counterpart here.

Each slot has a mixer kind (``attn``: GQA or MLA; ``mamba``), a window kind
and an FFN kind (``dense``, ``moe``, or ``none`` for Falcon-Mamba's
``d_ff = 0``), resolved from the config as the reference's
``_sublayer_plan`` does.

The caches are one tensor per leaf name, each stacked over the layers that
have that leaf: attention leaves (``k`` / ``v`` or MLA's ``ckv`` / ``kr``)
over the attention layers, Mamba's ``conv`` / ``ssm`` over the Mamba
layers, both in layer order.  Jamba's 32 layers give ``k`` / ``v`` a
leading 4 and ``conv`` / ``ssm`` a leading 28; ``layer_plan`` gives each
layer its index (``cache``) within its kind.  A decode step's
``attention.PageTable``, under the caches' ``"pages"`` key, goes to every
attention layer with its leaves.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.hints import checkpointed, like, shard_hint
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn_block, init_ffn_params
from repro_torch.models.layers import param, rms_norm
from repro_torch.models.moe import init_moe_params, moe_block

MAMBA_LEAVES = ("conv", "ssm")


def attn_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    return ("ckv", "kr") if cfg.attn_type == "mla" else ("k", "v")


def _sublayer_plan(cfg: ModelConfig) -> list[dict]:
    """Static description of each sub-layer slot within a stage."""
    plan = []
    for j in range(cfg.period):
        layer = cfg.first_dense_layers + j      # representative layer index
        kind = cfg.layer_kind(layer)
        moe = cfg.is_moe_layer(layer)
        plan.append({
            "kind": kind,
            "window": cfg.window_kind(layer) if kind == "attn" else None,
            "moe": moe,
            "ffn": "moe" if moe else ("none" if cfg.d_ff == 0 else "dense"),
        })
    # the pattern must align stage-invariantly for window / MoE cycles
    for stage in range(1, cfg.num_stages):
        for j, slot in enumerate(plan):
            layer = cfg.first_dense_layers + stage * cfg.period + j
            kind = cfg.layer_kind(layer)
            if (kind != slot["kind"]
                    or cfg.is_moe_layer(layer) != slot["moe"]
                    or (kind == "attn"
                        and cfg.window_kind(layer) != slot["window"])):
                raise ValueError(f"{cfg.name}: the block / MoE / window "
                                 f"patterns must align with the stage period")
    return plan


def _first_slot(cfg: ModelConfig) -> dict:
    """A leading dense layer: attention and a dense FFN."""
    return {"kind": "attn", "window": cfg.window_kind(0), "moe": False,
            "ffn": "dense"}


def layer_plan(cfg: ModelConfig) -> list[dict]:
    """One slot a layer, in layer order, each with ``cache``: the layer's
    index in the cache leaves of its kind."""
    plan = _sublayer_plan(cfg)
    slots = ([_first_slot(cfg)] * cfg.first_dense_layers
             + plan * cfg.num_stages)
    seen = {"attn": 0, "mamba": 0}
    out = []
    for slot in slots:
        out.append(dict(slot, cache=seen[slot["kind"]]))
        seen[slot["kind"]] += 1
    return out


class Sublayer(nn.Module):
    """One pre-norm residual block: ``norm_1``, ``mixer``, then ``norm_2``
    and ``ffn`` (unless the slot has none); ``post_norm_1`` /
    ``post_norm_2`` with sandwich norms."""

    def __init__(self, cfg: ModelConfig, slot: dict, *, generator, device):
        super().__init__()

        def norm():
            return param(torch.zeros(cfg.d_model, dtype=torch.float32,
                                     device=device))

        kw = dict(generator=generator, device=device)
        self.norm_1 = norm()
        if slot["kind"] == "attn":
            self.mixer = (attn_mod.init_mla_params(cfg, **kw)
                          if cfg.attn_type == "mla"
                          else attn_mod.init_gqa_params(cfg, **kw))
        else:
            self.mixer = mamba_mod.init_mamba_params(cfg, **kw)
        if slot["ffn"] != "none":
            self.norm_2 = norm()
            self.ffn = (init_moe_params(cfg, **kw) if slot["ffn"] == "moe"
                        else init_ffn_params(cfg, **kw))
        if cfg.post_block_norm:
            self.post_norm_1 = norm()
            self.post_norm_2 = norm()


def init_sublayer(cfg: ModelConfig, slot: dict, *, generator,
                  device) -> Sublayer:
    return Sublayer(cfg, slot, generator=generator, device=device)


def init_layers(cfg: ModelConfig, *, generator, device) -> list[Sublayer]:
    """Every layer in layer order: the leading dense layers (their FFN at
    ``first_dense_d_ff``), then ``num_stages`` stages of ``period`` slots."""
    plan = _sublayer_plan(cfg)
    cfg_first = cfg.with_(d_ff=cfg.first_dense_d_ff or cfg.d_ff)
    layers = [init_sublayer(cfg_first, _first_slot(cfg), generator=generator,
                            device=device)
              for _ in range(cfg.first_dense_layers)]
    for _ in range(cfg.num_stages):
        layers.extend(init_sublayer(cfg, slot, generator=generator,
                                    device=device) for slot in plan)
    return layers


def apply_sublayer(
    params: Sublayer,
    x: torch.Tensor,
    cfg: ModelConfig,
    slot: dict,
    *,
    positions,
    cache: dict | None,
    decode_pos,
    differentiable: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Pre-norm residual block: x + mixer(norm(x)); x + ffn(norm(x)).
    Returns ``(x, metrics)``; only an MoE FFN reports metrics."""
    metrics: dict = {}
    h = rms_norm(x, params.norm_1, cfg.norm_eps)
    # sequence-gather point: with layer-boundary activations sharded over
    # the sequence, a replicated sublayer_input trades the per-matmul
    # weight gathers for one activation gather here
    h = shard_hint(h, "sublayer_input")
    if slot["kind"] == "attn":
        window = cfg.local_window if slot["window"] == "local" else None
        block = (attn_mod.mla_block if cfg.attn_type == "mla"
                 else attn_mod.gqa_block)
        h, _ = block(params.mixer, h, cfg, window=window, positions=positions,
                     cache=cache, decode_pos=decode_pos,
                     differentiable=differentiable)
    else:
        h, _ = mamba_mod.mamba_block(params.mixer, h, cfg, cache=cache,
                                     decode_pos=decode_pos)
    if cfg.post_block_norm:
        h = rms_norm(h, params.post_norm_1, cfg.norm_eps)
    # the branch laid out as the residual stream before the add: the
    # (sequence-parallel) reduce-scatter of its partial sums is then an
    # explicit step, and its backward gathers the stream's gradient before
    # the branch's matmuls see it
    x = x + like(h, x)
    if slot["ffn"] != "none":
        h = rms_norm(x, params.norm_2, cfg.norm_eps)
        h = shard_hint(h, "sublayer_input")
        if slot["ffn"] == "moe":
            h, metrics = moe_block(params.ffn, h, cfg)
        else:
            h = ffn_block(params.ffn, h, cfg)
        if cfg.post_block_norm:
            h = rms_norm(h, params.post_norm_2, cfg.norm_eps)
        x = x + like(h, x)
    x = shard_hint(x, "layer_boundary")
    return x, metrics


def apply_stack(
    layers,                      # nn.ModuleList of Sublayer, layer order
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions,
    caches: dict | None = None,  # {leaf: (L_kind, B, ...)}, see the docstring
    decode_pos=None,
    remat: bool = True,
    differentiable: bool = False,
) -> tuple[torch.Tensor, dict | None, dict]:
    """Run every layer; a layer reads and writes its rows of ``caches`` in
    place.  Returns ``(x, caches, metrics)``: with MoE layers in the stages,
    ``aux_loss`` / ``z_loss`` / ``expert_load`` summed over them in layer
    order, as the reference's scan does; else empty.  ``remat`` recomputes
    each layer in the backward; it applies only with gradients on and no
    caches (a recompute would write a cache twice)."""
    plan = layer_plan(cfg)
    agg: dict = {}
    if cfg.moe is not None and any(s["moe"] for s in plan):
        agg = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device),
               "z_loss": torch.zeros((), dtype=torch.float32,
                                     device=x.device),
               "expert_load": torch.zeros(cfg.moe.num_experts,
                                          dtype=torch.float32,
                                          device=x.device)}
    for layer, slot in zip(layers, plan):
        c = None
        if caches is not None:
            names = (MAMBA_LEAVES if slot["kind"] == "mamba"
                     else attn_leaves(cfg))
            c = {name: caches[name][slot["cache"]] for name in names}
            if slot["kind"] == "attn" and attn_mod.PAGES in caches:
                c[attn_mod.PAGES] = caches[attn_mod.PAGES]
        kw = dict(positions=positions, cache=c, decode_pos=decode_pos,
                  differentiable=differentiable)
        if remat and caches is None and torch.is_grad_enabled():
            x, met = checkpointed(apply_sublayer, layer, x, cfg, slot, **kw)
        else:
            x, met = apply_sublayer(layer, x, cfg, slot, **kw)
        for k, v in met.items():
            agg[k] = agg[k] + v
    return x, caches, agg

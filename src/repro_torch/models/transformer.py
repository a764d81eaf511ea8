"""Decoder stacks: pre-norm residual sub-layers over a repeating pattern.

Counterpart of ``repro.models.transformer``.  The reference stacks each
stage's parameters on a leading axis and runs the stack as one ``lax.scan``;
here the layers are an ``nn.ModuleList`` in layer order (stage-major: layer
``s * period + j`` is slot ``j`` of stage ``s``) and the stack is a loop.  The
reference's ``_residual_barrier`` is an autodiff device for training and has
no counterpart here.

Ported slots: ``attn`` (GQA) with a dense FFN, local/global windows and
Gemma-2's sandwich norms (``post_block_norm``).  MLA, Mamba and MoE slots
raise ``NotImplementedError``: they come with the next model slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn_block, init_ffn_params
from repro_torch.models.layers import param, rms_norm

NOT_PORTED = "ROADMAP queue 1, item 7b (the next model slice)"


def _sublayer_plan(cfg: ModelConfig) -> list[dict]:
    """Static description of each sub-layer slot within a stage."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attn_type} attention is not ported yet; "
            f"{NOT_PORTED}")
    if cfg.first_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: leading dense layers (first_dense_layers) are not "
            f"ported yet; {NOT_PORTED}")
    plan = []
    for j in range(cfg.period):
        kind = cfg.layer_kind(j)
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {kind} blocks are not ported yet; {NOT_PORTED}")
        if cfg.is_moe_layer(j):
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet; {NOT_PORTED}")
        plan.append({"kind": kind, "window": cfg.window_kind(j), "moe": False,
                     "ffn": "none" if cfg.d_ff == 0 else "dense"})
    # the pattern must align stage-invariantly
    for layer in range(cfg.num_layers):
        if cfg.window_kind(layer) != plan[layer % cfg.period]["window"]:
            raise ValueError(
                f"{cfg.name}: window pattern must align with stage period")
    return plan


class Sublayer(nn.Module):
    """One pre-norm residual block: ``norm_1``, ``mixer``, then ``norm_2``
    and ``ffn``; ``post_norm_1`` / ``post_norm_2`` with sandwich norms."""

    def __init__(self, cfg: ModelConfig, slot: dict, *, generator, device):
        super().__init__()

        def norm():
            return param(torch.zeros(cfg.d_model, dtype=torch.float32,
                                     device=device))

        self.norm_1 = norm()
        self.mixer = attn_mod.init_gqa_params(cfg, generator=generator,
                                              device=device)
        if slot["ffn"] != "none":
            self.norm_2 = norm()
            self.ffn = init_ffn_params(cfg, generator=generator, device=device)
        if cfg.post_block_norm:
            self.post_norm_1 = norm()
            self.post_norm_2 = norm()


def init_sublayer(cfg: ModelConfig, slot: dict, *, generator,
                  device) -> Sublayer:
    return Sublayer(cfg, slot, generator=generator, device=device)


def init_stage(cfg: ModelConfig, *, generator, device) -> list[Sublayer]:
    """The ``period`` sub-layers of one stage, in slot order."""
    return [init_sublayer(cfg, slot, generator=generator, device=device)
            for slot in _sublayer_plan(cfg)]


def apply_sublayer(
    params: Sublayer,
    x: torch.Tensor,
    cfg: ModelConfig,
    slot: dict,
    *,
    positions,
    cache: dict | None,
    decode_pos,
) -> torch.Tensor:
    """Pre-norm residual block: x + mixer(norm(x)); x + ffn(norm(x))."""
    h = rms_norm(x, params.norm_1, cfg.norm_eps)
    window = cfg.local_window if slot["window"] == "local" else None
    h, _ = attn_mod.gqa_block(params.mixer, h, cfg, window=window,
                              positions=positions, cache=cache,
                              decode_pos=decode_pos)
    if cfg.post_block_norm:
        h = rms_norm(h, params.post_norm_1, cfg.norm_eps)
    x = x + h
    if slot["ffn"] != "none":
        h = rms_norm(x, params.norm_2, cfg.norm_eps)
        h = ffn_block(params.ffn, h, cfg)
        if cfg.post_block_norm:
            h = rms_norm(h, params.post_norm_2, cfg.norm_eps)
        x = x + h
    return x


def apply_stack(
    layers,                      # nn.ModuleList of Sublayer, layer order
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions,
    caches: dict | None = None,  # {'k': (L, B, Smax, KV, hd), 'v': ...}
    decode_pos=None,
) -> tuple[torch.Tensor, dict | None]:
    """Run every layer; layer ``l`` reads and writes ``caches[..][l]`` in
    place.  Returns ``(x, caches)``."""
    plan = _sublayer_plan(cfg)
    for l, layer in enumerate(layers):
        c = ({name: leaf[l] for name, leaf in caches.items()}
             if caches is not None else None)
        x = apply_sublayer(layer, x, cfg, plan[l % cfg.period],
                           positions=positions, cache=c,
                           decode_pos=decode_pos)
    return x, caches

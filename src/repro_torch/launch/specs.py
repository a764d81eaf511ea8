"""Input specs + step functions for every (arch × shape) dry-run cell.

Counterpart of ``repro.launch.specs``.  ``input_specs`` returns stand-ins
on the ``meta`` device (no allocation) whose shapes and dtypes are the
reference's ``ShapeDtypeStruct`` s.  ``build_step`` returns the function
each shape kind runs:

  train_4k    → loss + gradients (remat) + AdamW update
  prefill_32k → prefill_step: forward + KV/state-cache fill + last logits
  decode_*    → decode_step: ONE new token against a seq_len cache

Modality note ([audio]/[vlm]): the frontend is a stub — specs feed token ids
(EnCodec/VQ codes); precomputed frame/patch embeddings would enter through
the same embedding-table path.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import (grad_norm_weights, padded_config,
                                       settle_grads, tie_padded_grads)
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import (cache_specs, decode_step, loss_fn,
                                      prefill_step)
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """Moment precision policy: int8 blockwise for ≥100B models, f32
    otherwise (the reference's)."""
    big = cfg.param_count() >= 100e9
    return AdamWConfig(learning_rate=1e-4, weight_decay=0.1,
                       moment_dtype="int8" if big else "float32")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token with a KV/state cache of seq_len
    return {
        "tokens": _meta((B, 1), i32),
        "pos": _meta((), i32),
        "caches": {name: _meta(s.shape, s.dtype)
                   for name, s in cache_specs(cfg, B, S).items()},
    }


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               opt_cfg: AdamWConfig | None = None, *, model_axis: int = 1):
    """The step of ``shape``'s kind, taking the ``input_specs`` fields
    positionally after the state: ``train_step(params, opt_state, tokens,
    labels)``, ``prefill(params, tokens, caches)`` (zeroed caches to fill,
    laid out as the mesh wants them), ``serve_step(params, caches, tokens,
    pos)``.  ``params`` is a ``Transformer``.

    ``model_axis``: the size of the mesh's model axis.  The steps run the
    config padded for it (``dist.sharding.padded_config``; ``params`` and
    the caches padded to match), and the train step gives the padded
    heads the gradients of the unpadded model (``tie_padded_grads``, the
    copied KV heads counted once in the norm).  On ``DTensor`` parameters
    the train step lays each gradient out as its parameter
    (``settle_grads``) before the update."""
    run_cfg = padded_config(cfg, model_axis)
    if shape.kind == "train":
        opt_cfg = opt_cfg or opt_config_for(cfg)
        weights = grad_norm_weights(cfg, model_axis)

        def train_step(params, opt_state, tokens, labels):
            leaves = dict(params.named_parameters())
            loss, _ = loss_fn(params, tokens, labels, run_cfg)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            grads = tie_padded_grads(settle_grads(grads, leaves), cfg,
                                     model_axis)
            _, opt_state, om = adamw_update(grads, opt_state, leaves,
                                            opt_cfg, norm_weights=weights)
            return params, opt_state, {"loss": loss, **om}

        return train_step

    if shape.kind == "prefill":
        def prefill(params, tokens, caches):
            return prefill_step(params, tokens, run_cfg, caches=caches)
        return prefill

    def serve_step(params, caches, tokens, pos):
        return decode_step(params, caches, tokens, pos, run_cfg)
    return serve_step


def runnable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k needs sub-quadratic attention: SSM/hybrid only."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if "mamba" in kinds:
        out.append("long_500k")
    return out

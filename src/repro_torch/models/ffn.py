"""Dense feed-forward blocks: SwiGLU (llama family), GeGLU (gemma2) and the
GELU MLP (musicgen).

Counterpart of ``repro.models.ffn``.  GELU is the tanh approximation, as
``jax.nn.gelu`` computes it by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.hints import shard_hint
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of, param


class FFN(nn.Module):
    """``w_gate`` / ``w_up`` / ``w_down`` (gated) or ``w_up`` / ``w_down``."""

    def __init__(self, cfg: ModelConfig, *, generator, device,
                 d_ff: int | None = None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        if cfg.ffn_type in ("swiglu", "geglu"):
            self.w_gate = param(dense_init((D, Fd), dt, generator, device))
        self.w_up = param(dense_init((D, Fd), dt, generator, device))
        self.w_down = param(dense_init((Fd, D), dt, generator, device))


def init_ffn_params(cfg: ModelConfig, *, generator, device,
                    d_ff: int | None = None) -> FFN:
    return FFN(cfg, generator=generator, device=device, d_ff=d_ff)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def ffn_block(params: FFN, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if hasattr(params, "w_gate"):
        act = _gelu if cfg.ffn_type == "geglu" else F.silu
        h = act(x @ params.w_gate) * (x @ params.w_up)
    else:
        h = _gelu(x @ params.w_up)
    # the hidden stays TP-sharded: the row-parallel w_down then reduces
    # partial sums instead of gathering the (B, S, F) activation
    h = shard_hint(h, "ffn_hidden")
    return h @ params.w_down

"""Shared primitive layers: norms, RoPE, embeddings, softcaps, initializers.

Counterpart of ``repro.models.layers``, with the reference's dtypes: norm
variances, RoPE and softcaps compute in float32 and cast back to the input
dtype where the reference does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A model parameter.  Serving only: no gradient (training comes with
    its own slice)."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# init helpers — every parameter is made through these, so the dtype policy
# and the draw order of the generator are uniform.
# ---------------------------------------------------------------------------

def dense_init(shape, dtype, generator, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal in [-3, 3] times ``1/sqrt(fan_in)`` (the reference's
    scales), drawn in float32 from ``generator`` on ``device``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, a=-3.0, b=3.0, generator=generator)
    return (t * std).to(dtype)


def embed_init(shape, dtype, generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(generator=generator)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: variance in f32, the scaling in the input dtype."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    rrms = torch.rsqrt(var + eps).to(x.dtype)
    return x * rrms * (1.0 + weight).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap), in f32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies in f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: (..., S, H, D); positions:
    broadcastable to (..., S)."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, device=x.device)      # (d/2,)
    angles = positions[..., :, None].to(torch.float32) * inv_freq  # (...,S,d/2)
    sin = torch.sin(angles)[..., :, None, :]                    # (...,S,1,d/2)
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

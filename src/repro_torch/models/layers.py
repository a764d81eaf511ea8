"""Shared primitive layers: norms, RoPE (and YaRN), embeddings, softcaps,
initializers.

Counterpart of ``repro.models.layers``, with the reference's dtypes: norm
variances, RoPE and softcaps compute in float32 and cast back to the input
dtype where the reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A model parameter, made without a gradient so serving builds no
    graphs; the trainer turns gradients on for its own model
    (``requires_grad_(True)``)."""
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


# ---------------------------------------------------------------------------
# YaRN (arXiv:2309.00071), as DeepSeek-V2 (arXiv:2405.04434) applies it to
# MLA's rotary dims
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class YaRN:
    """A YaRN ``rope_scaling``: positions beyond ``original_max_position
    _embeddings`` by interpolating the low frequencies ``factor``-fold."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature term ``0.1·mscale·ln(factor) + 1``
    (1 without scaling)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(d: int, theta: float, s: YaRN,
                     device=None) -> torch.Tensor:
    """(d/2,) f32 inverse frequencies: dims of fewer than ``beta_fast``
    rotations over the original context keep theirs, dims of more than
    ``beta_slow`` take them divided by ``factor``, and a linear ramp over
    the correction range between blends the two."""
    def dim_of(rotations):
        return (d * math.log(s.original_max_position_embeddings
                             / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(dim_of(s.beta_fast)), 0)
    high = min(math.ceil(dim_of(s.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    extra = rope_frequencies(d, theta, device=device)
    inter = extra / s.factor
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0.0, 1.0)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def yarn_scales(s: YaRN) -> tuple[float, float]:
    """(cos / sin factor, softmax scale factor): ``mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)`` and ``mscale(factor,
    mscale_all_dim)²`` (the second 1 when ``mscale_all_dim`` is 0)."""
    all_dim = yarn_mscale(s.factor, s.mscale_all_dim) \
        if s.mscale_all_dim else 1.0
    cos_sin = yarn_mscale(s.factor, s.mscale) / \
        yarn_mscale(s.factor, s.mscale_all_dim)
    return cos_sin, all_dim * all_dim


def apply_rope_yarn(x: torch.Tensor, positions: torch.Tensor, theta: float,
                    s: YaRN) -> torch.Tensor:
    """:func:`apply_rope` (split-half pairs) with YaRN's frequencies and
    its cos / sin factor."""
    d = x.shape[-1]
    inv_freq = yarn_frequencies(d, theta, s, device=x.device)
    cos_sin, _ = yarn_scales(s)
    angles = positions[..., :, None].to(torch.float32) * inv_freq
    sin = (torch.sin(angles) * cos_sin)[..., :, None, :]
    cos = (torch.cos(angles) * cos_sin)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

"""A LLaMA-style decoder in plain PyTorch: the reference for deepseek-7b.

Pre-norm residual layers of multi-head attention (rotary embeddings in the
split-half convention, causal softmax) and a SwiGLU feed-forward, RMSNorm
with the ``(1 + g)`` gain, a final norm and an untied output head, as the
DeepSeek LLM paper (arXiv:2401.02954) and LLaMA describe them.  Every
weight is read as float32 one layer at a time, so the pass fits beside the
bfloat16 weights; the products run in the precision object's arithmetic
(:mod:`precision`).  Rows are independent: a batch is padded at its end,
and causality keeps the padding out of every earlier position.

Parameter names and layouts are the benchmark's statement of the
architecture: ``embed`` (V, D), ``lm_head`` (D, V), ``final_norm`` (D,);
per layer ``i`` ``layers.i.norm_1`` / ``norm_2`` (D,), ``layers.i.mixer.wq``
/ ``wk`` / ``wv`` (D, H*hd), ``wo`` (H*hd, D), ``layers.i.ffn.w_gate`` /
``w_up`` (D, F) and ``w_down`` (F, D); products are ``x @ W``.
"""

from __future__ import annotations

import math

import torch

# the smoke model of the benchmark's CPU tests: the program's smoke widths
SMOKE = {"num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
         "d_ff": 172, "vocab_size": 160, "norm_eps": 1e-6,
         "rope_theta": 10000.0, "param_dtype": "float32",
         "compute_dtype": "float32"}


def parameters(cfg: dict) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, dtype, init) of every weight, in a fixed order.
    ``init`` is ``("normal", std)``: the matrices at 1/sqrt(fan_in), the
    embedding and the head at 0.02, the norm gains at 0.1 about zero."""
    D, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, F, V = D // H, cfg["d_ff"], cfg["vocab_size"]
    dt = cfg["param_dtype"]
    out = [("embed", (V, D), dt, ("normal", 0.02)),
           ("final_norm", (D,), "float32", ("normal", 0.1)),
           ("lm_head", (D, V), dt, ("normal", 0.02))]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm_1", (D,), "float32", ("normal", 0.1)),
                (p + "norm_2", (D,), "float32", ("normal", 0.1)),
                (p + "mixer.wq", (D, H * hd), dt, ("normal", D ** -0.5)),
                (p + "mixer.wk", (D, KV * hd), dt, ("normal", D ** -0.5)),
                (p + "mixer.wv", (D, KV * hd), dt, ("normal", D ** -0.5)),
                (p + "mixer.wo", (H * hd, D), dt, ("normal",
                                                   (H * hd) ** -0.5)),
                (p + "ffn.w_gate", (D, F), dt, ("normal", D ** -0.5)),
                (p + "ffn.w_up", (D, F), dt, ("normal", D ** -0.5)),
                (p + "ffn.w_down", (F, D), dt, ("normal", F ** -0.5))]
    return out


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + g)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, S, H, d) at positions 0 .. S-1: each pair
    (i, i + d/2) rotated by the angle ``pos / theta**(2i/d)``."""
    S, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, (B, S, H, d) each, one row at a time."""
    B, S, H, d = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for b in range(B):
        s = torch.einsum("qhd,khd->hqk", q[b], k[b]) / math.sqrt(d)
        s = s.masked_fill(~mask, float("-inf"))
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[b])
    return out


def hidden(w: dict, tokens: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """(B, S) token ids → the final-normed hidden states (B, S, D), float32."""
    H, KV = cfg["num_heads"], cfg["num_kv_heads"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    x = w["embed"][tokens].to(torch.float32)
    B, S, D = x.shape
    hd = D // H
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."

        def mm(a, name):
            return prec.matmul(a, prec.weight(w[p + name]))

        h = rms_norm(x, w[p + "norm_1"].float(), eps)
        q = rope(mm(h, "mixer.wq").view(B, S, H, hd), theta)
        k = rope(mm(h, "mixer.wk").view(B, S, KV, hd), theta)
        v = mm(h, "mixer.wv").view(B, S, KV, hd)
        x = x + mm(attention(q, k, v).reshape(B, S, H * hd), "mixer.wo")
        h = rms_norm(x, w[p + "norm_2"].float(), eps)
        g = torch.nn.functional.silu(mm(h, "ffn.w_gate")) * mm(h, "ffn.w_up")
        x = x + mm(g, "ffn.w_down")
    return rms_norm(x, w["final_norm"].float(), eps)


def logits(w: dict, h: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """Rows of final hidden states (..., D) → logits (..., V), float32."""
    return prec.matmul(h, prec.weight(w["lm_head"]))

"""A DeepSeek-V2 decoder in plain PyTorch: the reference for
deepseek-v2-lite.

Pre-norm residual layers, as the DeepSeek-V2 paper (arXiv:2405.04434)
describes them:

* multi-head latent attention, unabsorbed: the keys' and values' latent
  ``c = RMSNorm(h W_dkv)`` (``kv_lora_rank``), per-head keys ``[c W_uk,
  rope(h W_kr)]`` (the rotary key shared by every head) and values ``c
  W_uv``; queries ``h W_q`` (or through a query latent ``RMSNorm(h W_dq)
  W_uq`` where ``q_lora_rank`` is set), their last ``qk_rope_head_dim``
  columns rotated; causal softmax at scale ``(nope + rope)^-0.5``, times
  YaRN's ``mscale²`` under a ``rope_scaling``;
* rotary embeddings in the split-half convention (pairs ``(i, i + d/2)``).
  The published code rotates interleaved pairs of its stored weights; on
  seeded random weights the two are the same function up to a fixed
  permutation of the rope columns of ``W_q`` and ``W_kr``, and this
  reference and the program both take the split-half one.  YaRN
  (arXiv:2309.00071): inverse frequencies ``theta^(-2i/d)`` kept below a
  correction range and divided by ``factor`` above it, a linear ramp
  between; the range from ``beta_fast`` / ``beta_slow`` rotations over
  ``original_max_position_embeddings``; cos and sin times ``m(factor,
  mscale) / m(factor, mscale_all_dim)``, ``m(s, a) = 0.1·a·ln s + 1``;
* ``first_dense_layers`` SwiGLU layers of ``first_dense_d_ff``, then MoE
  layers: a softmax router over the experts, the greedy top ``top_k``
  (ties to the lower index), gates the top-k probabilities (renormalised
  only under ``norm_topk_prob``) times ``routed_scaling_factor``; every
  routed token computed by its experts (no capacity); plus the shared
  experts, one SwiGLU of ``shared_d_ff``;
* RMSNorm with the ``(1 + g)`` gain, a final norm, an untied head.

Every weight is read as float32 one layer at a time (an expert's at a
time), and every product with a weight runs in the precision object's
arithmetic (:mod:`precision`); attention's scores and sums are float32.
Rows are independent: a batch is padded at its end, and causality keeps
the padding out of every earlier position.

Parameter names and layouts are the program's: ``embed`` (V, D),
``lm_head`` (D, V), ``final_norm`` (D,); per layer ``i``
``layers.i.norm_1`` / ``norm_2`` (D,), ``layers.i.mixer.w_dkv`` (D, R),
``kv_norm`` (R,), ``w_kr`` (D, rope), ``w_uk`` (R, H, nope), ``w_uv`` (R,
H, v), ``wo`` (H·v, D), ``wq`` (D, H, nope + rope) or ``w_dq`` (D, Q),
``q_norm`` (Q,), ``w_uq`` (Q, H, nope + rope); a dense layer's
``layers.i.ffn.w_gate`` / ``w_up`` (D, F) and ``w_down`` (F, D); an MoE
layer's ``layers.i.ffn.router`` (D, E) float32, ``ffn.experts.w_gate`` /
``w_up`` (E, D, F_e), ``ffn.experts.w_down`` (E, F_e, D) and
``ffn.shared.w_gate`` / ``w_up`` / ``w_down``.  Products are ``x @ W``.
"""

from __future__ import annotations

import math

import torch

# a small float32 model for the CPU tests: YaRN past its 16-position
# original context, gates not renormalised and scaled, no capacity, 8
# experts top 2, 2 shared, a dense first layer, no query latent.  (Not named
# ``SMOKE``: the tests that find references by that name run readers that
# do not yet take routed experts.)
SMALL = {
    "num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
    "d_ff": 192, "vocab_size": 160, "attn_type": "mla", "kv_lora_rank": 32,
    "q_lora_rank": 0, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "first_dense_layers": 1, "first_dense_d_ff": 192,
    "rope_theta": 10000.0,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 16,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "moe": {"num_experts": 8, "top_k": 2, "expert_d_ff": 48,
            "num_shared_experts": 2, "shared_d_ff": 96,
            "capacity_factor": None, "norm_topk_prob": False,
            "routed_scaling_factor": 1.5},
    "norm_eps": 1e-6, "param_dtype": "float32", "compute_dtype": "float32",
}

Q_BLOCK = 1024       # query rows of attention at a time


def parameters(cfg: dict) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, dtype, init) of every weight, in a fixed order.
    ``init`` is ``("normal", std)``: the matrices at 1/sqrt(fan_in) (an
    expert's input width, else the first axis), the router, the embedding
    and the head at 0.02, the norm gains at 0.1 about zero."""
    D, H, V = cfg["d_model"], cfg["num_heads"], cfg["vocab_size"]
    R, QL = cfg["kv_lora_rank"], cfg.get("q_lora_rank", 0)
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    dt, f32 = cfg["param_dtype"], "float32"

    def mat(name, shape, fan_in=None):
        return (name, shape, dt, ("normal", (fan_in or shape[0]) ** -0.5))

    def gain(name, n):
        return (name, (n,), f32, ("normal", 0.1))

    def swiglu(p, F):
        return [mat(p + "w_gate", (D, F)), mat(p + "w_up", (D, F)),
                mat(p + "w_down", (F, D))]

    out = [("embed", (V, D), dt, ("normal", 0.02)), gain("final_norm", D),
           ("lm_head", (D, V), dt, ("normal", 0.02))]
    moe = cfg.get("moe")
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        m = p + "mixer."
        out += [gain(p + "norm_1", D), gain(p + "norm_2", D),
                mat(m + "w_dkv", (D, R)), gain(m + "kv_norm", R),
                mat(m + "w_kr", (D, rope)), mat(m + "w_uk", (R, H, nope)),
                mat(m + "w_uv", (R, H, vd)), mat(m + "wo", (H * vd, D))]
        if QL:
            out += [mat(m + "w_dq", (D, QL)), gain(m + "q_norm", QL),
                    mat(m + "w_uq", (QL, H, nope + rope))]
        else:
            out.append(mat(m + "wq", (D, H, nope + rope)))
        if i < cfg.get("first_dense_layers", 0) or moe is None:
            out += swiglu(p + "ffn.", cfg.get("first_dense_d_ff")
                          or cfg["d_ff"])
            continue
        E, Fe = moe["num_experts"], moe["expert_d_ff"]
        Fs = moe.get("shared_d_ff") or Fe * moe["num_shared_experts"]
        out.append((p + "ffn.router", (D, E), f32, ("normal", 0.02)))
        out += [mat(p + "ffn.experts.w_gate", (E, D, Fe), D),
                mat(p + "ffn.experts.w_up", (E, D, Fe), D),
                mat(p + "ffn.experts.w_down", (E, Fe, D), Fe)]
        if moe["num_shared_experts"]:
            out += swiglu(p + "ffn.shared.", Fs)
    return out


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + g)


def _m(scale: float, a: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * a * math.log(scale) + 1.0


def yarn(cfg: dict, d: int, device) -> tuple[torch.Tensor, float, float]:
    """(inverse frequencies (d/2,), cos / sin factor, softmax factor) of
    the rope dims: plain RoPE's without a ``rope_scaling``."""
    theta = cfg["rope_theta"]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=device) / d)
    s = cfg.get("rope_scaling")
    if s is None:
        return inv, 1.0, 1.0
    factor, orig = s["factor"], s["original_max_position_embeddings"]

    def dim_of(rotations):
        # the dim whose wavelength makes ``rotations`` turns over orig
        return d * math.log(orig / (rotations * 2 * math.pi)) / \
            (2 * math.log(theta))

    low = max(math.floor(dim_of(s["beta_fast"])), 0)
    high = min(math.ceil(dim_of(s["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0.0, 1.0)
    inv = inv / factor * ramp + inv * (1.0 - ramp)
    all_dim = s.get("mscale_all_dim", 0)
    cos_sin = _m(factor, s.get("mscale", 1)) / _m(factor, all_dim)
    soft = _m(factor, all_dim) ** 2 if all_dim else 1.0
    return inv, cos_sin, soft


def rope(x: torch.Tensor, inv: torch.Tensor, factor: float) -> torch.Tensor:
    """(B, S, H, d) rotated at positions 0 .. S-1: pair (i, i + d/2) by the
    angle ``pos · inv[i]``, cos and sin times ``factor``."""
    S, d = x.shape[1], x.shape[-1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = (torch.cos(ang) * factor)[:, None, :]
    sin = (torch.sin(ang) * factor)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal softmax attention of (B, S, H, dq) queries against (B, S, H,
    dq) keys and (B, S, H, dv) values, a row and a block of queries at a
    time (each block against the keys up to its last query)."""
    B, S, H, _ = q.shape
    out = torch.empty((B, S, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for b in range(B):
        for lo in range(0, S, Q_BLOCK):
            hi = min(S, lo + Q_BLOCK)
            s = torch.einsum("qhd,khd->hqk", q[b, lo:hi], k[b, :hi]) * scale
            qpos = torch.arange(lo, hi, device=q.device)[:, None]
            kpos = torch.arange(hi, device=q.device)[None, :]
            s = s.masked_fill(kpos > qpos, float("-inf"))
            out[b, lo:hi] = torch.einsum("hqk,khd->qhd",
                                         torch.softmax(s, dim=-1), v[b, :hi])
    return out


def _flat(w: torch.Tensor) -> torch.Tensor:
    """A (in, H, d) weight as the (in, H·d) matrix of its product."""
    return w.reshape(w.shape[0], -1)


def mla(w: dict, p: str, h: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """Multi-head latent attention of the normed (B, S, D) stream."""
    B, S, _ = h.shape
    H, eps = cfg["num_heads"], cfg["norm_eps"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])

    def mm(a, name, flat=False):
        wt = w[p + name]
        return prec.matmul(a, prec.weight(_flat(wt) if flat else wt))

    if cfg.get("q_lora_rank", 0):
        cq = rms_norm(mm(h, "w_dq"), w[p + "q_norm"].float(), eps)
        q = mm(cq, "w_uq", flat=True)
    else:
        q = mm(h, "wq", flat=True)
    q = q.view(B, S, H, nope + rd)
    inv, cos_sin, soft = yarn(cfg, rd, h.device)
    c = rms_norm(mm(h, "w_dkv"), w[p + "kv_norm"].float(), eps)
    kr = rope(mm(h, "w_kr")[:, :, None, :], inv, cos_sin)
    k = torch.cat([mm(c, "w_uk", flat=True).view(B, S, H, nope),
                   kr.expand(B, S, H, rd)], dim=-1)
    v = mm(c, "w_uv", flat=True).view(B, S, H, vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], inv, cos_sin)], dim=-1)
    o = attention(q, k, v, (nope + rd) ** -0.5 * soft)
    return mm(o.reshape(B, S, H * vd), "wo")


def swiglu(w: dict, p: str, x: torch.Tensor, prec) -> torch.Tensor:
    def mm(a, name):
        return prec.matmul(a, prec.weight(w[p + name]))

    return mm(torch.nn.functional.silu(mm(x, "w_gate")) * mm(x, "w_up"),
              "w_down")


def moe(w: dict, p: str, h: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """The routed experts of every (token, expert) pair the router chose,
    weighted by the gates, plus the shared experts."""
    m = cfg["moe"]
    E, K = m["num_experts"], m["top_k"]
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    probs = torch.softmax(prec.matmul(x, prec.weight(w[p + "router"])), -1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :K], ids[:, :K]
    if m.get("norm_topk_prob", True):
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * m.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    ex = p + "experts."
    for e in range(E):
        tok, k = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]

        def mm(a, name):
            return prec.matmul(a, prec.weight(w[ex + name][e]))

        ye = mm(torch.nn.functional.silu(mm(xe, "w_gate")) * mm(xe, "w_up"),
                "w_down")
        # a token picks an expert at most once: no index repeats in a call
        out.index_add_(0, tok, ye * gates[tok, k, None])
    out = out.view(B, S, D)
    if m.get("num_shared_experts", 0):
        out = out + swiglu(w, p + "shared.", h, prec)
    return out


def hidden(w: dict, tokens: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """(B, S) token ids → the final-normed hidden states (B, S, D), float32."""
    eps = cfg["norm_eps"]
    x = w["embed"][tokens].to(torch.float32)
    first = cfg.get("first_dense_layers", 0)
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        h = rms_norm(x, w[p + "norm_1"].float(), eps)
        x = x + mla(w, p + "mixer.", h, cfg, prec)
        h = rms_norm(x, w[p + "norm_2"].float(), eps)
        if i < first or cfg.get("moe") is None:
            x = x + swiglu(w, p + "ffn.", h, prec)
        else:
            x = x + moe(w, p + "ffn.", h, cfg, prec)
    return rms_norm(x, w["final_norm"].float(), eps)


def logits(w: dict, h: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """Rows of final hidden states (..., D) → logits (..., V), float32."""
    return prec.matmul(h, prec.weight(w["lm_head"]))

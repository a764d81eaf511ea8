"""A Mamba-1 stack in plain PyTorch: the reference for falcon-mamba-7b.

Each layer is ``x + mixer(rms_norm(x))`` with no feed-forward, as
Falcon-Mamba (arXiv:2410.05355) and Mamba (arXiv:2312.00752) describe it:

* ``in_proj`` splits into the stream ``u`` and the gate ``z``;
* a depthwise causal convolution of width K over ``u`` (bias added), SiLU;
* ``x_proj`` gives dt (rank R), B and C (N each); Falcon-Mamba
  RMS-normalises each of the three, without a gain;
* ``delta = softplus(dt @ dt_proj + dt_bias)``, ``A = -exp(A_log)``;
* the selective recurrence, one position after the other:
  ``h_t = exp(delta_t A) h_(t-1) + delta_t u_t B_t``,
  ``y_t = h_t . C_t + D u_t``;
* ``out_proj`` of ``y * silu(z)``.

The recurrence runs sequentially, in float32, never as a scan.  Weights are
read as float32 one layer at a time; products run in the precision
object's arithmetic (:mod:`precision`).  Rows are independent and causal,
so a batch is padded at its end.

Parameter names and layouts: ``embed`` (V, D), ``lm_head`` (D, V),
``final_norm`` (D,); per layer ``layers.i.norm_1`` (D,) and
``layers.i.mixer.`` ``in_proj`` (D, 2 dI), ``conv_w`` (K, dI), ``conv_b``
(dI,), ``x_proj`` (dI, R + 2N), ``dt_proj`` (R, dI), ``dt_bias`` (dI,),
``A_log`` (dI, N), ``D`` (dI,), ``out_proj`` (dI, D); products ``x @ W``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .llama import rms_norm

STEP_BLOCK = 64     # positions whose decay and input terms are made at once

# the smoke model of the benchmark's CPU tests: the program's smoke widths
SMOKE = {"num_layers": 4, "d_model": 64, "num_heads": 1, "num_kv_heads": 1,
         "d_ff": 0, "vocab_size": 128, "block_pattern": ["mamba"],
         "norm_eps": 1e-5,
         "ssm": {"d_inner": 128, "d_state": 8, "d_conv": 4, "dt_rank": 8,
                 "chunk": 4, "bcdt_rms": True},
         "param_dtype": "float32", "compute_dtype": "float32"}


def parameters(cfg: dict) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, dtype, init) of every weight, in a fixed order.
    ``init``: ``("normal", std)``; ``("normal_about", mean, std)``;
    ``("log_arange", N)``, the log of 1 .. N along the last axis plus a
    0.1-wide normal spread (Mamba's S4D-real initialisation, perturbed)."""
    D, V, dt = cfg["d_model"], cfg["vocab_size"], cfg["param_dtype"]
    s = cfg["ssm"]
    dI, N, K, R = s["d_inner"], s["d_state"], s["d_conv"], s["dt_rank"]
    out = [("embed", (V, D), dt, ("normal", 0.02)),
           ("final_norm", (D,), "float32", ("normal", 0.1)),
           ("lm_head", (D, V), dt, ("normal", 0.02))]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm_1", (D,), "float32", ("normal", 0.1)),
                (p + "mixer.in_proj", (D, 2 * dI), dt, ("normal", D ** -0.5)),
                (p + "mixer.conv_w", (K, dI), dt, ("normal", 0.5)),
                (p + "mixer.conv_b", (dI,), "float32", ("normal", 0.1)),
                (p + "mixer.x_proj", (dI, R + 2 * N), dt,
                 ("normal", dI ** -0.5)),
                (p + "mixer.dt_proj", (R, dI), dt, ("normal", R ** -0.5)),
                (p + "mixer.dt_bias", (dI,), "float32",
                 ("normal_about", -4.6, 0.5)),
                (p + "mixer.A_log", (dI, N), "float32", ("log_arange", N)),
                (p + "mixer.D", (dI,), "float32", ("normal_about", 1.0, 0.1)),
                (p + "mixer.out_proj", (dI, D), dt, ("normal", dI ** -0.5))]
    return out


def _unit_rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def mixer(w: dict, p: str, h: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """One Mamba-1 mixer over (B, S, D) normed inputs → (B, S, D)."""
    s = cfg["ssm"]
    dI, N, K, R = s["d_inner"], s["d_state"], s["d_conv"], s["dt_rank"]
    # the B / C / dt norms' epsilon: the published ``mixer_rms_eps`` where
    # the model's settings give one, else the block norms' own
    eps = cfg.get("mixer_rms_eps", cfg["norm_eps"])
    B, S, _ = h.shape

    def mm(a, name):
        return prec.matmul(a, prec.weight(w[p + name]))

    xz = mm(h, "in_proj")
    u, z = xz[..., :dI], xz[..., dI:]
    cw = w[p + "conv_w"].to(torch.float32)
    up = torch.cat([u.new_zeros(B, K - 1, dI), u], dim=1)
    u = sum(up[:, j:j + S] * cw[j] for j in range(K)) + w[p + "conv_b"]
    u = F.silu(u)
    proj = mm(u, "x_proj")
    dt, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    if s.get("bcdt_rms"):
        dt, Bm, Cm = _unit_rms(dt, eps), _unit_rms(Bm, eps), _unit_rms(Cm, eps)
    delta = torch.logaddexp(mm(dt, "dt_proj") + w[p + "dt_bias"],
                            torch.zeros((), device=h.device))
    A = -torch.exp(w[p + "A_log"])
    state = h.new_zeros(B, dI, N)
    y = torch.empty_like(u)
    for t0 in range(0, S, STEP_BLOCK):
        sl = slice(t0, min(t0 + STEP_BLOCK, S))
        decay = torch.exp(delta[:, sl, :, None] * A)
        inp = (delta[:, sl] * u[:, sl])[..., None] * Bm[:, sl, None, :]
        for j in range(decay.shape[1]):
            state = decay[:, j] * state + inp[:, j]
            y[:, t0 + j] = (state * Cm[:, t0 + j, None, :]).sum(-1)
    y = y + u * w[p + "D"]
    return mm(y * F.silu(z), "out_proj")


def hidden(w: dict, tokens: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """(B, S) token ids → the final-normed hidden states (B, S, D), float32."""
    eps = cfg["norm_eps"]
    x = w["embed"][tokens].to(torch.float32)
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        x = x + mixer(w, p + "mixer.", rms_norm(x, w[p + "norm_1"].float(),
                                                eps), cfg, prec)
    return rms_norm(x, w["final_norm"].float(), eps)


def logits(w: dict, h: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """Rows of final hidden states (..., D) → logits (..., V), float32."""
    return prec.matmul(h, prec.weight(w["lm_head"]))

"""AdamW with configurable moment precision: f32 / bf16 / int8.

Counterpart of ``repro.optim.adamw``.  The int8 mode stores each moment of
a leaf with two or more dims as a parameter-shaped int8 ``q`` with one f32
absmax ``scale`` per row (the last dim), about 1 byte a parameter a moment
instead of 4; the second moment ``v`` goes through a signed-sqrt transform
first, to spend int8 resolution where ``v`` is small.  Each step rebuilds
the moments in f32, updates them and quantizes them again, so the
quantization error does not accumulate.  1-D leaves (norms, biases) keep
f32 moments.

The state is ``{"step", "m", "v"}`` keyed by the port's parameter names.
``adamw_update`` writes each parameter and its moments in place, one leaf
at a time (the reference's jitted step donates them), so a step holds the
f32 transients of one leaf at most.  The reference bounds those transients
further for stacked leaves above ``SCAN_THRESHOLD`` elements by scanning
over the layer axis; each slice is updated elementwise, so the scan changes
no value, and the port's leaves are one layer each and need none.

On a mesh the leaves, gradients and moments are ``DTensor`` s (the
trainer's tensor-parallel step) and the same code runs on them:
``DTensor`` makes the global norm's sums and an int8 row's absmax over a
last dim split across ranks whole-row reductions (a collective over the
ranks holding the row), and each stored moment keeps the layout it had
(``opt_pspecs``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.distributed.tensor.experimental import implicit_replication


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float | None = 1.0
    moment_dtype: str = "float32"   # 'float32' | 'bfloat16' | 'int8'


def _signed_sqrt(x):
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def _signed_square(x):
    return torch.sign(x) * torch.square(x)


def _store_moment(x: torch.Tensor, dtype: str, transform: bool = False):
    """An f32 moment in its storage form: ``{"q", "scale"}`` for int8 leaves
    of two or more dims, else a tensor of the moment dtype (f32 for 1-D
    leaves in int8 mode)."""
    if dtype == "int8" and x.dim() >= 2:
        t = _signed_sqrt(x) if transform else x
        scale = torch.amax(torch.abs(t), dim=-1, keepdim=True) / 127.0
        q = torch.round(t / torch.clamp_min(scale, 1e-30)).to(torch.int8)
        return {"q": q, "scale": scale.to(torch.float32)}
    if dtype == "int8":
        return x.to(torch.float32)
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _load_moment(stored, transform: bool = False) -> torch.Tensor:
    if isinstance(stored, dict):
        x = stored["q"].to(torch.float32) * stored["scale"]
        return _signed_square(x) if transform else x
    return stored.to(torch.float32)


def init_opt_state(params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """Zero moments for every leaf of ``params`` (name → tensor), on the
    leaves' devices, and an int32 step of 0."""
    def zero(p, transform=False):
        return _store_moment(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device),
                             cfg.moment_dtype, transform)

    device = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {k: zero(p) for k, p in params.items()},
            "v": {k: zero(p, True) for k, p in params.items()}}


def _global_norm(grads, weights=None) -> torch.Tensor:
    """The f32 norm of ``grads`` (name → tensor); ``weights`` (name →
    float, default 1) scale each leaf's sum of squares."""
    total = 0
    for k, g in grads.items():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        w = (weights or {}).get(k)
        total = total + (sq if w is None else sq * w)
    return torch.sqrt(total)


def _as_layout_of(new, old):
    """``new`` (a stored moment) in ``old``'s ``DTensor`` layout."""
    if isinstance(new, dict):
        return {k: _as_layout_of(v, old[k]) for k, v in new.items()}
    if hasattr(old, "placements") and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], state: dict,
                 params: dict[str, torch.Tensor], cfg: AdamWConfig, *,
                 norm_weights: dict[str, float] | None = None):
    """One AdamW step over ``params`` (name → tensor) with ``grads`` of the
    same names.  Writes the parameters and ``state``'s moments in place and
    returns ``(params, state, {"grad_norm", "lr"})``: clipping by the f32
    global norm, decay on leaves of two or more dims only, the bias
    corrections from the f32 step.  ``norm_weights`` scale leaves' squares
    in the norm (a head-padded tree's copied KV heads count once:
    ``dist.sharding.grad_norm_weights``)."""
    with implicit_replication():
        return _update(grads, state, params, cfg, norm_weights)


def _update(grads, state, params, cfg, norm_weights):
    step = state["step"] + 1
    lr = (cfg.learning_rate(step) if callable(cfg.learning_rate)
          else cfg.learning_rate)
    gnorm = _global_norm({k: grads[k] for k in params}, norm_weights)
    if cfg.grad_clip_norm is not None:
        scale = torch.clamp_max(
            cfg.grad_clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    else:
        scale = 1.0
    step_f = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** step_f
    bc2 = 1.0 - cfg.b2 ** step_f

    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m = _load_moment(state["m"][name])
        v = _load_moment(state["v"][name], True)
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if cfg.weight_decay and p.dim() >= 2:      # decay matrices only
            pf = pf * (1.0 - lr * cfg.weight_decay)
        p.copy_(pf - lr * upd)
        state["m"][name] = _as_layout_of(
            _store_moment(m, cfg.moment_dtype), state["m"][name])
        state["v"][name] = _as_layout_of(
            _store_moment(v, cfg.moment_dtype, True), state["v"][name])
    state["step"] = step
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}

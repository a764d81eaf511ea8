"""Activation sharding hints: named layout sites and the policy context.

Counterpart of ``repro.dist.hints``.  The model code never names mesh axes;
it marks layout-critical tensors with ``shard_hint(x, "<site name>")``, and
a launcher installs a *policy* (site name → spec, plus a few ``__dunder__``
entries) around the forward:

    with sharding_policy(dict(policy, __mesh__=mesh)):
        logits, caches = prefill_step(params, tokens, cfg)

The sites of the model stack are :data:`SITE_INVENTORY` (the reference's
docstring names their shapes).  Reserved non-spec keys: ``__mesh__`` (the
``torch.distributed`` ``DeviceMesh`` the specs resolve against),
``__moe_groups__`` (the MoE dispatch group count) and
``__attn_q_chunk__``.

A hint is an exact identity without a policy, for a site the policy does
not name, and for a tensor that is not a ``DTensor``: the unsharded model
computes on plain tensors and never pays for (or depends on) this layer.
On a ``DTensor`` it is ``x.redistribute(mesh, placements)``, the
counterpart of ``with_sharding_constraint``.

``local_call`` is the port's ``shard_map``: it runs a function on the local
shards of its ``DTensor`` arguments, for the ops that have no ``DTensor``
sharding rule (the in-place cache writes at per-row positions, the page
gather, the capacity scatter).  It is valid where the function works along
dims that are not sharded, which is what its callers guarantee.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# Every shard_hint site name the model stack may use (the reference's
# tuple, as it stands).
SITE_INVENTORY = (
    "layer_boundary",
    "sublayer_input",
    "attn_heads",
    "attn_kv",
    "ffn_hidden",
    "mamba_inner",
    "moe_groups",
    "moe_groups4",
    "moe_rows",
    "moe_rows4",
    "moe_logits",
    "logits",
    "embed_grad",
)

_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_policy() -> dict | None:
    """The innermost installed policy, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def sharding_policy(policy):
    """Install ``policy`` (a mapping) for the duration of the context.
    Nested policies shadow outer ones wholesale (no merging)."""
    stack = _stack()
    stack.append(dict(policy))
    try:
        yield
    finally:
        stack.pop()


def checkpointed(fn, *args, **kwargs):
    """``torch.utils.checkpoint`` of ``fn(*args, **kwargs)`` (not
    reentrant) whose recompute runs under the policy of this call.  The
    stack is a thread's, and on the card the autograd engine runs the
    backward, and the recompute inside it, on a device thread of its own,
    which would otherwise see no policy."""
    from torch.utils.checkpoint import checkpoint

    policy = current_policy()

    def under_policy(*a, **kw):
        if policy is None:
            return fn(*a, **kw)
        with sharding_policy(policy):
            return fn(*a, **kw)

    return checkpoint(under_policy, *args, use_reentrant=False, **kwargs)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gathered(x):
    """``x`` whole on the ranks of its mesh (a ``DTensor`` through
    ``full_tensor``, collective over the mesh); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def like(x, ref):
    """``x`` laid out as ``ref`` (both ``DTensor`` s on one mesh; else
    ``x`` as it is): a residual branch takes the residual stream's layout
    before the add, so the reduction of its partial sums is an explicit,
    differentiable step and its backward hands the branch a gradient in
    the branch's own layout."""
    if not (is_dtensor(x) and is_dtensor(ref)) or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def summed(x):
    """``x`` with its partial sums reduced: a ``DTensor``'s ``Partial``
    placements made ``Replicate`` (an all-reduce); else ``x`` as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def whole_along(x, dim: int):
    """``x`` with tensor dim ``dim`` unsplit (a ``DTensor`` gathered over
    the mesh dims that split it; else ``x`` as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def shard_hint(x, name: str):
    """Lay ``x`` out as the policy's spec for ``name`` says (identity
    without a policy, a spec or a mesh, and on a plain tensor).  The spec is
    trimmed to ``x.ndim``, as the reference trims it."""
    pol = current_policy()
    if not pol:
        return x
    spec = pol.get(name)
    mesh = pol.get("__mesh__")
    if spec is None or mesh is None or not is_dtensor(x):
        return x
    from repro_torch.dist.sharding import placements_for

    return x.redistribute(mesh, placements_for(mesh, spec, x.ndim))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_specs, out_specs):
    """``fn(*args)`` on local shards.

    Without a ``DTensor`` among ``args`` this is ``fn(*args)``.  Otherwise
    every ``DTensor`` argument is laid out as its ``in_specs`` entry says
    (``None``: replicated) and passed as its local tensor, plain arguments
    pass as they are, and each output comes back as a ``DTensor`` on the
    same mesh laid out as its ``out_specs`` entry says (``out_specs`` a
    spec or ``None`` for a single output, a tuple for several).  The
    function must not reduce over a sharded dim.

    Under autograd the local tensors carry gradients both ways
    (``to_local`` / ``from_local``).  An argument's gradient is laid out
    as the argument, except over the mesh dims the call's work is split on
    (those where some argument is sharded): an argument replicated there
    gets a partial sum (each rank's part of the function adds its share of
    the gradient).  The gradient leaving ``fn`` for an argument is
    made contiguous first: ``to_local``'s backward wraps it in a
    ``DTensor`` whose global strides are the contiguous ones, and a
    permuted local gradient (einsum's backward gives them) would make the
    views that follow fail on the rank's shard."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import P, placements_for

    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = dts[0].device_mesh
    placed = [placements_for(mesh, spec or P(), a.ndim) if is_dtensor(a)
              else None for a, spec in zip(args, in_specs)]
    split = {i for pl in placed if pl is not None
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    local = []
    for a, pl in zip(args, placed):
        if is_dtensor(a):
            grad_pl = [Partial() if i in split and isinstance(p, Replicate)
                       else p for i, p in enumerate(pl)]
            a = a.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
            if a.requires_grad:
                a = _ContiguousGrad.apply(a)
        local.append(a)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    specs = (out_specs,) if single else out_specs
    wrapped = tuple(
        o if o is None else DTensor.from_local(
            o, mesh, placements_for(mesh, s or P(), o.ndim), run_check=False)
        for o, s in zip(outs, specs))
    return wrapped[0] if single else wrapped

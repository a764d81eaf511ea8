"""Mesh sharding rules: spec trees for params, optimizer moments, caches,
batches, and the default activation hint policy.

Counterpart of ``repro.dist.sharding``.  The port has no ``PartitionSpec``:
a spec is a :class:`P`, a tuple with one entry per tensor dim, each entry
``None`` (replicated), a mesh axis name or a tuple of names.  Everything
but :func:`named` / :func:`reshard_tree` is pure spec construction and
touches no device.

The trees follow the port's leaves.  Parameters are named as
``Transformer.named_parameters()`` names them, one leaf a layer: the
reference stacks a stage's layers on a leading axis and gives that axis a
``None``, so a port layer's spec is the reference's stage spec without its
first entry.  Caches are one tensor a leaf name stacked over the layers
(``models/model.py``), so their specs keep the leading ``None``.

Parameter layout (the reference's):

* 2-D projections are Megatron-style: column-parallel ``(D, F)`` →
  ``P(data, model)``, row-parallel ``(F, D)`` → ``P(model, data)``;
* MoE expert stacks ``(E, D, F)`` / ``(E, F, D)`` put the experts over
  ``model`` and d_model over ``data``;
* ``embed (V, D)`` → ``P(model, data)``, ``lm_head (D, V)`` → ``P(data,
  model)``; 1-D leaves replicate.

``fsdp=False`` drops ``data`` from the weights; ``fsdp_experts_only=True``
keeps it for the expert stacks alone.

On a mesh, a spec becomes ``DTensor`` placements (:func:`placements_for`):
for each mesh dim, ``Shard(d)`` if tensor dim ``d`` names that axis, else
``Replicate()``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.dist.hints import is_dtensor

if TYPE_CHECKING:      # the models import this package for their hints
    from repro_torch.models.config import ModelConfig, ShapeConfig


class P(tuple):
    """A partition spec: ``P(None, "model")``; one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical mesh axis names.  ``pod=None`` on single-pod meshes."""

    pod: str | None = None
    data: str = "data"
    model: str = "model"

    @property
    def batch(self):
        """Axis (or axes) batch-like leading dims shard over."""
        return (self.pod, self.data) if self.pod else self.data

    @property
    def batch_tuple(self) -> tuple[str, ...]:
        return (self.pod, self.data) if self.pod else (self.data,)


# ---------------------------------------------------------------------------
# specs on a mesh
# ---------------------------------------------------------------------------

def placements_for(mesh, spec, ndim: int | None = None) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    dim names).  The spec is trimmed to ``ndim`` entries; an axis the mesh
    does not have is ignored, as an axis of size 1 would be."""
    from torch.distributed.tensor import Replicate, Shard

    entries = tuple(spec)
    if ndim is not None:
        entries = entries[:ndim]
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(entries)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: P

    def placements(self, ndim: int) -> tuple:
        return placements_for(self.mesh, self.spec, ndim)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts / lists / tuples (a
    :class:`P`, a tensor and ``None`` are leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def named(mesh, tree):
    """Bind a spec tree to ``mesh``: every :class:`P` becomes a
    :class:`NamedSharding`."""
    return tree_map(lambda s: None if s is None else NamedSharding(mesh, s),
                    tree)


def mesh_root(mesh) -> int:
    """The lowest global rank of ``mesh``."""
    return int(mesh.mesh.min())


def full_value(x: torch.Tensor, *, src: int | None = None,
               device=None) -> torch.Tensor:
    """The whole value of ``x`` as a plain tensor on every rank of the
    world (collective over the world when anything moves).

    A ``DTensor`` is gathered on its mesh (``full_tensor``) and broadcast
    from the mesh's lowest rank to the ranks outside it, which hold it with
    no local shard.  A ``meta`` tensor is such a rank's shape-only stand-in
    for a value computed on another mesh: it receives the broadcast from
    ``src`` on ``device``.  A plain tensor is the same on every rank and
    comes back as it is."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if is_dtensor(x):
        mesh = x.device_mesh
        src = mesh_root(mesh) if mesh.size() < world else None
        if mesh.get_coordinate() is not None:
            full = x.full_tensor()
        else:
            full = torch.empty(x.shape, dtype=x.dtype,
                               device=x.to_local().device)
    elif x.is_meta:
        full = torch.empty(x.shape, dtype=x.dtype, device=device)
    else:
        return x
    if world > 1 and src is not None:
        full = full.contiguous()
        dist.broadcast(full, src=src)
    return full


def reshard_tree(tree, new_shardings, *, old_shardings=None):
    """Migrate a tree of tensors between shardings, in memory.

    The one resharding primitive of every elastic path: the checkpoint
    restore (``Checkpointer.restore(shardings=...)``), the trainer's
    pod-count residual migration and a live ``ServeEngine.reshard``.

    ``new_shardings`` matches ``tree`` (or a prefix of it: a node covers
    every leaf beneath it) with :class:`NamedSharding` leaves; ``None``
    leaves are left as they are.
    ``old_shardings``, when given, marks leaves already in place (``old ==
    new``), which are skipped.  A ``DTensor`` on the target mesh is
    redistributed; a plain tensor (the same value on every rank) is cut
    into its local shard with no communication (:func:`cut_local`: where
    it lies, so a host tensor's shard alone goes to the card); a
    ``DTensor`` on another
    mesh (two disjoint slices of one world) goes through its whole value,
    gathered on the old mesh and broadcast from its lowest rank, as the
    reference goes through the host.  Values are bitwise unchanged.
    """
    def place(x, new, old):
        if new is None or x is None or (old is not None and old == new):
            return x
        pl = new.placements(x.ndim)
        if is_dtensor(x):
            if x.device_mesh is new.mesh:
                return x.redistribute(new.mesh, pl)
            x = full_value(x)
        return cut_local(x, new.mesh, pl)

    def sub(t, key):
        # a NamedSharding / None at a node covers every leaf beneath it
        return t[key] if isinstance(t, (dict, list, tuple)) else t

    def walk(x, new, old):
        if isinstance(x, dict):
            return {k: walk(v, sub(new, k), sub(old, k))
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, sub(new, i), sub(old, i))
                           for i, v in enumerate(x))
        return place(x, new, old)

    return walk(tree, new_shardings, old_shardings)


def cut_local(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``x`` (a plain tensor holding the same value on every rank) as a
    ``DTensor`` laid out by ``placements`` (shards and replicas): each rank
    slices its own shard where ``x`` lies and moves only that to the
    mesh's device, with no communication.  The values are
    ``distribute_tensor(x, ..., src_data_rank=None)``'s, which would move
    the whole of ``x`` to the device first; that call still serves a
    ``meta`` tensor and a rank outside ``mesh``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if x.is_meta or mesh.get_coordinate() is None:
        return distribute_tensor(x, mesh, placements, src_data_rank=None)
    grad = x.requires_grad
    x = x.detach()
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh,
                                                          placements)
    local = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if x.device.type != mesh.device_type:
        dev = (torch.device("cpu") if mesh.device_type == "cpu" else
               torch.device(mesh.device_type, torch.get_device_module(
                   mesh.device_type).current_device()))
        local = local.to(dev)
    out = DTensor.from_local(local.contiguous(), mesh, placements,
                             run_check=False, shape=x.shape,
                             stride=torch.empty(x.shape,
                                                device="meta").stride())
    return out.requires_grad_(True) if grad else out


def to_plain(tree, device, *, src: int | None = None):
    """Every leaf of ``tree`` as a plain tensor holding its whole value on
    every rank, on ``device`` (moving a replica off its mesh; ``src``: the
    old mesh's lowest rank, for the ``meta`` stand-ins of the ranks outside
    it)."""
    return tree_map(lambda x: None if x is None
                    else full_value(x, src=src, device=device).to(device),
                    tree)


def from_local_like(local: torch.Tensor, like, shape) -> torch.Tensor:
    """``local`` as a ``DTensor`` laid out like ``like`` with global
    ``shape`` (contiguous)."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


# ---------------------------------------------------------------------------
# uneven head counts: padding within GQA groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadPadding:
    """The attention heads of a config laid out over a model axis that does
    not divide them (the reference's GSPMD pads such a dim).

    The KV heads are padded with zero groups up to ``groups``, and each
    group is copied ``copies`` times (adjacent copies), so ``kv_heads =
    groups * copies`` is a multiple of the axis.  A group's ``G`` query
    heads split into ``copies`` sub-groups of ``sub`` heads, each reading
    its own copy; a sub-group's missing heads are zero heads.  So every
    padded query head still reads its own KV head, and a rank holds whole
    sub-groups with their KV head.  ``q_src`` / ``kv_src`` give, for each
    padded head, the original head it holds (-1: a zero head)."""

    heads: int
    kv_heads: int
    copies: int
    q_src: tuple[int, ...]
    kv_src: tuple[int, ...]


def model_axis_size(mesh, ax: MeshAxes | None = None) -> int:
    """The size of ``mesh``'s model axis (1 without a mesh or the axis)."""
    name = (ax or MeshAxes()).model
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def head_padding(cfg: ModelConfig, m: int) -> HeadPadding | None:
    """How ``cfg``'s heads pad over a model axis of ``m`` ranks; None when
    the axis divides them (or the model has no attention layer).  Of the
    layouts that split evenly, the one with the fewest query heads (then
    KV heads) is taken.  MLA has no KV heads (its latent cache is shared by
    every head): its query heads pad at the end."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if m <= 1 or "attn" not in kinds:
        return None
    H = cfg.num_heads
    KV = H if cfg.attn_type == "mla" else cfg.num_kv_heads
    if KV % m == 0:
        return None
    G = H // KV
    best = None
    for groups in range(KV, KV + m + 1):
        for copies in range(1, m + 1):
            kvp = groups * copies
            if kvp % m:
                continue
            sub = -(-G // copies)
            key = (kvp * sub, kvp, groups, copies)
            best = key if best is None or key < best else best
    hp, kvp, groups, copies = best
    sub = hp // kvp
    q_src, kv_src = [], []
    for g in range(groups):
        for c in range(copies):
            kv_src.append(g if g < KV else -1)
            for i in range(sub):
                j = c * sub + i
                q_src.append(g * G + j if g < KV and j < G else -1)
    return HeadPadding(hp, kvp, copies, tuple(q_src), tuple(kv_src))


def padded_config(cfg: ModelConfig, m: int) -> ModelConfig:
    """``cfg`` as its model runs over a model axis of ``m`` ranks: the
    padded head counts of :func:`head_padding` (``head_dim`` kept), or
    ``cfg`` itself when nothing pads."""
    hp = head_padding(cfg, m)
    if hp is None:
        return cfg
    kv = hp.heads if cfg.attn_type == "mla" else hp.kv_heads
    return cfg.with_(num_heads=hp.heads, num_kv_heads=kv,
                     head_dim=cfg.head_dim)


def _head_leaf(cfg: ModelConfig, name: str, ndim: int):
    """(axis, unit, which source) of a parameter leaf with a head dim, or
    None: the GQA projections hold ``unit = head_dim`` columns (rows for
    ``wo``) a head, MLA's up-projections a head dim of their own."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-2] != "mixer":
        return None
    leaf = parts[-1]
    if cfg.attn_type == "mla":
        if leaf in ("w_uq", "w_uk", "w_uv") or (leaf == "wq" and ndim == 3):
            return 1, 1, "q"
        if leaf == "wo":
            return 0, cfg.v_head_dim, "q"
        return None
    if leaf == "wq":
        return 1, cfg.head_dim, "q"
    if leaf in ("wk", "wv"):
        return 1, cfg.head_dim, "kv"
    if leaf == "wo":
        return 0, cfg.head_dim, "q"
    return None


def _select_heads(t: torch.Tensor, axis: int, unit: int, index,
                  keep=None) -> torch.Tensor:
    """``t`` with its head dim (``axis``, ``unit`` entries a head) rebuilt
    from the heads ``index`` names; where ``keep`` is False, zeros."""
    axis = axis % t.ndim
    shape = tuple(t.shape)
    n = shape[axis] // unit
    v = t.reshape(*shape[:axis], n, unit, *shape[axis + 1:])
    idx = torch.as_tensor(index, dtype=torch.int64, device=t.device)
    out = v.index_select(axis, idx)
    if keep is not None:
        mask = torch.as_tensor(keep, dtype=torch.bool, device=t.device)
        mask = mask.reshape((-1,) + (1,) * (out.ndim - axis - 1))
        out = torch.where(mask, out, torch.zeros((), dtype=t.dtype,
                                                 device=t.device))
    return out.reshape(*shape[:axis], len(idx) * unit, *shape[axis + 1:])


def _pad_leaf(t, hp: HeadPadding, axis: int, unit: int, which: str):
    src = hp.q_src if which == "q" else hp.kv_src
    return _select_heads(t, axis, unit, [max(s, 0) for s in src],
                         [s >= 0 for s in src])


def _unpad_leaf(t, hp: HeadPadding, axis: int, unit: int, which: str):
    src = hp.q_src if which == "q" else hp.kv_src
    first: dict[int, int] = {}
    for j, s in enumerate(src):
        if s >= 0:
            first.setdefault(s, j)
    return _select_heads(t, axis, unit, [first[s] for s in sorted(first)])


def _in_proj_order(cfg: ModelConfig, m: int) -> list[int] | None:
    """The column order of a Mamba ``in_proj`` (D, 2 · d_inner) on a model
    axis of ``m``: rank r's block holds its d_inner shard of ``u`` then the
    same shard of ``z``, so the block's split into ``u`` and ``z`` is the
    rank's own (``models/mamba.py``); the unpermuted columns would put ``u``
    on half the ranks and ``z`` on the other half, and the split would
    gather the (B, S, 2 · d_inner) activation.  None without Mamba layers
    or a model axis."""
    if cfg.ssm is None or m <= 1:
        return None
    dI = cfg.ssm.d_inner
    w = dI // m
    order: list[int] = []
    for r in range(m):
        order += list(range(r * w, (r + 1) * w))
        order += list(range(dI + r * w, dI + (r + 1) * w))
    return order


def _is_in_proj(name: str) -> bool:
    return name.endswith("mixer.in_proj")


def pad_params(tree: dict, cfg: ModelConfig, m: int) -> dict:
    """A parameter tree (name → plain tensor) laid out for a model axis of
    ``m``: head dims padded (:func:`head_padding`: zero query heads with
    zero rows of ``wo``, KV heads copied or zero) and Mamba's ``in_proj``
    columns in :func:`_in_proj_order`.  The tree itself when nothing
    changes."""
    hp = head_padding(cfg, m)
    order = _in_proj_order(cfg, m)
    if hp is None and order is None:
        return tree
    out = {}
    for name, t in tree.items():
        rule = _head_leaf(cfg, name, t.ndim) if hp is not None else None
        if rule is not None:
            t = _pad_leaf(t, hp, *rule)
        elif order is not None and _is_in_proj(name):
            t = t.index_select(1, torch.as_tensor(order, device=t.device))
        out[name] = t
    return out


def unpad_params(tree: dict, cfg: ModelConfig, m: int) -> dict:
    """:func:`pad_params` undone: each original head from its first copy,
    ``in_proj``'s columns in their own order."""
    hp = head_padding(cfg, m)
    order = _in_proj_order(cfg, m)
    if hp is None and order is None:
        return tree
    inverse = None
    if order is not None:
        inverse = [0] * len(order)
        for j, c in enumerate(order):
            inverse[c] = j
    out = {}
    for name, t in tree.items():
        rule = _head_leaf(cfg, name, t.ndim) if hp is not None else None
        if rule is not None:
            t = _unpad_leaf(t, hp, *rule)
        elif inverse is not None and _is_in_proj(name):
            t = t.index_select(1, torch.as_tensor(inverse, device=t.device))
        out[name] = t
    return out


def _cache_head_rule(cfg: ModelConfig, name: str):
    # GQA cache leaves (..., KV, head_dim); MLA's latent leaves have no heads
    return (-2, 1, "kv") if name in ("k", "v") else None


def pad_caches(tree: dict, cfg: ModelConfig, m: int) -> dict:
    """A cache, page-pool or page-snapshot tree (leaf name → plain tensor,
    the KV heads second to last) padded like the parameters."""
    hp = head_padding(cfg, m)
    if hp is None:
        return tree
    return {n: t if _cache_head_rule(cfg, n) is None
            else _pad_leaf(t, hp, *_cache_head_rule(cfg, n))
            for n, t in tree.items()}


def unpad_caches(tree: dict, cfg: ModelConfig, m: int) -> dict:
    """:func:`pad_caches` undone."""
    hp = head_padding(cfg, m)
    if hp is None:
        return tree
    return {n: t if _cache_head_rule(cfg, n) is None
            else _unpad_leaf(t, hp, *_cache_head_rule(cfg, n))
            for n, t in tree.items()}


def tie_padded_grads(grads: dict, cfg: ModelConfig, m: int) -> dict:
    """Gradients of a padded parameter tree made those of the unpadded
    model: each KV head's copies get the sum of the copies' gradients (the
    gradient of the one original head, so the copies stay equal), and the
    zero heads a zero gradient (their ``wo`` rows would otherwise learn
    from the KV copies their zero queries average).  The tree itself when
    nothing pads.  A ``DTensor`` leaf is made whole over its head dim for
    the fold (a collective over the mesh) and laid out as it was."""
    hp = head_padding(cfg, m)
    if hp is None:
        return grads
    out = {}
    for name, g in grads.items():
        rule = _head_leaf(cfg, name, g.ndim)
        if rule is None:
            out[name] = g
            continue
        axis, unit, which = rule
        src = hp.q_src if which == "q" else hp.kv_src

        def fold(t):
            if which == "kv" and hp.copies > 1:
                shape = tuple(t.shape)
                n = len(src) // hp.copies
                v = t.reshape(*shape[:axis], n, hp.copies, unit,
                              *shape[axis + 1:])
                t = v.sum(dim=axis + 1, keepdim=True).expand(
                    v.shape).reshape(shape)
            keep = torch.as_tensor([s >= 0 for s in src], device=t.device)
            keep = keep.repeat_interleave(unit).reshape(
                (-1,) + (1,) * (t.ndim - axis - 1)).to(t.dtype)
            return t * keep

        if is_dtensor(g):
            # the fold on each rank's shard with the head dim made whole;
            # the other placements (a partial sum too) pass through
            from torch.distributed.tensor import DTensor, Replicate, Shard

            placements, mesh = g.placements, g.device_mesh
            whole = [Replicate() if isinstance(p, Shard) and p.dim == axis
                     else p for p in placements]
            g = g.redistribute(mesh, whole)
            g = DTensor.from_local(fold(g.to_local()), mesh, whole,
                                   run_check=False, shape=g.shape,
                                   stride=g.stride())
            g = g.redistribute(mesh, placements)
        else:
            g = fold(g)
        out[name] = g
    return out


def settle_grads(grads: dict, params: dict, *,
                 keep_partial: int | None = None) -> dict:
    """Each ``DTensor`` gradient laid out as its parameter: the partial sums
    ``DTensor``'s backward leaves over the mesh dims the batch is split on
    are reduced there (an all-reduce, or a reduce-scatter onto an FSDP
    shard), the counterpart of GSPMD's gradient reduction.
    ``keep_partial``: a mesh dim left a partial sum where it is one (the
    pod dim, which the trainer reduces itself)."""
    out = {}
    for name, g in grads.items():
        p = params[name]
        if is_dtensor(g):
            target = list(p.placements)
            if keep_partial is not None and \
                    g.placements[keep_partial].is_partial():
                target[keep_partial] = g.placements[keep_partial]
            if tuple(g.placements) != tuple(target):
                g = g.redistribute(p.device_mesh, target)
        out[name] = g
    return out


def grad_norm_weights(cfg: ModelConfig, m: int) -> dict | None:
    """Per-leaf weights of the squared gradient in the global norm, so a
    padded tree's norm is the unpadded model's: ``1 / copies`` for the KV
    leaves whose heads are copied (:func:`tie_padded_grads` gives every
    copy the whole gradient).  None when nothing is copied."""
    hp = head_padding(cfg, m)
    if hp is None or hp.copies == 1:
        return None
    from repro_torch.models import model as model_mod

    return {name: 1.0 / hp.copies
            for name, p in model_mod.param_specs(cfg).named_parameters()
            if (_head_leaf(cfg, name, p.ndim) or (0, 0, ""))[2] == "kv"}


# ---------------------------------------------------------------------------
# parameter / optimizer specs
# ---------------------------------------------------------------------------

# Megatron column-parallel (input dim, output features) / row-parallel
# (input features, output dim) 2-D projections, by leaf name.
_COL2 = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj"}
_ROW2 = {"wo", "w_down", "out_proj"}
# MLA low-rank down-projections: (D, rank) — rank too small to TP-shard.
_MLA_DOWN = {"w_dkv", "w_kr", "w_dq"}
# MLA up-projections: (rank, H, head_dim) — heads over model.
_MLA_UP = {"w_uk", "w_uv", "w_uq"}


def _param_rule(keys: list[str], shape: tuple[int, ...], ax: MeshAxes,
                fsdp: bool, fsdp_experts_only: bool) -> P:
    """Spec for one (unstacked) parameter leaf."""
    name = keys[-1]
    nd = len(shape)
    is_expert = "experts" in keys
    d = ax.data if (fsdp or (fsdp_experts_only and is_expert)) else None
    m = ax.model

    if nd <= 1:
        return P()
    if name == "embed":
        return P(m, d)
    if name == "lm_head":
        return P(d, m)
    if is_expert and nd == 3:
        # (E, D, F) gate/up vs (E, F, D) down: d_model gets the FSDP axis
        return P(m, d, None) if name in ("w_gate", "w_up") else P(m, None, d)
    if name == "router" or name in _MLA_DOWN:
        return P(d, None)
    if name in _MLA_UP:
        return P(None, m, None)
    if name == "wq" and nd == 3:           # MLA direct q: (D, H, e)
        return P(d, m, None)
    if name in _COL2:
        return P(d, m)
    if name in _ROW2:
        return P(m, d)
    if name in ("x_proj", "A_log"):        # mamba (dI, ·)
        return P(m, None)
    if name in ("dt_proj", "conv_w"):      # mamba (·, dI)
        return P(None, m)
    return P()


def param_pspecs(cfg: ModelConfig, ax: MeshAxes, *, fsdp: bool = True,
                 fsdp_experts_only: bool = False) -> dict[str, P]:
    """Parameter name → spec, for every parameter of the model."""
    from repro_torch.models import model as model_mod

    return {name: _param_rule(name.split("."), tuple(p.shape), ax, fsdp,
                              fsdp_experts_only)
            for name, p in model_mod.param_specs(cfg).named_parameters()}


def opt_pspecs(param_pspecs: dict, moment_dtype: str, ax: MeshAxes, *,
               param_shapes: dict | None = None) -> dict:
    """Optimizer-state specs mirroring ``optim.adamw.init_opt_state``.

    Moments inherit the parameter spec leaf by leaf.  ``int8`` moments of
    >= 2-D leaves are ``{"q": param-shaped, "scale": (..., 1)}``: ``q``
    keeps the parameter spec, ``scale`` replicates its last (length-1)
    dim.  ``param_shapes`` (name → shape) gives the leaves' ranks; without
    it the spec's own length is used, which is right only for full-rank
    specs."""
    def moment(name: str, spec: P):
        ndim = (len(param_shapes[name]) if param_shapes is not None
                else len(spec))
        if moment_dtype == "int8" and ndim >= 2:
            entries = list(spec) + [None] * (ndim - len(spec))
            return {"q": spec, "scale": P(*entries[:-1], None)}
        return spec

    m = {name: moment(name, spec) for name, spec in param_pspecs.items()}
    return {"step": P(), "m": m, "v": m}


def batch_pspec(ax: MeshAxes, shape_cfg: ShapeConfig | None = None, *,
                batch_shard: bool = True) -> P:
    """(B, S) token / label batches: batch over (pod,) data, sequence
    local.  ``batch_shard=False`` replicates the batch dim (the serve
    replica's layout)."""
    return P(ax.batch if batch_shard else None, None)


def _cache_rule(name: str, ax: MeshAxes, seq_shard: bool,
                batch_shard: bool = True) -> P:
    """Spec of one cache leaf, with the leading layer-stack dim."""
    b, m = ax.batch if batch_shard else None, ax.model
    if name in ("k", "v"):            # (B, Smax, KV, hd)
        spec = P(b, m, None, None) if seq_shard else P(b, None, m, None)
    elif name in ("ckv", "kr"):       # MLA latent (B, Smax, R / rope)
        spec = P(b, m, None) if seq_shard else P(b, None, None)
    elif name == "conv":              # mamba (B, K-1, dI)
        spec = P(b, None, m)
    elif name == "ssm":               # mamba (B, dI, N)
        spec = P(b, m, None)
    else:
        spec = P(b)
    return P(None, *spec)


def cache_pspecs(cfg: ModelConfig, ax: MeshAxes, shape_cfg: ShapeConfig, *,
                 seq_shard: bool = False, batch_shard: bool = True) -> dict:
    """Specs for the cache tree of ``model.cache_specs``: batch over
    (pod,) data and KV heads over ``model`` by default; ``seq_shard=True``
    puts the cache sequence over ``model`` instead (flash-decode layout);
    ``batch_shard=False`` replicates the batch dim (serve replica)."""
    from repro_torch.models import model as model_mod

    specs = model_mod.cache_specs(cfg, shape_cfg.global_batch,
                                  shape_cfg.seq_len)
    return {name: _cache_rule(name, ax, seq_shard, batch_shard)
            for name in specs}


def activation_hint_policy(cfg: ModelConfig, ax: MeshAxes,
                           shape_cfg: ShapeConfig, *,
                           model_axis_size: int | None = None,
                           batch_shard: bool = True) -> dict:
    """Default site → spec policy for the model's hint sites.

    Batch-like dims over (pod,) data; the sequence over ``model`` at layer
    boundaries for train / prefill (decode has S = 1); heads, hidden and
    d_inner over ``model`` inside the blocks.  MoE expert rows put E over
    ``model``; the group layouts (and ``__moe_groups__`` = global batch x
    model-axis size) only with ``model_axis_size`` for train / prefill.
    ``batch_shard=False`` replicates batch-like dims (serve replica)."""
    b, m = ax.batch if batch_shard else None, ax.model
    seq = m if shape_cfg.kind in ("train", "prefill") else None
    pol: dict = {
        "layer_boundary": P(b, seq, None),
        "logits": P(b, None, m),
        "embed_grad": P(m, ax.data),
        "ffn_hidden": P(b, None, m),
    }
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if "attn" in kinds:
        pol["attn_heads"] = P(b, None, m, None)
    if "mamba" in kinds:
        pol["mamba_inner"] = P(b, None, m)
    if cfg.moe is not None:
        pol["moe_rows"] = P(m, b, None)
        pol["moe_rows4"] = P(m, b, None, None)
        if model_axis_size is not None and shape_cfg.kind in ("train",
                                                              "prefill"):
            gax = ax.batch_tuple + (m,)
            pol["moe_groups"] = P(gax, None, None)
            pol["moe_groups4"] = P(gax, None, None, None)
            pol["moe_logits"] = P(gax, None, None)
            pol["__moe_groups__"] = shape_cfg.global_batch * model_axis_size
    return pol


def page_pspecs(cfg: ModelConfig, ax: MeshAxes, *,
                seq_shard: bool = False) -> dict:
    """Specs for a ``serve.paging`` pool tree.  Pool leaves have the rank
    of their dense cache leaves (the batch axis becomes the page or state
    slot axis, ``Smax`` becomes ``page_size``), so the cache rule applies
    as it is, with the page dim replicated like a serve replica's batch."""
    from repro_torch.models.config import ShapeConfig

    shape_cfg = ShapeConfig("serve", "decode", 1, 1)   # structure-only
    return cache_pspecs(cfg, ax, shape_cfg, seq_shard=seq_shard,
                        batch_shard=False)


def replica_pspecs(cfg: ModelConfig, ax: MeshAxes, *, fsdp: bool = True,
                   seq_shard: bool = False) -> dict:
    """Spec bundle for one mesh-backed serve replica: ``{"params",
    "cache", "batch", "policy"}``.  A replica's slice parallelizes the
    model (TP heads / hidden, FSDP weights), never the request batch; the
    policy comes without ``__mesh__``, which the engine binds."""
    from repro_torch.models.config import ShapeConfig

    shape_cfg = ShapeConfig("serve", "decode", 1, 1)   # structure-only
    return {
        "params": param_pspecs(cfg, ax, fsdp=fsdp),
        "cache": cache_pspecs(cfg, ax, shape_cfg, seq_shard=seq_shard,
                              batch_shard=False),
        "batch": batch_pspec(ax, shape_cfg, batch_shard=False),
        "policy": activation_hint_policy(cfg, ax, shape_cfg,
                                         batch_shard=False),
    }

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
    into its local shard with no communication; a ``DTensor`` on another
    mesh (two disjoint slices of one world) goes through its whole value,
    gathered on the old mesh and broadcast from its lowest rank, as the
    reference goes through the host.  Values are bitwise unchanged.
    """
    from torch.distributed.tensor import distribute_tensor

    def place(x, new, old):
        if new is None or x is None or (old is not None and old == new):
            return x
        pl = new.placements(x.ndim)
        if is_dtensor(x):
            if x.device_mesh is new.mesh:
                return x.redistribute(new.mesh, pl)
            x = full_value(x)
        return distribute_tensor(x, new.mesh, pl, src_data_rank=None)

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

"""Training loop: the train step (gradient accumulation, optional int8
cross-pod gradient compression) and the checkpoint/restart orchestration
around it.

Counterpart of ``repro.train.trainer``.  ``make_train_step`` builds
``step(params, opt_state, residual, batch) -> (params, opt_state, residual,
metrics)``; ``params`` is the model (``models.model.Transformer``), updated
in place.  ``residual`` is the error-feedback state of the int8 cross-pod
reduction: ``None`` on the uncompressed paths, the rank's own row of the
stacked per-pod tree on the compressed one (``dist.compression``).

**Pods are processes.**  The reference vmaps the gradient over a leading
pod dim and reduces it in a ``shard_map`` over the pod axis.  Here a mesh
over ``(pod, data[, model])`` is one process a device (``launch.mesh``):
each rank computes the gradients of its slice of the global batch (the
pod's rows, cut again over ``data``), the ranks of a pod average theirs
exactly over the ``data`` group, and the pod means meet in the exact
(``psum_mean``) or int8 (``compressed_psum_mean``) reduction over the
``pod`` group.  Every rank then takes the same AdamW step on the same
numbers, so the replicated parameters stay bitwise equal.

**Tensor parallelism.**  A mesh with a ``model`` axis runs the model on
``DTensor`` s (:class:`TrainLayout`): the parameters and optimizer state
are laid out by ``param_pspecs`` / ``opt_pspecs`` (replicated over
``pod``; heads the model axis does not divide padded,
``dist.sharding.pad_params``), a rank's rows are its ``(pod, data)`` slice
of the batch, shared by its model group, and the step runs under
``activation_hint_policy(..., model_axis_size=m)``.  The loss is the whole
batch's, as in the reference's sharded step (the MoE balance terms are
means over every pod's tokens).  ``DTensor``'s backward reduces the
gradients over ``data`` and ``model`` (``settle_grads``) and leaves each
pod's partial sum; the exact or int8 pod reduction then runs on each
rank's local shards (a pod's share scaled by the pod count, so their mean
is the sum), the int8 scales max-reduced over the pod's ranks as well,
so each is the whole leaf's absmax.  The error-feedback residual of a
leaf is laid out as ``P(pod, *its spec)``.

``Trainer`` adds the fault-tolerance loop: periodic async checkpoints of
the parameters, the optimizer state and, compressed, the residual in its
global ``(num_pods, *shape)`` form with ``num_pods`` in the metadata
(written by rank 0); an exact restart from the latest one, placing each
pod's residual row back through ``Checkpointer.restore(shardings=)``; a
pod-count change reshards the residual so ``Σe/n`` holds; and a
step-indexed data stream, so a restart replays nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.dist.compression import (
    EXACT_BYTES_PER_ELEM,
    WIRE_BYTES_PER_ELEM,
    WIRE_SCALE_BYTES_PER_LEAF,
    compressed_psum_mean,
    psum_mean,
    reshard_residual,
)
from repro_torch.dist.hints import gathered, sharding_policy
from repro_torch.dist.sharding import (MeshAxes, NamedSharding, P,
                                       activation_hint_policy, batch_pspec,
                                       cut_local, from_local_like,
                                       grad_norm_weights,
                                       model_axis_size, named, opt_pspecs,
                                       pad_params, padded_config,
                                       param_pspecs, placements_for,
                                       reshard_tree, settle_grads,
                                       tie_padded_grads, tree_map,
                                       unpad_params)
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import (Transformer, init_params, loss_fn,
                                      param_shapes, param_specs)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

# Metrics that are COUNTS over the batch (extensive): summed across
# microbatches and pods, so totals stay comparable to a plain step on the
# whole batch; everything else (ce, aux / z losses, ...) is a per-token
# mean (intensive) and is averaged.
EXTENSIVE_METRICS = frozenset({"expert_load"})


def _pod_layout(mesh, pod_axis: str):
    """(pod group, pods, pod index, data group, data ranks, data index) of
    this rank on ``mesh``."""
    names = mesh.mesh_dim_names
    if pod_axis not in names:
        raise ValueError(f"mesh {names} has no pod axis {pod_axis!r}")
    pod_group = mesh.get_group(pod_axis)
    num_pods = mesh.size(names.index(pod_axis))
    pod = mesh.get_local_rank(pod_axis)
    if "data" in names:
        return (pod_group, num_pods, pod, mesh.get_group("data"),
                mesh.size(names.index("data")), mesh.get_local_rank("data"))
    return pod_group, num_pods, pod, None, 1, 0


def scale_groups(cfg: ModelConfig, names) -> dict[str, str]:
    """Parameter name → the reference leaf that holds it: a stage's layers
    share one stacked leaf there (``stages/sub{j}/...``), so they share one
    int8 scale in ``compressed_psum_mean``, as in the reference."""
    fd, period = cfg.first_dense_layers, cfg.period
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) >= fd:
            j = (int(parts[1]) - fd) % period
            out[name] = ".".join(["stages", f"sub{j}", *parts[2:]])
        else:
            out[name] = name
    return out


class TrainLayout:
    """One training state on a ``(pod, data, model)`` mesh (the
    tensor-parallel step's layout; see the module docstring).

    The parameters and the optimizer state live on ``mesh`` as ``DTensor``
    s laid out by ``param_pspecs(run_cfg, ax, fsdp=)`` / ``opt_pspecs``
    (``ax`` names the pod axis, which they replicate over), where
    ``run_cfg`` is the config with its heads padded for the model axis.
    :meth:`place_params` / :meth:`place_opt` / :meth:`place_residual` lay
    out a plain (meshless, unpadded) state, a leaf at a time: each leaf is
    padded where it lies (the host, for a restored checkpoint) and only a
    rank's shard of it goes to the device.  :meth:`plain_params` /
    :meth:`plain_opt` / :meth:`plain_residual` give it back whole and
    unpadded on the host (collective; one leaf at a time is whole on the
    device), which is the checkpoint's layout."""

    def __init__(self, cfg: ModelConfig, mesh, pod_axis: str = "pod", *,
                 fsdp: bool = True):
        names = mesh.mesh_dim_names
        if "model" not in names or pod_axis not in names:
            raise ValueError(f"mesh {names} needs a {pod_axis!r} and a "
                             f"model axis")
        self.cfg, self.mesh, self.pod_axis = cfg, mesh, pod_axis
        self.pod_dim = names.index(pod_axis)
        self.ax = MeshAxes(pod=pod_axis)
        self.m = model_axis_size(mesh, self.ax)
        self.run_cfg = padded_config(cfg, self.m)
        self.pspecs = param_pspecs(self.run_cfg, self.ax, fsdp=fsdp)

    def place_params(self, params) -> Transformer:
        """A model of ``DTensor`` parameters (gradients on) holding
        ``params``' values (a model, or name → tensor), padded and laid
        out on ``mesh``."""
        shell = param_specs(self.run_cfg)
        for name, t in _named(params):
            t = pad_params({name: t.detach()}, self.cfg, self.m)[name]
            placed = reshard_tree(t, NamedSharding(self.mesh,
                                                   self.pspecs[name]))
            mod_name, _, leaf = name.rpartition(".")
            mod = shell.get_submodule(mod_name) if mod_name else shell
            setattr(mod, leaf, torch.nn.Parameter(placed, requires_grad=True))
        return shell

    def _opt_specs(self, moment_dtype: str) -> dict:
        specs = opt_pspecs(self.pspecs, moment_dtype, self.ax,
                           param_shapes=param_shapes(self.run_cfg))
        specs["step"] = None           # a plain counter on every rank
        return specs

    def place_opt(self, opt_state: dict, moment_dtype: str) -> dict:
        """``opt_state`` (plain, unpadded) padded and laid out on
        ``mesh``."""
        specs = named(self.mesh, self._opt_specs(moment_dtype))
        out = {"step": opt_state["step"]}
        for k in ("m", "v"):
            out[k] = {}
            for name, mo in opt_state[k].items():
                padded = self._moment(name, mo, pad=True)
                out[k][name] = reshard_tree(padded, specs[k][name])
        return out

    def _moment(self, name: str, mo, *, pad: bool):
        """A moment leaf through ``pad_params`` / ``unpad_params``; an int8
        leaf's row scales only where its rows hold heads (a head dim in the
        columns leaves the row's absmax unchanged: padded heads are zero,
        copied ones equal)."""
        fn = pad_params if pad else unpad_params
        if not isinstance(mo, dict):
            return fn({name: mo}, self.cfg, self.m)[name]
        q = fn({name: mo["q"]}, self.cfg, self.m)[name]
        sc = mo["scale"]
        if q.shape[0] != mo["q"].shape[0]:      # rows hold heads
            sc = fn({name: sc}, self.cfg, self.m)[name]
        return {"q": q, "scale": sc}

    def plain_params(self, params, *, keep: bool = True) -> dict:
        """The parameters whole and unpadded on the host (name → plain
        tensor; collective).  ``keep=False``: this rank takes part in the
        gathers and keeps nothing (an empty dict)."""
        out = {}
        for name, p in _named(params):
            whole = _host(p.detach())
            if keep:
                out[name] = unpad_params({name: whole}, self.cfg,
                                         self.m)[name]
        return out

    def plain_opt(self, opt_state: dict, *, keep: bool = True) -> dict:
        """The optimizer state whole and unpadded on the host (collective;
        ``keep`` as in :meth:`plain_params`)."""
        out = {"step": opt_state["step"].detach().cpu()}
        for k in ("m", "v"):
            out[k] = {}
            for name, mo in opt_state[k].items():
                whole = tree_map(_host, mo)
                if keep:
                    out[k][name] = self._moment(name, whole, pad=False)
        return out

    def place_residual(self, residual: dict, num_pods: int) -> dict:
        """A rank's rows of a stacked ``(num_pods, *shape)`` unpadded
        residual (name → plain tensor): each pod's row padded, laid out by
        :meth:`residual_sharding`, and this rank's local shard taken."""
        out = {}
        for name, e in residual.items():
            rows = torch.stack([pad_params({name: r}, self.cfg, self.m)[name]
                                for r in e])
            full = (num_pods, *rows.shape[1:])
            sh = self.residual_sharding(name)
            out[name] = cut_local(rows, self.mesh,
                                  sh.placements(len(full))).to_local()
        return out

    def plain_residual(self, residual: dict, num_pods: int, *,
                       keep: bool = True) -> dict:
        """The stacked ``(num_pods, *shape)`` residual, whole and unpadded
        on the host, from each rank's local rows (collective; ``keep`` as
        in :meth:`plain_params`)."""
        shapes = param_shapes(self.run_cfg)
        out = {}
        for name, e in residual.items():
            full = (num_pods, *shapes[name])
            sh = self.residual_sharding(name)
            whole = _host(DTensor.from_local(
                e.detach(), self.mesh, sh.placements(len(full)),
                run_check=False, shape=torch.Size(full),
                stride=torch.empty(full, device="meta").stride()))
            if keep:
                out[name] = torch.stack([
                    unpad_params({name: r}, self.cfg, self.m)[name]
                    for r in whole])
        return out

    def residual_sharding(self, name: str):
        """Where leaf ``name``'s stacked ``(num_pods, *shape)`` residual
        lives: ``P(pod, *its spec)`` on the whole mesh, so a rank holds its
        pod's row of its own shard."""
        spec = tuple(self.pspecs[name])
        spec += (None,) * (len(param_shapes(self.run_cfg)[name]) - len(spec))
        return NamedSharding(self.mesh, P(self.pod_axis, *spec))

    def batch(self, rows: torch.Tensor):
        """The global (B, S) batch as a ``DTensor``, the rows over ``(pod,
        data)`` (each rank cuts its own rows; nothing moves)."""
        return distribute_tensor(rows, self.mesh, placements_for(
            self.mesh, batch_pspec(self.ax), rows.ndim), src_data_rank=None)


def _named(params):
    return (params.named_parameters() if isinstance(params, torch.nn.Module)
            else params.items())


def _host(x):
    """``x`` whole on the host (a ``DTensor`` gathered; collective)."""
    return None if x is None else gathered(x).cpu()


def _reduce_metrics(metrics: dict, group, n: int) -> dict:
    """Intensive metrics meaned over ``group``'s ranks, extensive summed."""
    if n == 1:
        return metrics
    out = {}
    for k, v in metrics.items():
        t = v.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        out[k] = t if k in EXTENSIVE_METRICS else t / n
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, pod_axis: str | None = None,
                    compress_pods: bool = False, mesh=None,
                    layout: TrainLayout | None = None):
    """Returns ``step(params, opt_state, residual, batch) -> (params,
    opt_state, residual, metrics)``.

    ``microbatches > 1`` accumulates the gradients of ``B / microbatches``
    row slices in f32 buffers, as the reference's scan does, and normalizes
    once; the loss and the intensive metrics are averaged over the
    microbatches, ``EXTENSIVE_METRICS`` summed.  ``metrics`` is ``{loss,
    ce, [aux_loss, z_loss, expert_load], grad_norm, lr}``, detached, on the
    parameters' device.

    ``pod_axis`` (with ``mesh``, a ``DeviceMesh`` naming it): the pod step
    (see the module docstring); ``batch`` is the GLOBAL batch on every
    rank, each rank takes its rows.  ``compress_pods``: the pod reduction is
    ``compressed_psum_mean`` and ``residual`` is the rank's ``{name: (1,
    *shape)}`` f32 row (``None``: a cold start at zeros); otherwise
    ``residual`` passes through.

    With a ``model`` axis in ``mesh`` the step is tensor-parallel (see the
    module docstring): ``params`` and ``opt_state`` are ``layout``'s (a
    :class:`TrainLayout` of ``mesh``, built here by default), placed with
    its ``place_params`` / ``place_opt``; the residual row holds the rank's
    local shards."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if pod_axis is not None and mesh is None:
        raise ValueError("make_train_step(pod_axis=...) needs the mesh")

    tp = pod_axis is not None and "model" in mesh.mesh_dim_names
    if tp:
        layout = layout or TrainLayout(cfg, mesh, pod_axis)
        run_cfg = layout.run_cfg
        norm_weights = grad_norm_weights(cfg, layout.m)
    else:
        run_cfg, norm_weights = cfg, None

    def grads_of(leaves, params, tokens, labels):
        if not tp:
            loss, metrics = loss_fn(params, tokens, labels, cfg)
            return loss, metrics, torch.autograd.grad(loss, leaves)
        B, S = tokens.shape
        shape = ShapeConfig("train", "train", S, B)
        policy = dict(activation_hint_policy(run_cfg, layout.ax, shape,
                                             model_axis_size=layout.m),
                      __mesh__=layout.mesh)
        # the sequence is split at layer boundaries; the projections
        # flatten (batch, sequence), which DTensor before torch 2.13 cannot
        # do to a tensor split on both: the sequence is gathered at the
        # model's sequence-gather site, as the dry run does
        policy.setdefault("sublayer_input", P(layout.ax.batch, None, None))
        with implicit_replication(), sharding_policy(policy):
            loss, metrics = loss_fn(params, layout.batch(tokens),
                                    layout.batch(labels), run_cfg)
            g = torch.autograd.grad(loss, leaves)
        names = [n for n, _ in params.named_parameters()]
        g = settle_grads(dict(zip(names, g)), dict(zip(names, leaves)),
                         keep_partial=layout.pod_dim)
        g = tie_padded_grads(g, cfg, layout.m)
        return loss, metrics, tuple(g[n] for n in names)

    def local_grads(params: Transformer, tokens, labels):
        """(names, leaves, loss, metrics, grads) of one rank's rows."""
        names, leaves = zip(*params.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        with torch.enable_grad():
            if microbatches == 1:
                loss, metrics, g = grads_of(leaves, params, tokens, labels)
                grads = dict(zip(names, g))
            else:
                B = tokens.shape[0]
                if B % microbatches:
                    raise ValueError(f"batch {B} does not split into "
                                     f"{microbatches} microbatches")
                mb = B // microbatches
                grads = None
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                mtot: dict = {}
                for i in range(microbatches):
                    sl = slice(i * mb, (i + 1) * mb)
                    li, mi, g = grads_of(leaves, params, tokens[sl],
                                         labels[sl])
                    if grads is None:   # f32 buffers laid out as the grads
                        grads = {n: torch.zeros_like(x, dtype=torch.float32)
                                 for n, x in zip(names, g)}
                    for n, x in zip(names, g):
                        grads[n].add_(x)
                    loss = loss + li.detach()
                    for k, v in mi.items():
                        mtot[k] = mtot[k] + v.detach() if k in mtot \
                            else v.detach()
                for x in grads.values():
                    x.div_(microbatches)
                loss = loss / microbatches
                metrics = {k: (v if k in EXTENSIVE_METRICS
                               else v / microbatches)
                           for k, v in mtot.items()}
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()}}
        return names, leaves, metrics, grads

    def apply(params_names, leaves, grads, opt_state, metrics):
        kw = {"norm_weights": norm_weights} if norm_weights else {}
        _, opt_state, om = adamw_update(grads, opt_state,
                                        dict(zip(params_names, leaves)),
                                        opt_cfg, **kw)
        if tp:
            om = {k: gathered(v) for k, v in om.items()}
        return opt_state, {**metrics, **om}

    def step(params: Transformer, opt_state, residual, batch):
        dev = next(params.parameters()).device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        names, leaves, metrics, grads = local_grads(params, tokens, labels)
        opt_state, out = apply(names, leaves, grads, opt_state, metrics)
        return params, opt_state, residual, out

    if pod_axis is None:
        return step

    (pod_group, num_pods, pod, data_group, n_data,
     data) = _pod_layout(mesh, pod_axis)

    def tp_step(params: Transformer, opt_state, residual, batch):
        dev = next(params.parameters()).to_local().device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        labels = torch.as_tensor(batch["labels"]).to(dev)
        B = tokens.shape[0]
        if B % (num_pods * n_data * microbatches):
            raise ValueError(f"batch {B} does not split over {num_pods} "
                             f"pods x {n_data} data ranks x {microbatches} "
                             f"microbatches")
        names, leaves, metrics, grads = local_grads(params, tokens, labels)
        # the pod reduction on each rank's local shards: a pod's partial
        # sum times the pod count, so the mean over pods is the sum (a
        # gradient the backward left whole is every pod's already)
        local = {}
        for n, g in grads.items():
            part = g.placements[layout.pod_dim].is_partial()
            local[n] = g.to_local() * num_pods if part else g.to_local()
        if compress_pods:
            err = ({n: e[0] for n, e in residual.items()}
                   if residual is not None else None)
            groups = tuple(layout.mesh.get_group(i)
                           for i in range(layout.mesh.ndim)
                           if i != layout.pod_dim)
            local, new_err = compressed_psum_mean(
                local, pod_group, err, scale_groups(cfg, local),
                amax_groups=groups)
            residual = {n: e[None] for n, e in new_err.items()}
        else:
            local = psum_mean(local, pod_group)
        grads = {n: from_local_like(local[n], p, p.shape)
                 for n, p in zip(names, leaves)}
        opt_state, out = apply(names, leaves, grads, opt_state, metrics)
        return params, opt_state, residual, out

    if tp:
        return tp_step

    def pod_step(params: Transformer, opt_state, residual, batch):
        dev = next(params.parameters()).device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        B = tokens.shape[0]
        if B % (num_pods * n_data):
            raise ValueError(f"batch {B} does not split over {num_pods} "
                             f"pods x {n_data} data ranks")
        rows = B // (num_pods * n_data)
        sl = slice((pod * n_data + data) * rows,
                   (pod * n_data + data + 1) * rows)
        names, leaves, metrics, grads = local_grads(params, tokens[sl],
                                                    labels[sl])
        # the pod's gradient: the exact mean over its data ranks
        if n_data > 1:
            grads = psum_mean(grads, data_group)
            metrics = _reduce_metrics(metrics, data_group, n_data)
        if compress_pods:
            err = ({n: e[0] for n, e in residual.items()}
                   if residual is not None else None)
            grads, new_err = compressed_psum_mean(
                grads, pod_group, err, scale_groups(cfg, grads))
            residual = {n: e[None] for n, e in new_err.items()}
        else:
            grads = psum_mean(grads, pod_group)
        metrics = _reduce_metrics(metrics, pod_group, num_pods)
        opt_state, out = apply(names, leaves, grads, opt_state, metrics)
        return params, opt_state, residual, out

    return pod_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    # microbatches: gradient accumulation factor (1 = none).
    # mesh_shape: a mesh over ("pod", "data", "model")[:len(shape)], one
    #   process a device (the world's size must be its product); None keeps
    #   the single-process path.  The leading axis is the pod axis.
    # compress_pods: int8 error-feedback cross-pod gradient reduction (the
    #   residual becomes checkpointed train-step state).
    microbatches: int = 1
    mesh_shape: tuple[int, ...] | None = None
    pod_axis: str = "pod"
    compress_pods: bool = False


class Trainer:
    """Training loop with checkpoint/restart fault tolerance, on ``device``
    (the card unless told otherwise).

    With ``mesh_shape`` the Trainer is mesh-aware: it builds the mesh, runs
    the pod step (int8-compressed over the pod axis with
    ``compress_pods``) and checkpoints the error-feedback residual next to
    the parameters and the optimizer state.  Restarts are bitwise at the
    same pod count; a restore at another pod count reshards the residual
    (``reshard_residual``: the mean over the old pods, which preserves
    ``Σe/n``)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *,
                 tracer=None, metrics=None, device=None):
        if tcfg.compress_pods and tcfg.mesh_shape is None:
            raise ValueError(
                "TrainerConfig(compress_pods=True) requires mesh_shape — "
                "without a pod axis the int8 collective would be silently "
                "skipped (use mesh_shape=(1,) for a single-pod mesh)")
        if tcfg.mesh_shape is not None and not dist.is_initialized():
            raise ValueError(
                "TrainerConfig(mesh_shape=...) needs a process group: join "
                "one first (repro_torch.launch.mesh.init_world)")
        self.device = resolve_device(device)
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.tracer = tracer            # repro_torch.obs.Tracer: step spans
        self.metrics = metrics          # repro_torch.obs.MetricsRegistry
        self.pipeline = TokenPipeline(data_cfg)
        self.ckpt = Checkpointer(tcfg.checkpoint_dir,
                                 keep=tcfg.keep_checkpoints)
        self.mesh = None
        self.pod_axis = None
        self.num_pods = 1
        if tcfg.mesh_shape is not None:
            from repro_torch.launch.mesh import make_debug_mesh

            names = (tcfg.pod_axis, "data", "model")[:len(tcfg.mesh_shape)]
            self.mesh = make_debug_mesh(tuple(tcfg.mesh_shape), names,
                                        device=self.device)
            self.pod_axis = tcfg.pod_axis
            self._pod = _pod_layout(self.mesh, tcfg.pod_axis)
            self.num_pods = self._pod[1]
        # tensor-parallel: the state lives on each pod's (data, model) slice
        self.layout = (TrainLayout(cfg, self.mesh, tcfg.pod_axis)
                       if self.mesh is not None
                       and "model" in self.mesh.mesh_dim_names else None)
        self.compressed = bool(self.pod_axis and tcfg.compress_pods)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=tcfg.microbatches,
                                       pod_axis=self.pod_axis,
                                       compress_pods=tcfg.compress_pods,
                                       mesh=self.mesh, layout=self.layout)
        # the global (num_pods, *shape) residual of the last completed
        # run() (None before, and on the uncompressed paths)
        self.last_residual = None

    # ---- state ------------------------------------------------------------

    def _zero_residual(self, params: Transformer):
        """This rank's zero residual row: ``(1, *shape)``, or ``(1, *its
        local shard's shape)`` tensor-parallel."""
        if not self.compressed:
            return None
        if self.layout is None:
            return {n: torch.zeros((1, *p.shape), dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.named_parameters()}
        out = {}
        for n, shape in param_shapes(self.layout.run_cfg).items():
            sh = self.layout.residual_sharding(n)
            full = (self.num_pods, *shape)
            local, _ = compute_local_shape_and_global_offset(
                full, self.mesh, sh.placements(len(full)))
            out[n] = torch.zeros(local, dtype=torch.float32,
                                 device=self.device)
        return out

    def _residual_shardings(self, names):
        sh = NamedSharding(self.mesh, P(self.pod_axis))
        return {n: sh for n in names}

    def _placed(self, params, opt_state: dict):
        """The plain (meshless) state laid out for the step."""
        if self.layout is None:
            return params, opt_state
        return (self.layout.place_params(params),
                self.layout.place_opt(opt_state, self.opt_cfg.moment_dtype))

    def _own_rows(self, residual: dict) -> dict:
        """Each placed leaf's local shard: this pod's ``(1, *shape)`` row."""
        return {n: e.to_local() if hasattr(e, "to_local") else e
                for n, e in residual.items()}

    def global_residual(self, residual: dict | None, *, keep: bool = True):
        """The stacked ``(num_pods, *shape)`` form of the ranks' rows, on
        the CPU, unpadded (gathered over the mesh; collective).
        ``keep=False``: take part and keep nothing."""
        if residual is None:
            return None
        if self.layout is not None:
            return self.layout.plain_residual(residual, self.num_pods,
                                              keep=keep)
        if self.num_pods == 1:
            return {n: e.detach().cpu() for n, e in residual.items()}
        group = self._pod[0]
        out = {}
        for n, e in residual.items():
            row = e.detach().cpu()
            rows = [torch.empty_like(row) for _ in range(self.num_pods)]
            dist.all_gather(rows, row, group=group)
            out[n] = torch.cat(rows)
        return out

    def init_or_restore(self):
        """``(params, opt_state, residual, start_step)``: fresh parameters
        from a generator seeded with ``tcfg.seed``, or the latest
        checkpoint's; ``residual`` this rank's pod row (compressed) or
        None.

        Tensor-parallel, the state is made or read on the host, whole and
        unpadded (the checkpoint's layout, so a checkpoint restores on any
        model axis and without a mesh), and a rank moves only its shards
        to the device: the fresh parameters are drawn from a host
        generator, a stream of its own."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()     # rank 0's last checkpoint write is done
        tp = self.layout is not None
        made_on = torch.device("cpu") if tp else self.device
        gen = torch.Generator(device=made_on).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=made_on)
        params.requires_grad_(not tp)
        opt_state = init_opt_state(dict(params.named_parameters()),
                                   self.opt_cfg)
        residual = self._zero_residual(params)
        latest = self.ckpt.latest_step()
        if latest is None:
            return (*self._placed(params, opt_state), residual, 0)
        template = {"params": _param_tree(params), "opt": opt_state}
        if residual is None:
            state = self.ckpt.restore(template, device=made_on)
            return (*self._placed(_adopt(params, state), state["opt"]),
                    None, latest)
        # compressed: ONE checkpoint read covers params + opt + residual
        saved_pods = int(self.ckpt.read_metadata().get("num_pods",
                                                       self.num_pods))
        template["residual"] = {n: torch.zeros(()) for n in residual}
        sh = None if tp else self._residual_shardings(residual)
        try:
            if saved_pods == self.num_pods and not tp:
                state = self.ckpt.restore(
                    template, device=made_on,
                    shardings={"params": None, "opt": None, "residual": sh})
                return (*self._placed(_adopt(params, state), state["opt"]),
                        self._own_rows(state["residual"]), latest)
            state = self.ckpt.restore(template, device=made_on)
        except KeyError:
            # a checkpoint without a residual: cold-start the error feedback
            del template["residual"]
            state = self.ckpt.restore(template, device=made_on)
            return (*self._placed(_adopt(params, state), state["opt"]),
                    residual, latest)
        # a pod-count change: every new pod starts from the old pods' mean
        # (Σe/n preserved), placed on this mesh
        res = state["residual"]
        if saved_pods != self.num_pods:
            res = reshard_residual(res, self.num_pods)
        rows = (self.layout.place_residual(res, self.num_pods) if tp
                else self._own_rows(reshard_tree(res, sh)))
        return (*self._placed(_adopt(params, state), state["opt"]), rows,
                latest)

    def save(self, step: int, params, opt_state, residual) -> None:
        """Checkpoint on rank 0; with a residual, its global form (and
        ``num_pods``) too.  Collective when compressed or
        tensor-parallel: the leaves are gathered one at a time, whole and
        unpadded, onto rank 0's host."""
        keep = self.rank == 0
        res = self.global_residual(residual, keep=keep)
        if self.layout is not None:
            tree = self.layout.plain_params(params, keep=keep)
            opt_state = self.layout.plain_opt(opt_state, keep=keep)
        else:
            tree = _param_tree(params)
        if keep:
            # residual=None flattens to nothing
            self.ckpt.save(step, {"params": tree, "opt": opt_state,
                                  "residual": res},
                           metadata={"num_pods": self.num_pods})

    # ---- loop --------------------------------------------------------------

    def run(self, steps: int | None = None,
            inject_failure_at: int | None = None):
        """Run to ``total_steps`` (resuming if checkpoints exist); returns
        ``(params, opt_state, history)``, history the ``(step, loss)`` of
        every ``log_every``-th step and the last.

        ``inject_failure_at``: raise after that many NEW steps, to prove an
        exact restart."""
        params, opt_state, residual, start = self.init_or_restore()
        total = steps if steps is not None else self.tcfg.total_steps
        history = []
        done = 0
        obs_on = self.tracer is not None or self.metrics is not None
        step_hist = (self.metrics.histogram("train.step_s")
                     if self.metrics is not None else None)
        # cross-pod wire bytes a step (the dist.compression payload model):
        # every pod ships each gradient leaf over the slow links once
        wire_step = 0
        if obs_on and self.num_pods > 1:
            names = [n for n, _ in params.named_parameters()]
            n_elems = sum(p.numel() for p in params.parameters())
            n_scales = len(set(scale_groups(self.cfg, names).values()))
            wire_step = (WIRE_BYTES_PER_ELEM * n_elems
                         + WIRE_SCALE_BYTES_PER_LEAF * n_scales
                         if self.compressed
                         else EXACT_BYTES_PER_ELEM * n_elems)
        for step in range(start, total):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            t0 = time.perf_counter() if obs_on else 0.0
            params, opt_state, residual, metrics = self.step_fn(
                params, opt_state, residual, batch)
            if obs_on:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                if step_hist is not None:
                    step_hist.record(dt)
                if self.metrics is not None and wire_step:
                    self.metrics.counter("train.wire_bytes").inc(wire_step)
                if self.tracer is not None:
                    self.tracer.complete("train.step", t0, dt, step=step)
            if (step + 1) % self.tcfg.checkpoint_every == 0 \
                    or step + 1 == total:
                self.save(step + 1, params, opt_state, residual)
            if (step + 1) % self.tcfg.log_every == 0 or step + 1 == total:
                history.append((step + 1, float(metrics["loss"])))
            done += 1
            if inject_failure_at is not None and done >= inject_failure_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step + 1}")
        self.ckpt.wait()
        self.last_residual = self.global_residual(residual)
        return params, opt_state, history


def _adopt(params: Transformer, state: dict) -> Transformer:
    """``params`` holding the restored ``state["params"]`` values."""
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(state["params"][name])
    return params


def _param_tree(params: Transformer) -> dict[str, torch.Tensor]:
    return {name: p.detach() for name, p in params.named_parameters()}

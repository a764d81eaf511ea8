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
numbers, so the replicated parameters stay bitwise equal.  A ``model`` axis
of more than one device (tensor-parallel training) is not ported and
raises.

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
from repro_torch.dist.sharding import NamedSharding, P
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, init_params, loss_fn
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
    if "model" in names and mesh.size(names.index("model")) > 1:
        raise NotImplementedError(
            "a model axis of more than one device (tensor-parallel "
            "training) is not ported; the pod and data axes are")
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
                    compress_pods: bool = False, mesh=None):
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
    ``residual`` passes through."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if pod_axis is not None and mesh is None:
        raise ValueError("make_train_step(pod_axis=...) needs the mesh")

    def grads_of(leaves, params, tokens, labels):
        loss, metrics = loss_fn(params, tokens, labels, cfg)
        return loss, metrics, torch.autograd.grad(loss, leaves)

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
                grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=dev)
                         for n, p in zip(names, leaves)}
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                mtot: dict = {}
                for i in range(microbatches):
                    sl = slice(i * mb, (i + 1) * mb)
                    li, mi, g = grads_of(leaves, params, tokens[sl],
                                         labels[sl])
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
        _, opt_state, om = adamw_update(grads, opt_state,
                                        dict(zip(params_names, leaves)),
                                        opt_cfg)
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
        self.compressed = bool(self.pod_axis and tcfg.compress_pods)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=tcfg.microbatches,
                                       pod_axis=self.pod_axis,
                                       compress_pods=tcfg.compress_pods,
                                       mesh=self.mesh)
        # the global (num_pods, *shape) residual of the last completed
        # run() (None before, and on the uncompressed paths)
        self.last_residual = None

    # ---- state ------------------------------------------------------------

    def _zero_residual(self, params: Transformer):
        if not self.compressed:
            return None
        return {n: torch.zeros((1, *p.shape), dtype=torch.float32,
                               device=p.device)
                for n, p in params.named_parameters()}

    def _residual_shardings(self, names):
        sh = NamedSharding(self.mesh, P(self.pod_axis))
        return {n: sh for n in names}

    def _own_rows(self, residual: dict) -> dict:
        """Each placed leaf's local shard: this pod's ``(1, *shape)`` row."""
        return {n: e.to_local() if hasattr(e, "to_local") else e
                for n, e in residual.items()}

    def global_residual(self, residual: dict | None):
        """The stacked ``(num_pods, *shape)`` form of the ranks' rows, on
        the CPU (gathered over the pod group; collective)."""
        if residual is None:
            return None
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
        None."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()     # rank 0's last checkpoint write is done
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=self.device)
        params.requires_grad_(True)
        opt_state = init_opt_state(dict(params.named_parameters()),
                                   self.opt_cfg)
        residual = self._zero_residual(params)
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt_state, residual, 0
        template = {"params": _param_tree(params), "opt": opt_state}
        if residual is None:
            state = self.ckpt.restore(template, device=self.device)
            return _adopt(params, state), state["opt"], None, latest
        # compressed: ONE checkpoint read covers params + opt + residual
        saved_pods = int(self.ckpt.read_metadata().get("num_pods",
                                                       self.num_pods))
        template["residual"] = {n: torch.zeros(()) for n in residual}
        sh = self._residual_shardings(residual)
        try:
            if saved_pods == self.num_pods:
                state = self.ckpt.restore(
                    template, device=self.device,
                    shardings={"params": None, "opt": None, "residual": sh})
                return (_adopt(params, state), state["opt"],
                        self._own_rows(state["residual"]), latest)
            state = self.ckpt.restore(template, device=self.device)
        except KeyError:
            # a checkpoint without a residual: cold-start the error feedback
            del template["residual"]
            state = self.ckpt.restore(template, device=self.device)
            return _adopt(params, state), state["opt"], residual, latest
        # elastic pod-count change: every new pod starts from the old pods'
        # mean (Σe/n preserved), placed on this mesh
        from repro_torch.dist.sharding import reshard_tree

        res = reshard_tree(reshard_residual(state["residual"],
                                            self.num_pods), sh)
        return _adopt(params, state), state["opt"], self._own_rows(res), \
            latest

    def save(self, step: int, params, opt_state, residual) -> None:
        """Checkpoint on rank 0; with a residual, its global form (and
        ``num_pods``) too.  Collective when compressed."""
        res = self.global_residual(residual)
        if self.rank == 0:
            # residual=None flattens to nothing
            self.ckpt.save(step, {"params": _param_tree(params),
                                  "opt": opt_state, "residual": res},
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

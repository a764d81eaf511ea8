"""Training loop: the train step (gradient accumulation) and the
checkpoint/restart orchestration around it.

Counterpart of ``repro.train.trainer``.  ``make_train_step`` builds
``step(params, opt_state, residual, batch) -> (params, opt_state, residual,
metrics)``; ``params`` is the model (``models.model.Transformer``), updated
in place, and ``residual`` passes through untouched (``None``): it is the
error-feedback state of the reference's int8 cross-pod reduction, which
waits for the port of ``dist/`` with every pod, mesh and compression knob
(ROADMAP queue 1 item 11).  Those knobs raise; none is ignored.

``Trainer`` adds the fault-tolerance loop: periodic async checkpoints of
the parameters and the optimizer state, an exact restart from the latest
one, and a step-indexed data stream, so a restart replays nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

# Metrics that are COUNTS over the batch (extensive): summed across
# microbatches, so totals stay comparable to a step without accumulation;
# everything else (ce, aux / z losses, ...) is a per-token mean (intensive)
# and is averaged.
EXTENSIVE_METRICS = frozenset({"expert_load"})

_DIST = "ROADMAP queue 1 item 11, the port of dist/"


def _not_yet(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for {_DIST}")


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
    parameters' device.  ``pod_axis`` / ``compress_pods`` / ``mesh`` raise
    (item 11)."""
    if pod_axis is not None or compress_pods or mesh is not None:
        raise _not_yet("make_train_step(pod_axis=, compress_pods=, mesh=)")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(leaves, params, tokens, labels):
        loss, metrics = loss_fn(params, tokens, labels, cfg)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    def step(params: Transformer, opt_state, residual, batch):
        names, leaves = zip(*params.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
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
        _, opt_state, om = adamw_update(grads, opt_state,
                                        dict(zip(names, leaves)), opt_cfg)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **om}
        return params, opt_state, residual, out

    return step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    # microbatches: gradient accumulation factor (1 = none).
    # mesh_shape / pod_axis / compress_pods: the reference's multi-pod mesh
    #   and its int8 cross-pod reduction; a mesh_shape or compress_pods
    #   raises until dist/ is ported (item 11).
    microbatches: int = 1
    mesh_shape: tuple[int, ...] | None = None
    pod_axis: str = "pod"
    compress_pods: bool = False


class Trainer:
    """Single-process training loop with checkpoint/restart fault
    tolerance, on ``device`` (the card unless told otherwise)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *,
                 tracer=None, metrics=None, device=None):
        if tcfg.mesh_shape is not None:
            raise _not_yet("TrainerConfig(mesh_shape=...)")
        if tcfg.compress_pods:
            raise _not_yet("TrainerConfig(compress_pods=True)")
        self.device = resolve_device(device)
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.tracer = tracer            # repro_torch.obs.Tracer: step spans
        self.metrics = metrics          # repro_torch.obs.MetricsRegistry
        self.pipeline = TokenPipeline(data_cfg)
        self.ckpt = Checkpointer(tcfg.checkpoint_dir,
                                 keep=tcfg.keep_checkpoints)
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=tcfg.microbatches)
        # the residual of the last completed run() (always None until the
        # pod-compressed path exists)
        self.last_residual = None

    # ---- state ------------------------------------------------------------

    def init_or_restore(self):
        """``(params, opt_state, residual, start_step)``: fresh parameters
        from a generator seeded with ``tcfg.seed``, or the latest
        checkpoint's."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=self.device)
        params.requires_grad_(True)
        opt_state = init_opt_state(dict(params.named_parameters()),
                                   self.opt_cfg)
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt_state, None, 0
        state = self.ckpt.restore({"params": _param_tree(params),
                                   "opt": opt_state}, device=self.device)
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(state["params"][name])
        return params, state["opt"], None, latest

    def save(self, step: int, params, opt_state, residual) -> None:
        # residual=None flattens to nothing
        self.ckpt.save(step, {"params": _param_tree(params), "opt": opt_state,
                              "residual": residual},
                       metadata={"num_pods": 1})

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
        self.last_residual = residual
        return params, opt_state, history


def _param_tree(params: Transformer) -> dict[str, torch.Tensor]:
    return {name: p.detach() for name, p in params.named_parameters()}

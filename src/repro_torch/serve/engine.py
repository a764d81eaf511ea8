"""Serving engine: continuous batching with a HEFT_RT front-end scheduler.

Counterpart of ``repro.serve.engine``.  Two layers:

* ``ServeEngine`` — prefill + batched token-by-token greedy decode with KV
  caches, for one replica: on one device, or *mesh-backed* on a
  ``torch.distributed`` ``DeviceMesh`` slice (``mesh=``), its parameters,
  caches and page pools ``DTensor``s laid out by ``replica_pspecs``
  (params FSDP + TP, KV heads over ``model``, batch replicated) and every
  step run under the replica's activation hint policy.
* ``HeftFrontEnd`` — maps dynamically arriving requests onto a fleet of
  replicas with HEFT_RT (the paper's scheduler as the admission layer).
  Replicas may share one parameter set, as the launcher's do.

Public contracts:

* **Dense path** (``generate``, ``start`` / ``step``) — decode against a
  dense fixed-shape cache: the *bitwise oracle* every other path is tested
  against.  Every decode step runs at the engine's ``lanes`` rows (a batch
  of fewer prompts is padded), as the paged tick does; see the row
  invariance note in ``serve/paging.py``.  On the card its GQA decode
  attention is the paged tick's kernel (``models.attention``: the cache's
  device decides), over the cache as one page a lane, so paged and dense
  stay bitwise there too, meshed or not.  ``snapshot_caches`` /
  ``restore_caches`` are the chaos tier's kill-and-recover unit.
* **Paged path** (``start_paged`` → ``admit`` / ``decode_tick`` /
  ``finished_slots`` / ``retire``) — continuous batching through the
  block-paged KV pool: admission reserves every page up front, so pool
  exhaustion refuses admission (``admit() -> None``: callers queue, never
  drop), and each request's tokens are bitwise ``generate``'s under any
  admission interleaving.  ``snapshot_pages`` / ``restore_pages`` move one
  in-flight request between engines.  With capacity-dispatched MoE layers
  that holds at 4 lanes or fewer: above 4 a token can be dropped by the
  expert capacity because of its batch-mates (``models/moe.py``), in the
  paged tick and in the dense ``generate`` alike, as in the reference;
  dropless MoE layers drop nothing at any lane count.
* **Front end** — ``run_batch`` (one HEFT_RT mapping event, a whole
  ``generate`` per request) and ``run_continuous`` (per-tick admission:
  HEFT_RT maps arrivals to sticky per-replica FIFO queues, each tick drains
  queue heads into free paged slots).  Both return outputs in request order.
* **Mesh-backed replicas** — ``reshard(mesh)`` migrates a live replica
  (params, page pools and a caller's in-flight caches) to another slice or
  off the mesh (``None``), token-identically; ``mesh_backed_fleet`` carves
  the world into slices and builds one replica each.

One controller in the reference, one process a rank here: every rank runs
the same (deterministic) front end and builds every replica, but only the
ranks of a replica's mesh compute its steps.  What the other ranks need of
a step (the ``generate`` tokens, the logits of ``start`` / ``step``, the
first token of an admission, the tick's packed int32 buffer of
``pack_tick_outputs``) is broadcast over the world from the mesh's lowest
rank, so every rank's slots, decisions and ``T_avail`` registers stay
equal.  At world size 1 nothing is broadcast.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import heft_rt_numpy
from repro_torch.dist.hints import gathered, is_dtensor, sharding_policy
from repro_torch.dist.sharding import (MeshAxes, from_local_like, mesh_root,
                                       model_axis_size, named, pad_caches,
                                       pad_params, padded_config,
                                       replica_pspecs, reshard_tree, to_plain,
                                       unpad_caches, unpad_params)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (cache_specs, decode_step, init_cache,
                                      param_specs, prefill_step)
from repro_torch.obs.metrics import Stopwatch
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.serve.paging import phase_span


def _host_scale_s(prompt_tokens, new_tokens):
    """The abstract-fleet service-time estimate (seconds, elementwise)."""
    return 1e-4 * prompt_tokens + 2e-3 * new_tokens


def _lane_rows(caches) -> int:
    """The decode lane count of a cache tree: the batch axis of any leaf
    (a Mamba-only model has no ``k``)."""
    return next(iter(caches.values())).shape[1]


def _span(tracer, name, **args):
    """Tracer span, or a no-op context when no tracer is attached."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **args)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _set_params(shell: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """``shell`` (a parameter-shaped module) holding ``tree``'s tensors."""
    for name, t in tree.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = shell.get_submodule(mod_name) if mod_name else shell
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=False))
    return shell


@dataclass
class ServeEngine:
    """Single-replica engine: batched prefill + greedy decode.

    ``params`` is a :class:`repro_torch.models.model.Transformer`; the
    engine runs on its device.  ``lanes`` is the row count of every decode
    step.  ``mesh`` / ``axes`` back the replica with a mesh slice: the
    parameters are placed once by ``replica_pspecs`` (the engine keeps its
    own module of ``DTensor`` parameters; the caller's stays as it is), the
    caches and pools live sharded on the slice (KV heads over ``model``),
    and every step runs under the replica's hint policy.  Head counts the
    model axis does not divide are padded on the slice
    (``dist.sharding.head_padding``): the steps run ``run_cfg``, the
    padded config, while ``cfg``, the caller's parameters, snapshots and
    ``reshard(None)`` keep the unpadded layout.
    """

    cfg: ModelConfig
    params: torch.nn.Module
    max_len: int = 256
    lanes: int = 8
    tracer: object | None = None        # repro_torch.obs.Tracer: step spans
    mesh: object | None = None          # DeviceMesh slice backing the replica
    axes: MeshAxes | None = None
    fsdp: bool = True

    def __post_init__(self):
        self._paged = None              # PagedRuntime (start_paged)
        emb = self.params.embed
        self._home = (emb.to_local().device if is_dtensor(emb)
                      else emb.device)
        self._build()

    def _build(self):
        """(Re)place the parameters for the current mesh slice: the shared
        path of construction and live resharding."""
        if self.mesh is None:
            self._policy = self._cache_sh = None
            self._member = True
            self._m = 1
            self.run_cfg = self.cfg
            return
        self.axes = self.axes or MeshAxes()
        self._m = model_axis_size(self.mesh, self.axes)
        self.run_cfg = padded_config(self.cfg, self._m)
        specs = replica_pspecs(self.run_cfg, self.axes, fsdp=self.fsdp)
        self._policy = dict(specs["policy"], __mesh__=self.mesh)
        self._cache_sh = named(self.mesh, specs["cache"])
        self._member = self.mesh.get_coordinate() is not None
        tree = pad_params({n: p.detach() for n, p
                           in self.params.named_parameters()},
                          self.cfg, self._m)
        placed = reshard_tree(tree, named(self.mesh, specs["params"]))
        self.params = _set_params(param_specs(self.run_cfg), placed)

    @property
    def device(self) -> torch.device:
        """This rank's device for the replica's tensors."""
        return self._home

    @property
    def mesh_shape(self) -> tuple[int, ...] | None:
        return tuple(self.mesh.mesh.shape) if self.mesh is not None else None

    def _ctx(self):
        """The step context: inference mode unmeshed; on a mesh, the
        replica's hint policy with plain tensors taken as replicated
        (``no_grad``: a ``DTensor`` view of a parameter fails in inference
        mode)."""
        if self.mesh is None:
            return torch.inference_mode()
        from torch.distributed.tensor.experimental import implicit_replication

        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.no_grad())
        ctx.enter_context(implicit_replication())
        ctx.enter_context(sharding_policy(self._policy))
        return ctx

    def _publish(self, t, shape, dtype) -> torch.Tensor:
        """A step's plain result from the replica's ranks to every rank of
        the world (broadcast from the mesh's lowest rank); ``t`` is None on
        the ranks outside the mesh."""
        if self.mesh is None or self.mesh.size() == _world():
            return t
        buf = (t.contiguous() if self._member
               else torch.empty(shape, dtype=dtype, device=self.device))
        dist.broadcast(buf, src=mesh_root(self.mesh))
        return buf

    def _placeholder_caches(self, rows: int) -> dict:
        """Shape-only caches on the ranks outside the mesh."""
        return {name: torch.empty((s.shape[0], rows, *s.shape[2:]),
                                  dtype=s.dtype, device="meta")
                for name, s in cache_specs(self.run_cfg, 1,
                                           self.max_len).items()}

    def _prefill(self, tokens):
        caches = None
        if self._cache_sh is not None:
            caches = reshard_tree(init_cache(self.run_cfg, tokens.shape[0],
                                             self.max_len,
                                             device=self.device),
                                  self._cache_sh)
        return prefill_step(self.params, tokens, self.run_cfg,
                            max_len=self.max_len, caches=caches)

    def _decode(self, caches, tok, pos):
        return decode_step(self.params, caches, tok, pos, self.run_cfg)

    def _plain_caches(self, caches, src) -> dict:
        """A cache tree of this slice whole and unpadded on every rank."""
        return unpad_caches(to_plain(caches, self.device, src=src),
                            self.cfg, self._m)

    def _place_caches(self, caches) -> dict:
        """An unpadded plain cache tree laid out on this slice."""
        if self._cache_sh is None:
            return caches
        return reshard_tree(pad_caches(caches, self.cfg, self._m),
                            self._cache_sh)

    def reshard(self, mesh, axes: MeshAxes | None = None, caches=None):
        """Migrate this *live* replica to another mesh slice, in memory.

        The parameters, the page pools of a paged runtime and, when given,
        a caller's in-flight cache tree move to the new slice's
        ``replica_pspecs`` layouts through ``reshard_tree``; ``mesh=None``
        brings the replica back to one device, whole.  Generation is bitwise
        unchanged across the move.  Collective over the world: every rank
        calls it.  Returns the migrated caches (None without)."""
        with _span(self.tracer, "engine.reshard",
                   to=str(tuple(mesh.mesh.shape)) if mesh is not None
                   else "host", with_caches=caches is not None):
            old_root = (mesh_root(self.mesh) if self.mesh is not None
                        else None)
            if caches is not None:
                caches = self._plain_caches(caches, old_root)
            if self._paged is not None:
                self._paged.pool.pools = self._plain_caches(
                    self._paged.pool.pools, old_root)
            if self.mesh is not None:
                tree = to_plain({n: p.detach() for n, p
                                 in self.params.named_parameters()},
                                self.device)
                tree = unpad_params(tree, self.cfg, self._m)
                self.params = _set_params(param_specs(self.cfg), tree)
            self.mesh = mesh
            if axes is not None:
                self.axes = axes
            self._build()
            if self._paged is not None:
                self._paged.rebind()
            if caches is not None:
                caches = self._place_caches(caches)
            return caches

    def snapshot_caches(self, caches) -> dict:
        """Host snapshot of an in-flight cache tree, taken between
        :meth:`step` calls: it outlives the replica, and
        :meth:`restore_caches` puts the same step back on any engine (any
        slice).  Collective over the world on a mesh."""
        with _span(self.tracer, "engine.snapshot"):
            src = mesh_root(self.mesh) if self.mesh is not None else None
            return {name: c.cpu().numpy() for name, c in
                    self._plain_caches(caches, src).items()}

    def restore_caches(self, caches) -> dict:
        """A :meth:`snapshot_caches` tree back on this engine: on its
        device, or laid out on its slice."""
        with _span(self.tracer, "engine.restore"):
            tree = {name: torch.from_numpy(np.ascontiguousarray(c))
                    .to(self.device) for name, c in caches.items()}
            return self._place_caches(tree)

    def start(self, prompts: np.ndarray):
        """Prefill: (B, S0) prompts → (logits (B, V), caches padded to the
        decode lanes).  With :meth:`step`, the resumable half of
        :meth:`generate`: a caller can pause, migrate the caches through
        :meth:`reshard` and resume on another slice.  On a mesh the logits
        are whole on every rank (collective over the world)."""
        B = prompts.shape[0]
        logits = None
        with self._ctx():
            if self._member:
                logits, caches = self._start_local(prompts)
            else:
                caches = self._placeholder_caches(max(B, self.lanes))
        logits = self._publish(logits, (B, self.cfg.vocab_size),
                               self._logit_dtype())
        return logits, caches

    def _logit_dtype(self) -> torch.dtype:
        return dtype_of(self.cfg.compute_dtype)

    def _pad_caches(self, caches, rows: int) -> dict:
        out = {}
        for name, c in caches.items():
            if is_dtensor(c):
                # the lane dim is never sharded: pad each rank's shard
                loc = c.to_local()
                pad = torch.zeros((loc.shape[0], rows, *loc.shape[2:]),
                                  dtype=loc.dtype, device=loc.device)
                pad[:, :loc.shape[1]] = loc
                out[name] = from_local_like(pad, c,
                                            (c.shape[0], rows, *c.shape[2:]))
                continue
            pad = torch.zeros((c.shape[0], rows, *c.shape[2:]), dtype=c.dtype,
                              device=c.device)
            pad[:, :c.shape[1]] = c
            out[name] = pad
        return out

    def step(self, caches, tok, pos: int):
        """One decode step: (caches, (B, 1) tokens, position) → (logits
        (B, V), caches).  The caches are updated in place (pass the latest
        ones); the step runs at the caches' lane count."""
        tok = torch.as_tensor(np.asarray(tok), device=self.device)
        B = tok.shape[0]
        rows = _lane_rows(caches)
        logits = None
        with self._ctx(), _span(self.tracer, "engine.decode_step", pos=pos):
            if self._member:
                lane_tok = torch.zeros((rows, 1), dtype=torch.int32,
                                       device=self.device)
                lane_tok[:B] = tok
                lane_pos = torch.zeros(rows, dtype=torch.int32,
                                       device=self.device)
                lane_pos[:B] = pos
                logits, caches = self._decode(caches, lane_tok, lane_pos)
                logits = gathered(logits)[:B]
        logits = self._publish(logits, (B, self.cfg.vocab_size),
                               self._logit_dtype())
        return logits, caches

    def generate(self, prompts: np.ndarray, new_tokens: int,
                 greedy: bool = True, generator: torch.Generator | None = None):
        """prompts: (B, S0) int32 → (B, S0+new_tokens) generated ids.

        Greedy by default; ``greedy=False`` samples from the softmax with
        ``generator`` (a ``torch.Generator`` on the engine's device).  On a
        mesh only the slice's ranks decode; the tokens reach every rank."""
        if not greedy and generator is None:
            raise ValueError("sampling needs an explicit torch.Generator")
        B, S0 = prompts.shape
        if not self._member:
            gen = self._publish(None, (B, new_tokens), torch.int32)
            return np.concatenate([np.asarray(prompts, dtype=np.int32),
                                   gen.cpu().numpy()], axis=1)
        tr = self.tracer
        with self._ctx():
            logits, caches = self._start_local(prompts)  # engine.prefill span
            rows = _lane_rows(caches)
            lane_tok = torch.zeros((rows, 1), dtype=torch.int32,
                                   device=self.device)
            lane_pos = torch.zeros(rows, dtype=torch.int32, device=self.device)
            out = []
            for i in range(new_tokens):
                if greedy:
                    tok = logits.argmax(dim=-1)
                else:
                    tok = torch.multinomial(
                        torch.softmax(logits.to(torch.float32), dim=-1), 1,
                        generator=generator)[:, 0]
                out.append(tok.to(torch.int32))
                lane_tok[:B, 0] = out[-1]
                lane_pos[:B] = S0 + i
                t0 = time.perf_counter()
                logits, caches = self._decode(caches, lane_tok, lane_pos)
                logits = gathered(logits)[:B]
                if tr is not None:
                    tr.complete("engine.decode_step", t0,
                                time.perf_counter() - t0, pos=S0 + i)
            gen = (torch.stack(out, dim=1) if out
                   else torch.zeros((B, 0), dtype=torch.int32,
                                    device=self.device))
        gen = self._publish(gen, (B, new_tokens), torch.int32)
        return np.concatenate([np.asarray(prompts, dtype=np.int32),
                               gen.cpu().numpy()], axis=1)

    def _start_local(self, prompts: np.ndarray):
        """:meth:`start` on the slice's ranks alone (no broadcast)."""
        B, S0 = prompts.shape
        with _span(self.tracer, "engine.prefill", B=int(B), S0=int(S0)):
            logits, caches = self._prefill(
                torch.as_tensor(np.asarray(prompts, dtype=np.int32),
                                device=self.device))
            return (gathered(logits),
                    self._pad_caches(caches, max(B, self.lanes)))

    # -- continuous batching (block-paged KV pool; see serve/paging.py) -----

    def start_paged(self, *, max_batch: int = 8, page_size: int = 16,
                    num_pages: int | None = None):
        """Switch this replica to the in-flight decode API.

        Builds the page pool on the engine's device (``num_pages`` defaults
        to full occupancy ``max_batch * max_len/page_size``; lower makes
        admission queue).  Then drive the engine with :meth:`admit` /
        :meth:`decode_tick` / :meth:`retire`; :meth:`generate` stays the
        oracle.  Returns the :class:`~repro_torch.serve.paging.PagedRuntime`
        (also kept on the engine)."""
        from repro_torch.serve.paging import PagedRuntime

        self._paged = PagedRuntime(self, max_batch, page_size,
                                   num_pages=num_pages)
        return self._paged

    @property
    def paged(self):
        """The active PagedRuntime, or None before :meth:`start_paged`."""
        return self._paged

    def _require_paged(self):
        if self._paged is None:
            raise RuntimeError("call start_paged() before the in-flight API")
        return self._paged

    def admit(self, prompt: np.ndarray, new_tokens: int) -> int | None:
        """Prefill + join the running batch; the slot id, or ``None`` when
        the pool lacks a slot or pages (callers queue, never drop).  With
        dropless MoE layers a traced admission's span carries its
        prefill's distinct routed ``experts`` (summed over the layers) and
        routed ``rows``."""
        rt = self._require_paged()
        tr = self.tracer
        if tr is None:
            return rt.admit(prompt, new_tokens)
        with tr.span("engine.admit", S0=int(np.asarray(prompt).size),
                     new_tokens=new_tokens) as sp:
            slot = rt.admit(prompt, new_tokens)
            if rt.admit_routes is not None:
                experts, rows = rt.admit_routes
                sp.set(experts=experts, rows=rows)
            return slot

    def decode_tick(self, sched=None):
        """One decode step for every in-flight slot → {slot: new token}.

        ``sched`` (optional): ``(avg, exec_times, fabric)`` for a
        fused-backend ``MappingFabric``, or ``(avg, exec_times, fabric,
        event)`` with the mapping event's number for the decision's spans;
        the tick also makes that mapping decision and returns ``(tokens,
        decision)`` (see ``PagedRuntime.decode_tick``).  With dropless MoE
        layers a traced tick's span carries ``experts``, the distinct
        experts its active lanes routed to, summed over the layers."""
        rt = self._require_paged()
        tr = self.tracer
        if tr is None:
            return rt.decode_tick(sched)
        with tr.span("engine.decode_tick", active=len(rt.active_slots()),
                     fused=sched is not None) as sp:
            out = rt.decode_tick(sched)
            if rt.tick_experts is not None:
                sp.set(experts=rt.tick_experts)
            return out

    def finished_slots(self) -> list[int]:
        """Slots whose generation completed and await :meth:`retire`."""
        return self._require_paged().finished_slots()

    def retire(self, slot: int) -> np.ndarray:
        """Free a finished slot's pages; returns its (S0+new_tokens,) ids."""
        rt = self._require_paged()
        tr = self.tracer
        if tr is None:
            return rt.retire(slot)
        with tr.span("engine.retire", slot=slot):
            return rt.retire(slot)

    def free_pages(self) -> int:
        """Pages currently available for admission."""
        return self._require_paged().pool.free_pages

    def snapshot_pages(self, slot: int) -> dict:
        """Page-granular snapshot of ONE in-flight request; restore it with
        :meth:`restore_pages` on any paged engine."""
        with _span(self.tracer, "engine.snapshot_pages", slot=slot):
            return self._require_paged().snapshot_slot(slot)

    def restore_pages(self, snap: dict) -> int | None:
        """Re-admit a :meth:`snapshot_pages` request here; decoding resumes
        token-identically.  None when the pool is currently full."""
        with _span(self.tracer, "engine.restore_pages"):
            return self._require_paged().restore_slot(snap)


@dataclass
class ReplicaHandle:
    """One fleet slot: an engine plus its scheduling identity.

    ``speed`` scales the host-scale fallback estimate.  ``arch`` /
    ``mesh_shape`` and the aggregate rates are the cost-model key and
    rates a ``CostModelRegistry`` reads; ``mesh_shape`` comes from a
    mesh-backed engine's slice.
    """

    name: str
    engine: ServeEngine
    speed: float = 1.0             # relative throughput (heterogeneous fleet)
    avail_at: float = 0.0          # availability-time register (T_avail)
    processed: int = 0
    arch: str | None = None              # cost-model key
    mesh_shape: tuple[int, ...] | None = None
    compute_tflops: float | None = None  # aggregate effective rates
    hbm_gbps: float | None = None
    ici_gbps: float = 0.0

    def __post_init__(self):
        if self.mesh_shape is None:
            self.mesh_shape = getattr(self.engine, "mesh_shape", None)

    def sync_mesh_identity(self) -> None:
        """Re-derive the scheduling identity after ``engine.reshard``: the
        cost-model key follows the new slice, and ``speed`` and the
        aggregate rates scale with its device count."""
        old_n = math.prod(self.mesh_shape) if self.mesh_shape else 1
        self.mesh_shape = self.engine.mesh_shape
        new_n = math.prod(self.mesh_shape) if self.mesh_shape else 1
        if new_n != old_n:
            scale = new_n / old_n
            self.speed *= scale
            if self.compute_tflops:
                self.compute_tflops *= scale
            if self.hbm_gbps:
                self.hbm_gbps *= scale


@dataclass
class HeftFrontEnd:
    """HEFT_RT request→replica mapper over live engines.

    Each scheduling tick, the ready queue of requests goes with per-replica
    exec-time estimates and the T_avail registers to HEFT_RT; the
    commitments execute on the engines.

    ``fabric`` selects the mapping-event backend: ``None`` keeps the
    ``heft_rt_numpy`` oracle; a
    :class:`~repro_torch.sched_integration.fabric.MappingFabric` routes
    events through its backend (identical decisions, device-resident
    T_avail registers).  ``cost_registry`` supplies cost-model Exec_TID
    columns for the replicas it covers.
    """

    replicas: list[ReplicaHandle]
    fabric: object | None = None      # MappingFabric, optional
    cost_registry: object | None = None
    tracer: object | None = None      # repro_torch.obs.Tracer: decision spans
    metrics: object | None = None     # repro_torch.obs.MetricsRegistry
    unreachable: set = field(default_factory=set)   # chaos partition mask

    # -- dynamic handle registry (elastic fleet) ----------------------------

    def add_replica(self, handle: ReplicaHandle) -> None:
        """Join a replica mid-run.  An attached fabric grows its PE pool in
        place, the joiner's register seeded at its ``avail_at``."""
        self.replicas.append(handle)
        if self.fabric is not None:
            self.fabric.grow(len(self.replicas), avail=handle.avail_at)
        self._sync_mask()

    def remove_replica(self, name: str) -> ReplicaHandle:
        """Retire a replica by name (no new assignments).  The fabric
        shrinks, keeping the survivors' registers."""
        idx = next((i for i, r in enumerate(self.replicas) if r.name == name),
                   None)
        if idx is None:
            raise KeyError(f"no replica named {name!r} in "
                           f"{[r.name for r in self.replicas]}")
        handle = self.replicas.pop(idx)
        if self.fabric is not None:
            self.fabric.shrink([i for i in range(len(self.replicas) + 1)
                                if i != idx])
        self.unreachable.discard(name)
        self._sync_mask()
        return handle

    def set_unreachable(self, names) -> None:
        """Chaos-tier partition mask: replicas in ``names`` receive no *new*
        work (their Exec_TID columns dispatch as ``+inf``, and an attached
        fabric's PE mask follows) while in-flight work and committed
        ``T_avail`` registers stay.  An empty iterable clears it; names not
        in the roster are ignored."""
        self.unreachable = set(names)
        self._sync_mask()

    def _sync_mask(self) -> None:
        # Fabric resizes clear the lane mask (indices change meaning), so
        # every roster/mask change re-derives it from replica names.
        if self.fabric is None:
            return
        mask = np.array([r.name in self.unreachable for r in self.replicas],
                        dtype=bool)
        self.fabric.set_pe_mask(mask if mask.any() else None)

    def estimate_s(self, prompt_len: int, new_tokens: int,
                   replica: ReplicaHandle) -> float:
        return _host_scale_s(prompt_len, new_tokens) / replica.speed

    def exec_estimates(self, requests: list[tuple[np.ndarray, int]]
                       ) -> np.ndarray:
        """(n, P) Exec_TID matrix: cost-model columns where the registry
        covers a replica, host-scale roofline fallback elsewhere."""
        pf = np.array([len(pr) for pr, _ in requests], dtype=np.float64)
        dc = np.array([nt for _, nt in requests], dtype=np.float64)
        cols = []
        for r in self.replicas:
            if r.name in self.unreachable:
                cols.append(np.full(len(requests), np.inf))
                continue
            col = (self.cost_registry.column_s(r, pf, dc)
                   if self.cost_registry is not None else None)
            if col is None:
                col = _host_scale_s(pf, dc) / r.speed
            cols.append(col)
        return np.stack(cols, axis=1)

    def schedule(self, requests: list[tuple[np.ndarray, int]]):
        """requests: [(prompt, new_tokens)] → list of (req_idx, replica_idx)."""
        n, p = len(requests), len(self.replicas)
        if self.tracer is not None:
            self.tracer.counter("frontend.queue_depth", depth=n)
        t0 = time.perf_counter()
        ex = self.exec_estimates(requests)
        avg = ex.mean(axis=1)
        avail = np.array([r.avail_at for r in self.replicas])
        if self.fabric is not None:
            order, assignment, start, finish, new_avail = self.fabric.map_event(
                avg, ex, avail, update=False)
        else:
            order, assignment, start, finish, new_avail = heft_rt_numpy(
                avg, ex, avail)
        dt = time.perf_counter() - t0
        if self.tracer is not None:
            self.tracer.complete("frontend.schedule", t0, dt, n=n, p=p)
        if self.metrics is not None:
            # Per-decision scheduler latency: one batched event amortized
            # over its n decisions (weight n keeps counts honest).
            self.metrics.histogram("frontend.decision_s").record(
                dt / max(n, 1), n=max(n, 1))
        new_avail = np.asarray(new_avail)
        for i, r in enumerate(self.replicas):
            r.avail_at = float(new_avail[i])
        return [(int(order[i]), int(assignment[i])) for i in range(n)]  # repro: noqa[host-sync-in-hot-path] map_event returns host arrays

    # -- fused-scheduler helpers ---------------------------------------------

    def _fused_enabled(self, fused: bool | None) -> bool:
        """Resolve ``run_continuous``'s ``fused`` knob: None follows the
        attached fabric's backend; True demands a fused-backend fabric."""
        is_fused = (self.fabric is not None
                    and getattr(self.fabric, "backend", None) == "fused")
        if fused is None:
            return is_fused
        if fused and not is_fused:
            raise ValueError(
                "fused=True requires a MappingFabric(backend='fused') "
                f"front-end fabric, got "
                f"{getattr(self.fabric, 'backend', None)!r}")
        return bool(fused)

    def _stage_event(self, requests: list[tuple[np.ndarray, int]]):
        """(avg, exec_times) for one mapping event — the operand half of
        :meth:`schedule`, reused by the fused tick path."""
        ex = self.exec_estimates(requests)
        return ex.mean(axis=1), ex

    def _adopt_decision(self, n: int, decision):
        """Turn a mapping-event 5-tuple into a plan, mirroring the fabric's
        resident ``new_avail`` registers into the replica handles."""
        order, assignment, _, _, new_avail = decision
        new_avail = np.asarray(new_avail)
        for i, r in enumerate(self.replicas):
            r.avail_at = float(new_avail[i])
        if self.tracer is not None:
            self.tracer.counter("frontend.queue_depth", depth=n)
        return [(int(order[i]), int(assignment[i])) for i in range(n)]

    def _loop_tracer(self):
        """The tracer ``run_continuous`` records on: the front end's own,
        else the one every replica's engine holds (None when they differ)."""
        if self.tracer is not None:
            return self.tracer
        held = {id(r.engine.tracer): r.engine.tracer for r in self.replicas}
        return next(iter(held.values())) if len(held) == 1 else None

    def run_batch(self, requests: list[tuple[np.ndarray, int]]):
        """Schedule + execute, returning (outputs, per-replica counts)."""
        plan = self.schedule(requests)
        outputs: dict[int, np.ndarray] = {}
        gen_hist = (self.metrics.histogram("engine.generate_s")
                    if self.metrics is not None else None)
        for req_idx, rep_idx in plan:
            prompt, new_tokens = requests[req_idx]
            rep = self.replicas[rep_idx]
            with Stopwatch(gen_hist) as sw:
                outputs[req_idx] = rep.engine.generate(prompt[None, :],
                                                       new_tokens)
            if self.tracer is not None:
                self.tracer.complete("frontend.generate", sw.start_s,
                                     sw.elapsed_s, replica=rep.name,
                                     new_tokens=new_tokens)
            rep.processed += 1
        return [outputs[i] for i in range(len(requests))], \
            {r.name: r.processed for r in self.replicas}

    def run_continuous(self, requests: list[tuple[np.ndarray, int]], *,
                       arrival_ticks: list[int] | None = None,
                       max_batch: int = 8, page_size: int = 16,
                       num_pages: int | None = None,
                       fused: bool | None = None):
        """Continuous batching: the admission tick the paper's scheduler
        needs to pay off on dynamic arrivals.

        Each tick, requests that have arrived are mapped to replicas with
        HEFT_RT (one sticky decision per request), each replica drains its
        mapped queue head-first into free batch slots (``admit``; a refusal
        leaves the head queued, FIFO), then every replica runs one
        ``decode_tick`` and retires finished slots.  Each request's tokens
        are bitwise ``engine.generate``'s run alone, under any interleaving.

        ``arrival_ticks[i]`` (default all 0) is the tick at which request
        ``i`` becomes visible.

        ``fused`` (default: on exactly when the attached fabric is
        ``backend="fused"``): arrivals' HEFT_RT decisions run *inside* a
        replica's decode tick against the fabric's device-resident
        registers and ride the tick's one device-to-host copy.  Mapped
        requests then join their queues one tick later than on the host
        path; when no replica has an active slot to carry the decision
        (cold start, idle fleet) it takes the host path (``map_event``)
        against the same registers.

        Traced (on the front end's tracer, else on the one every replica's
        engine holds), each iteration is a ``frontend.iteration`` span
        (``it``, and its ``arrived`` / ``mapped`` / ``admitted`` /
        ``refused`` / ``retired`` counts, the ``backlog`` arrived and not
        admitted at its end, the ``active`` lanes decoded) with a
        ``frontend.backlog`` counter; each admitted request a
        ``request.queue`` record from the start of its arrival iteration to
        the start of the ``admit`` that took it; each mapping event
        ``map.*`` spans sharing its ``event`` number (``map.stage``,
        ``map.event`` on the host path, ``map.adopt``; in a carrier's tick
        ``map.inputs`` / ``map.launch`` / ``map.commit``).  Untraced, none
        of this is built.

        Returns ``(outputs, stats)``: outputs in request order; stats with
        ``ticks``, per-replica ``processed``, the pools' cumulative
        ``allocated`` / ``freed`` page counts and ``slots_allocated`` /
        ``slots_freed`` slot counts (each pair equal at drain), the
        ``fused_decisions`` / ``host_decisions`` split, and ``latency_s``,
        each request's host seconds from the start of its arrival tick to
        its retire.
        """
        arrivals = arrival_ticks or [0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError("arrival_ticks must match requests")
        fused = self._fused_enabled(fused)
        fused_decisions = host_decisions = 0
        if fused:
            # The fabric's register file is the source of truth for T_avail
            # during the run: seeded from the handles once, then every
            # decision updates the resident registers and mirrors them back.
            self.fabric.reset(np.array([r.avail_at for r in self.replicas],
                                       dtype=np.float64))
        for r in self.replicas:
            if r.engine.paged is None:
                r.engine.start_paged(max_batch=max_batch,
                                     page_size=page_size,
                                     num_pages=num_pages)
            pool = r.engine.paged.pool
            for prompt, nt in requests:
                need = pool.pages_needed(len(prompt) + nt)
                if need > pool.num_pages:
                    raise ValueError(
                        f"request needs {need} pages but the pool holds "
                        f"{pool.num_pages} — it could never be admitted")
        order = sorted(range(len(requests)), key=lambda i: (arrivals[i], i))
        queues: list[list[int]] = [[] for _ in self.replicas]   # req idx FIFO
        slot_of: dict[tuple[int, int], int] = {}    # (rep, slot) → req idx
        outputs: dict[int, np.ndarray] = {}
        latency = [0.0] * len(requests)
        arrived_at: dict[int, float] = {}
        pending: list[int] = []     # fused path: arrived, not yet mapped
        tick = 0
        next_arrival = 0
        tr = self._loop_tracer()
        event = 0                   # fused path: mapping events so far
        while len(outputs) < len(requests):
            tick_start = time.perf_counter()
            with (NULL_SPAN if tr is None else
                  tr.span("frontend.iteration", it=tick)) as it_span:
                if tr is not None:
                    taken0, retired0 = len(slot_of) + len(outputs), len(outputs)
                mapped = decoded = 0
                # 1. HEFT_RT-map the newly arrived requests (sticky
                # decisions).
                batch = []
                while (next_arrival < len(order)
                       and arrivals[order[next_arrival]] <= tick):
                    batch.append(order[next_arrival])
                    arrived_at[order[next_arrival]] = tick_start
                    next_arrival += 1
                carrier = None
                if not fused:
                    if batch:
                        plan = self.schedule([requests[i] for i in batch])
                        mapped = len(plan)
                        for req_i, rep_i in plan:
                            queues[rep_i].append(batch[req_i])
                else:
                    pending.extend(batch)
                    if pending:
                        # The decision rides the first replica that will run
                        # a decode tick this round; with nothing in flight
                        # there is no tick to ride — take the host path now
                        # (against the same resident registers) so this tick
                        # admits.
                        carrier = next(
                            (i for i, r in enumerate(self.replicas)
                             if r.engine.paged is not None
                             and r.engine.paged.active_slots()), None)
                        if carrier is None:
                            with phase_span(tr, "map.stage", event,
                                            len(pending)):
                                avg, ex = self._stage_event(
                                    [requests[i] for i in pending])
                            with phase_span(tr, "map.event", event):
                                decision = self.fabric.map_event(avg, ex)
                            with phase_span(tr, "map.adopt", event):
                                plan = self._adopt_decision(len(pending),
                                                            decision)
                            event += 1
                            mapped = len(pending)
                            host_decisions += len(pending)
                            for req_i, rep_i in plan:
                                queues[rep_i].append(pending[req_i])
                            pending = []
                # 2. Admission tick: drain each mapped queue into free slots.
                for rep_i, r in enumerate(self.replicas):
                    while queues[rep_i]:
                        idx = queues[rep_i][0]
                        prompt, nt = requests[idx]
                        t_admit = time.perf_counter() if tr is not None else 0
                        slot = r.engine.admit(prompt, nt)
                        if slot is None:   # exhausted: stays queued (FIFO)
                            break
                        queues[rep_i].pop(0)
                        slot_of[(rep_i, slot)] = idx
                        if tr is not None:
                            tr.complete("request.queue", arrived_at[idx],
                                        t_admit - arrived_at[idx], req=idx,
                                        replica=rep_i, it=tick)
                if tr is not None:
                    # each queue left non-empty ended on a refused admit
                    refused = sum(1 for q in queues if q)
                # 3. Decode tick + retire finished slots.  On the fused path
                # the carrier's tick also maps the pending arrivals; they
                # reach their queues for the NEXT admission tick.
                for rep_i, r in enumerate(self.replicas):
                    if fused and pending and rep_i == carrier:
                        with phase_span(tr, "map.stage", event, len(pending)):
                            avg, ex = self._stage_event(
                                [requests[i] for i in pending])
                        toks, decision = r.engine.decode_tick(
                            (avg, ex, self.fabric, event))
                        with phase_span(tr, "map.adopt", event):
                            plan = self._adopt_decision(len(pending),
                                                        decision)
                        event += 1
                        mapped = len(pending)
                        fused_decisions += len(pending)
                        for req_i, rep_to in plan:
                            queues[rep_to].append(pending[req_i])
                        pending = []
                    else:
                        toks = r.engine.decode_tick()
                    decoded += len(toks)
                    for slot in r.engine.finished_slots():
                        idx = slot_of.pop((rep_i, slot))
                        outputs[idx] = r.engine.retire(slot)
                        latency[idx] = time.perf_counter() - arrived_at[idx]
                        r.processed += 1
                if tr is not None:
                    taken = len(slot_of) + len(outputs)
                    backlog = next_arrival - taken
                    it_span.set(arrived=len(batch), mapped=mapped,
                                admitted=taken - taken0, refused=refused,
                                retired=len(outputs) - retired0,
                                backlog=backlog, active=decoded)
                    tr.counter("frontend.backlog", backlog=backlog)
            tick += 1
        stats = {
            "ticks": tick,
            "processed": {r.name: r.processed for r in self.replicas},
            "allocated": sum(r.engine.paged.pool.allocated
                             for r in self.replicas),
            "freed": sum(r.engine.paged.pool.freed for r in self.replicas),
            "slots_allocated": sum(r.engine.paged.pool.slots_allocated
                                   for r in self.replicas),
            "slots_freed": sum(r.engine.paged.pool.slots_freed
                               for r in self.replicas),
            "fused_decisions": fused_decisions,
            "host_decisions": host_decisions,
            "latency_s": latency,
        }
        return [outputs[i] for i in range(len(requests))], stats


def mesh_backed_fleet(cfg: ModelConfig, params, mesh_shapes, *,
                      max_len: int = 128, lanes: int = 8,
                      arch: str | None = None, axes: MeshAxes | None = None,
                      devices=None, chip_tflops: float = 1.0,
                      chip_hbm_gbps: float = 1.0, ici_gbps: float = 0.0,
                      return_spare: bool = False, device=None):
    """Carve the world into mesh slices and build one replica each.

    ``mesh_shapes`` like ``[(1, 1), (2, 1), (2, 2)]`` give replicas of
    mixed parallelism, whose aggregate rates (and HEFT_RT speed fallback)
    scale with the slice size.  ``params`` (one meshless model, the same
    on every rank) seeds every replica.  ``devices`` is the pool of global
    ranks (the world by default), ``device`` the meshes' device type (the
    card unless told otherwise); ``return_spare=True`` also returns the
    ranks left over.  Collective over the world."""
    from repro_torch.launch.mesh import slice_device_pool

    ax = axes or MeshAxes()
    meshes, spare = slice_device_pool(mesh_shapes, (ax.data, ax.model),
                                      devices=devices, return_remainder=True,
                                      device=device)
    fleet = []
    for i, mesh in enumerate(meshes):
        shape = tuple(mesh.mesh.shape)
        n = math.prod(shape)
        eng = ServeEngine(cfg, params, max_len=max_len, lanes=lanes,
                          mesh=mesh, axes=ax)
        fleet.append(ReplicaHandle(
            f"{cfg.name}@{'x'.join(map(str, shape))}#{i}", eng,
            speed=float(n), arch=arch or cfg.name,
            compute_tflops=n * chip_tflops, hbm_gbps=n * chip_hbm_gbps,
            ici_gbps=ici_gbps))
    if return_spare:
        return fleet, spare
    return fleet

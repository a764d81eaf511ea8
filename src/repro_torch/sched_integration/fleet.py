"""Elastic fleet subsystem: resize + failure events and the fleet controller.

The paper schedules *dynamically arriving* work onto a PE pool whose
availability state lives in fabric registers — and on real SoCs the pool
itself is dynamic too: PEs are power-gated, reclaimed, or re-partitioned at
runtime (HTS, arXiv:1907.00271; Mack et al., arXiv:2112.08980).  The serving
analogue is an *elastic fleet*: replicas join/leave mid-run and mesh slices
split/merge as load shifts.  This module is the control plane for that:

* :class:`ResizeEvent` — one timeline entry: at time ``t``, remove replicas
  by name and/or add new :class:`~repro_torch.sched_integration.serve_scheduler.
  Replica`s.  ``simulate_serving(fleet_events=[...])`` replays a scripted
  timeline; an empty timeline is bit-identical to the fixed-fleet simulator.
* :class:`FailureEvent` — the chaos-tier timeline entry beside it: replica
  loss mid-decode, straggler windows (PE speed degraded ×k), and link
  degrade/partition windows on an attached
  :class:`~repro_torch.sched_integration.topology.Topology`.
  ``simulate_serving(failure_events=[...])`` consumes them; an empty
  timeline is bit-identical to the failure-free simulator.
* :func:`split_event` / :func:`merge_event` — re-carve a replica's devices
  into smaller slices (or several replicas into one bigger slice), the
  simulator-side mirror of ``launch.mesh.slice_device_pool`` re-carving.
  Device counts must balance exactly; rates re-aggregate per device.
* :class:`FleetController` — the closed loop: consumes load signals (ready-
  queue depth, p95 latency) each mapping event, and emits grow/shrink
  ``ResizeEvent``s with a cooldown, recording a human-readable decision
  trace.  ``simulate_serving(controller=...)`` drives it from the simulator;
  the live-engine side drives :meth:`HeftFrontEnd.add_replica` /
  ``remove_replica`` (whose attached ``MappingFabric`` grows/shrinks its
  T_avail registers in place) plus ``ServeEngine.reshard`` for migrations.
  The same controller owns *straggler remap*: per-replica backlog signals
  (the serving twin of ``repro_torch.obs``'s ``serve.replica_util`` /
  ``fabric.decision_s`` rails) feed :meth:`FleetController.
  observe_stragglers`, which flags replicas whose queue horizon runs
  ``straggler_factor``× past the fleet median — under a per-replica
  exponential backoff — and the simulator re-queues their not-yet-started
  work onto the healthy fleet (bounded by the per-request retry budget).

Recovery contract (enforced by ``simulate_serving``'s end-of-run invariant):
work committed to a replica that is *lost* — whether still in the roster or
already in its drain-then-leave window — is re-queued through the mapping
policy, never silently dropped; every request ends exactly served or
unserved, with its re-queue count in ``ServeResult.requeued``; a served
request's finish never postdates its replica's loss instant.

Cost-model coupling: a replica added with a mesh shape that was never
dry-run gets its Exec_TID cells projected from the arch's largest measured
cell (``CostModelRegistry.ensure_coverage`` → ``scaled_cell``), so mid-run
joiners are scheduled from calibrated estimates, not the blank roofline.

PyTorch port of ``repro.sched_integration.fleet`` (pure Python and numpy,
unchanged but for its imports).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np

from repro_torch.obs.trace import TraceEvent
from repro_torch.sched_integration.serve_scheduler import Replica, Request


@dataclass(frozen=True)
class ResizeEvent:
    """One fleet-resize step: at ``t``, drop ``remove`` (names), then join
    ``add`` (Replica objects).  Removal stops *new* assignments; work already
    committed to a removed replica finishes undisturbed (drain-then-leave)."""

    t: float
    add: tuple = ()
    remove: tuple = ()
    reason: str = ""


# Chaos-tier failure kinds and their knobs:
#   replica_loss   target=replica name.  The replica dies instantly (no
#                  drain): unfinished committed work re-queues, the roster
#                  shrinks.  A loss may also target a replica already in a
#                  drain-then-leave window — its in-flight work re-queues
#                  the same way.
#   straggler      target=replica name, factor (>1: exec ×factor),
#                  duration_s window.  Exec column, queue horizon, and
#                  in-flight finishes stretch for the window, then restore
#                  bit-exact from the cost model.
#   link_degrade   target="podA:podB", factor in (0,1) scales bandwidth,
#                  duration_s window.  Needs simulate_serving(topology=...).
#   link_partition target="podA:podB", duration_s window: the link is down;
#                  replicas cut off from the gateway are masked (+inf exec)
#                  for the window, transfers wait the window out.
FAILURE_KINDS = ("replica_loss", "straggler", "link_degrade",
                 "link_partition")
_WINDOWED_KINDS = ("straggler", "link_degrade", "link_partition")


@dataclass(frozen=True)
class FailureEvent:
    """One chaos-timeline entry: at ``t``, ``kind`` strikes ``target``.

    See :data:`FAILURE_KINDS` for the kind/knob inventory.  Windowed kinds
    (everything but ``replica_loss``) recover automatically at
    ``t + duration_s``; the simulator emits ``serve.failure`` /
    ``serve.recovery`` tracer instants and ``serve.failures`` /
    ``serve.retries`` counters for both edges.
    """

    t: float
    kind: str
    target: str
    duration_s: float = 0.0
    factor: float = 1.0
    reason: str = ""

    def __post_init__(self):
        if self.kind not in FAILURE_KINDS:
            raise ValueError(
                f"failure kind must be one of {FAILURE_KINDS}, "
                f"got {self.kind!r}")
        if not self.target:
            raise ValueError(f"failure event at t={self.t} has no target")
        if self.kind in _WINDOWED_KINDS and not self.duration_s > 0:
            raise ValueError(
                f"{self.kind} at t={self.t} needs duration_s > 0, "
                f"got {self.duration_s}")
        if self.kind == "straggler" and not self.factor > 1.0:
            raise ValueError(
                f"straggler factor must be > 1 (a slowdown), "
                f"got {self.factor}")
        if self.kind == "link_degrade" and not (0.0 < self.factor < 1.0):
            raise ValueError(
                f"link_degrade factor must be in (0, 1), got {self.factor}")


_TIMELINE_FIELDS = {"t": (int, float), "kind": str, "target": str,
                    "duration_s": (int, float), "factor": (int, float),
                    "reason": str}
_TIMELINE_REQUIRED = ("t", "kind", "target")


def validate_failure_timeline(obj) -> list[FailureEvent]:
    """Schema-validate a chaos-trace object (the ``--chaos TRACE.json``
    payload) and build the :class:`FailureEvent` timeline.

    Same style as ``repro_torch.obs.check``: loud ``ValueError`` on any schema
    violation — unknown keys, missing required fields, wrong types, or
    per-kind knob violations (delegated to ``FailureEvent.__post_init__``).
    Schema::

        {"events": [{"t": 0.5, "kind": "replica_loss", "target": "r0",
                     "duration_s": 1.0, "factor": 4.0, "reason": "..."}]}
    """
    if not isinstance(obj, dict):
        raise ValueError(f"chaos trace root must be an object, "
                         f"got {type(obj).__name__}")
    events = obj.get("events")
    if not isinstance(events, list):
        raise ValueError("chaos trace has no 'events' list")
    out = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"events[{i}] is not an object")
        unknown = set(ev) - set(_TIMELINE_FIELDS)
        if unknown:
            raise ValueError(f"events[{i}] has unknown keys {sorted(unknown)} "
                             f"(schema keys: {sorted(_TIMELINE_FIELDS)})")
        for key in _TIMELINE_REQUIRED:
            if key not in ev:
                raise ValueError(f"events[{i}] missing required {key!r}")
        for key, want in _TIMELINE_FIELDS.items():
            if key in ev and not isinstance(ev[key], want):
                raise ValueError(
                    f"events[{i}].{key} must be "
                    f"{getattr(want, '__name__', want)}, got {ev[key]!r}")
        out.append(FailureEvent(**ev))
    return out


def load_failure_timeline(path: str) -> list[FailureEvent]:
    """Load + schema-validate a ``--chaos TRACE.json`` failure timeline."""
    with open(path) as f:
        obj = json.load(f)
    return validate_failure_timeline(obj)


def _unit_rates(rep: Replica) -> tuple[float, float]:
    """Per-device (compute, hbm) rates from a mesh-backed replica's
    aggregates."""
    if rep.mesh_shape is None:
        raise ValueError(
            f"replica {rep.name!r} has no mesh_shape — split/merge re-carve "
            f"devices, so only mesh-backed replicas can resize")
    n = math.prod(rep.mesh_shape)
    return rep.compute_tflops / n, rep.hbm_gbps / n


def split_event(t: float, rep: Replica, shapes, *, reason: str = "") -> ResizeEvent:
    """Re-carve one replica's devices into smaller slices.

    ``shapes`` must tile the replica's device count exactly (the
    ``slice_device_pool`` contract); aggregate rates redistribute
    per-device.
    """
    ct, hb = _unit_rates(rep)          # validates mesh backing first
    shapes = [tuple(int(d) for d in s) for s in shapes]
    n = math.prod(rep.mesh_shape)
    need = sum(math.prod(s) for s in shapes)
    if need != n:
        raise ValueError(
            f"split of {rep.name!r}: shapes {shapes} use {need} devices but "
            f"the replica's {rep.mesh_shape} slice has {n}")
    adds = tuple(
        Replica(f"{rep.name}/s{i}", math.prod(s) * ct, math.prod(s) * hb,
                arch=rep.arch, mesh_shape=s, ici_gbps=rep.ici_gbps,
                slots=rep.slots)
        for i, s in enumerate(shapes))
    return ResizeEvent(t, add=adds, remove=(rep.name,),
                       reason=reason or f"split {rep.name} -> {shapes}")


def merge_event(t: float, reps, shape, *, name: str | None = None,
                reason: str = "") -> ResizeEvent:
    """Merge several replicas' devices into one bigger slice.

    The merged slice's device count must equal the sum of the parts; all
    parts must share per-device rates (one chip generation per merge, the
    ``slice_device_pool`` pool contract) — mixing generations would credit
    the merged slice the wrong aggregate capacity.
    """
    reps = list(reps)
    rates = [_unit_rates(r) for r in reps]          # validates mesh backing
    (ct, hb), *rest = rates
    if any(not (math.isclose(c, ct, rel_tol=1e-9)
                and math.isclose(h, hb, rel_tol=1e-9)) for c, h in rest):
        raise ValueError(
            f"merge of {[r.name for r in reps]}: parts have mixed "
            f"per-device rates {rates} — one chip generation per merge")
    shape = tuple(int(d) for d in shape)
    total = sum(math.prod(r.mesh_shape) for r in reps)
    if math.prod(shape) != total:
        raise ValueError(
            f"merge of {[r.name for r in reps]}: target {shape} has "
            f"{math.prod(shape)} devices but the parts hold {total}")
    n = math.prod(shape)
    merged = Replica(name or f"{reps[0].name}/m{'x'.join(map(str, shape))}",
                     n * ct, n * hb, arch=reps[0].arch, mesh_shape=shape,
                     ici_gbps=reps[0].ici_gbps, slots=reps[0].slots)
    return ResizeEvent(t, add=(merged,), remove=tuple(r.name for r in reps),
                       reason=reason or
                       f"merge {[r.name for r in reps]} -> {shape}")


@dataclass
class FleetControllerConfig:
    """Thresholds for the grow/shrink loop.

    Grow when ANY enabled signal crosses its threshold (``inf`` disables
    one): ``grow_backlog_s`` — mean committed-but-unfinished work per
    replica, in seconds of queue horizon (the serving analogue of the
    paper's ``T_avail`` registers running ahead of the clock);
    ``grow_queue_depth`` — ready requests awaiting dispatch;
    ``grow_p95_s`` — p95 latency over requests *committed in the last*
    ``p95_window_s`` *seconds* (their estimated completion; in the
    simulator a commit pins the finish time).  The window matters: a
    cumulative p95 would latch "overloaded" forever after one spike.
    Shrink (retire the most recent grown replica) when the backlog AND
    queue are both at or under their shrink thresholds and no grow signal
    is firing — shrinking while overloaded would just oscillate against
    the next grow.  ``cooldown_s`` rate-limits decisions; ``max_grown``
    bounds concurrently grown replicas (the spare-device budget).
    """

    grow_backlog_s: float = 2.0
    grow_queue_depth: float = float("inf")
    grow_p95_s: float = float("inf")
    p95_window_s: float = 5.0
    shrink_backlog_s: float = 0.25
    shrink_queue_depth: float = 2.0
    cooldown_s: float = 0.5
    max_grown: int = 4
    # Straggler remap (chaos tier; inf disables).  A replica is flagged when
    # its committed-but-unfinished backlog runs straggler_factor× past the
    # fleet median (with straggler_min_backlog_s as an absolute floor, so a
    # near-idle fleet never flags noise).  Re-flagging the same replica backs
    # off exponentially from straggler_cooldown_s — a persistent straggler is
    # remapped less and less often, bounding remap churn alongside the
    # per-request retry budget.
    straggler_factor: float = float("inf")
    straggler_min_backlog_s: float = 0.5
    straggler_cooldown_s: float = 0.5


class FleetController:
    """Load signals → :class:`ResizeEvent`s, with a decision trace.

    ``make_replica(idx)`` is the grow factory — it returns the Replica a
    grow decision adds (e.g. a ``(2, 2)`` slice carved from the spare
    device pool; see :func:`grown_replica_factory`).  The controller owns
    the lifecycle of what it adds: shrink decisions retire its own grown
    replicas (most recent first) and never touch the base fleet.

    The decision trace is structured: ``events`` is a list of
    :class:`repro_torch.obs.TraceEvent` instants (``fleet.grow`` /
    ``fleet.shrink``, stamped at *simulated* time, with the decision's
    ``t``/``kind``/``why`` in args), mirrored into an attached ``tracer``
    so controller decisions land on the same exported timeline as the
    fabric/serve spans.  The legacy ``trace`` list of ``(t, kind, why)``
    tuples is preserved as a derived view.
    """

    def __init__(self, cfg: FleetControllerConfig, make_replica, *,
                 tracer=None):
        self.cfg = cfg
        self._make = make_replica
        self.grown: list[str] = []
        self.events: list[TraceEvent] = []   # structured decision trace
        self._tracer = tracer
        self._last_t = -float("inf")
        self._next_id = 0
        # Straggler-remap backoff state: next allowed flag time and current
        # backoff width, per replica name.
        self._straggler_next: dict[str, float] = {}
        self._straggler_backoff: dict[str, float] = {}

    @property
    def trace(self) -> list[tuple[float, str, str]]:
        """Decision log as ``(t, kind, why)`` tuples (compat view over
        :attr:`events`)."""
        return [(e.args["t"], e.args["kind"], e.args["why"])
                for e in self.events]

    def _note(self, t: float, kind: str, why: str) -> None:
        ev = TraceEvent(f"fleet.{kind}", "i", t * 1e6,
                        args={"t": t, "kind": kind, "why": why})
        self.events.append(ev)
        if self._tracer is not None:
            self._tracer.record(ev)

    def observe(self, t: float, *, queue_depth: int = 0,
                backlog_s: float = 0.0,
                p95_s: float = 0.0) -> ResizeEvent | None:
        """One control tick.  Returns the resize to apply now, or None."""
        cfg = self.cfg
        if t - self._last_t < cfg.cooldown_s:
            return None
        overloaded = (backlog_s >= cfg.grow_backlog_s
                      or queue_depth >= cfg.grow_queue_depth
                      or p95_s >= cfg.grow_p95_s)
        if overloaded and len(self.grown) < cfg.max_grown:
            rep = self._make(self._next_id)
            self._next_id += 1
            self.grown.append(rep.name)
            self._last_t = t
            p95 = f" p95={p95_s * 1e3:.0f}ms" if p95_s > 0 else ""
            why = (f"backlog={backlog_s:.2f}s queue={queue_depth}{p95} "
                   f"-> +{rep.name}")
            self._note(t, "grow", why)
            return ResizeEvent(t, add=(rep,), reason=why)
        drained = (backlog_s <= cfg.shrink_backlog_s
                   and queue_depth <= cfg.shrink_queue_depth)
        if drained and not overloaded and self.grown:
            name = self.grown.pop()
            self._last_t = t
            why = f"backlog={backlog_s:.2f}s queue={queue_depth} -> -{name}"
            self._note(t, "shrink", why)
            return ResizeEvent(t, remove=(name,), reason=why)
        return None

    def observe_stragglers(self, t: float, names, backlogs) -> list[str]:
        """Flag replicas whose backlog runs ``straggler_factor``× past the
        fleet median — the controller-driven remap trigger.

        ``backlogs[i]`` is replica ``names[i]``'s committed-but-unfinished
        queue horizon in seconds (``T_avail - t``, clamped at 0) — the same
        signal ``repro_torch.obs`` exposes as per-replica utilization.  Flagged
        names are re-queued by the simulator (their not-yet-started work goes
        back through the mapping policy); each flag doubles that replica's
        personal backoff window starting from ``straggler_cooldown_s``, and
        a replica observed healthy again resets its backoff.  Returns the
        flagged names (possibly empty); detection disabled while
        ``straggler_factor`` is ``inf``.
        """
        cfg = self.cfg
        if not math.isfinite(cfg.straggler_factor) or len(names) < 2:
            return []
        backlogs = [float(b) for b in backlogs]
        med = float(np.median(backlogs))
        bar = max(cfg.straggler_factor * med, cfg.straggler_min_backlog_s)
        flagged = []
        for name, b in zip(names, backlogs):
            if b < bar:
                # Healthy again: forgive the backoff history.
                self._straggler_backoff.pop(name, None)
                self._straggler_next.pop(name, None)
                continue
            if t < self._straggler_next.get(name, -float("inf")):
                continue
            backoff = self._straggler_backoff.get(
                name, cfg.straggler_cooldown_s)
            self._straggler_next[name] = t + backoff
            self._straggler_backoff[name] = 2.0 * backoff
            why = (f"backlog={b:.2f}s median={med:.2f}s "
                   f"backoff={backoff:.2f}s -> remap {name}")
            self._note(t, "remap", why)
            flagged.append(name)
        return flagged


def grown_replica_factory(arch: str, shape, *, chip_tflops: float = 197.0,
                          chip_hbm_gbps: float = 819.0, mfu: float = 0.5,
                          hbm_eff: float = 0.6, ici_gbps: float = 0.0):
    """``make_replica`` factory for :class:`FleetController`: each grow adds
    one ``shape``-slice replica of the given chip generation (the same rate
    model as ``mesh_fleet``)."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)

    def make(idx: int) -> Replica:
        return Replica(f"{arch}@{'x'.join(map(str, shape))}+g{idx}",
                       n * chip_tflops * mfu, n * chip_hbm_gbps * hbm_eff,
                       arch=arch, mesh_shape=shape, ici_gbps=ici_gbps)

    return make


def make_spike_requests(base_rps: float, spike_rps: float, *,
                        spike_start: float, spike_end: float,
                        duration_s: float, seed: int = 0,
                        prefill_range=(128, 4096),
                        decode_range=(16, 512)) -> list[Request]:
    """Poisson arrivals with a rate spike in ``[spike_start, spike_end)`` —
    the scripted-load workload the elastic example/benchmark replay.  One
    ``make_requests`` rate function, not a second arrival loop."""
    from repro_torch.sched_integration.serve_scheduler import make_requests

    return make_requests(
        lambda t: spike_rps if spike_start <= t < spike_end else base_rps,
        duration_s, seed=seed,
        prefill_range=prefill_range, decode_range=decode_range)

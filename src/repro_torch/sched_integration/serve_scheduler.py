"""HEFT_RT as an LLM-serving request scheduler over heterogeneous replicas.

The paper's scenario — dynamically arriving jobs mapped onto PEs with
non-uniform speeds by a low-latency scheduler — is exactly the serving
front-end problem for a fleet of heterogeneous model replicas (mixed pod
sizes / chip generations / MFU profiles).  Requests are tasks; replicas are
PEs; ``Exec[r, p]`` is the roofline-model estimate of request r's service
time on replica p (prefill FLOPs / replica compute + decode bytes / replica
bandwidth); ``T_avail`` is each replica's queue horizon.

``simulate_serving`` runs the oversubscription experiment (paper Figs 5/6
transplanted): offered load sweeps past fleet capacity, and HEFT_RT is
compared against round-robin / least-loaded / random dispatch on achieved
throughput and latency.  The hot path is fabric-batched (see
:mod:`repro_torch.sched_integration.fabric`): the (N, P) exec matrix comes from
one vectorized roofline op, the tick loop jumps to the next arrival's event
horizon instead of spinning empty scheduler ticks, and each mapping event
commits its assignments with vectorized per-replica chains.

PyTorch port of ``repro.sched_integration.serve_scheduler``: the simulator is
numpy and unchanged; its ``heft_rt`` policy runs on the port's
:class:`~repro_torch.sched_integration.fabric.MappingFabric` (the CUDA kernels
on the card, the float64 host path with ``device="cpu"``).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.core.heft_rt import heft_rt_numpy
from repro_torch.sched_integration.fabric import make_policy_fabric, service_time_matrix
from repro_torch.sched_integration.topology import migration_bytes, parse_link_target

_INF = float("inf")


@dataclass(frozen=True)
class Replica:
    """One PE of the serving fleet.

    ``compute_tflops`` / ``hbm_gbps`` are the replica's *aggregate* effective
    rates (per-chip rate × mesh size × MFU).  The optional mesh backing
    (``arch`` + ``mesh_shape``, a slice of one device pool — see the
    reference's ``repro.launch.mesh.slice_device_pool``) keys the replica
    into the dry-run cost-model registry so its Exec_TID column comes from measured
    FLOPs/bytes instead of the analytic roofline; ``ici_gbps`` > 0
    additionally charges the cell's collective wire bytes.

    ``slots`` is the continuous-batching twin of ``ServeEngine.start_paged``
    (``max_batch``): the replica serves up to ``slots`` requests
    concurrently, each on its own FIFO chain, and the scheduler-facing
    availability register is the *earliest-free chain*.  ``slots=1`` (the
    default) is bit-identical to the original single-chain simulator.
    """

    name: str
    compute_tflops: float      # effective bf16 throughput (MFU-adjusted)
    hbm_gbps: float            # effective memory bandwidth
    arch: str | None = None              # cost-model key: architecture name
    mesh_shape: tuple[int, ...] | None = None   # cost-model key: mesh slice
    ici_gbps: float = 0.0                # interconnect rate for wire bytes
    slots: int = 1                       # concurrent batch slots (paged serve)


@dataclass(frozen=True)
class Request:
    rid: int
    arrival: float
    prefill_tokens: int
    decode_tokens: int


def service_time_s(req: Request, rep: Replica, *, active_params: float) -> float:
    """Roofline estimate: prefill compute-bound, decode bandwidth-bound."""
    prefill_flops = 2.0 * active_params * req.prefill_tokens
    decode_bytes = 2.0 * active_params * req.decode_tokens  # weights/token
    return (prefill_flops / (rep.compute_tflops * 1e12)
            + decode_bytes / (rep.hbm_gbps * 1e9))


def make_requests(rate_rps, duration_s: float, seed: int = 0,
                  prefill_range=(128, 4096), decode_range=(16, 512)):
    """Poisson arrivals at ``rate_rps`` — a constant, or a ``rate(t)``
    callable for time-varying load (a constant draws identically to the
    pre-callable version; ``fleet.make_spike_requests`` builds spikes on
    top of this).  The rate must stay positive — model a quiet interval
    with a small positive rate, not zero (the exponential gap would be
    infinite)."""
    rate = rate_rps if callable(rate_rps) else (lambda t: rate_rps)
    rng = np.random.default_rng(seed)
    t, out, rid = 0.0, [], 0
    while True:
        r = float(rate(t))
        if r <= 0.0:
            raise ValueError(
                f"rate(t={t:.3f}) = {r} — arrival rates must be positive "
                f"(use a small rate for quiet intervals, not zero)")
        t += rng.exponential(1.0 / r)
        if t > duration_s:
            break
        out.append(Request(
            rid, t,
            int(rng.integers(*prefill_range)),
            int(rng.integers(*decode_range))))
        rid += 1
    return out


# ---------------------------------------------------------------------------
# dispatch policies: (exec_times (n,P), avail (P,)) -> assignment (n,)
# ---------------------------------------------------------------------------

def policy_heft_rt(exec_times, avail):
    """Reference HEFT_RT policy through the unbatched numpy oracle."""
    avg = exec_times.mean(axis=1)
    order, assignment, _, _, _ = heft_rt_numpy(avg, exec_times, avail)
    out = np.empty(exec_times.shape[0], dtype=np.int64)
    out[order] = assignment
    return out


def make_policy_round_robin():
    state = {"next": 0}

    def policy(exec_times, avail):
        n, P = exec_times.shape
        out = (state["next"] + np.arange(n, dtype=np.int64)) % P
        state["next"] += n
        return out
    return policy


def policy_least_loaded(exec_times, avail):
    av = avail.copy()
    out = np.empty(exec_times.shape[0], dtype=np.int64)
    for i in range(exec_times.shape[0]):
        p = int(np.argmin(av))
        out[i] = p
        av[p] += exec_times[i, p]
    return out


def make_policy_random(seed=0):
    rng = np.random.default_rng(seed)

    def policy(exec_times, avail):
        n, P = exec_times.shape
        return rng.integers(0, P, n).astype(np.int64)
    return policy


POLICIES = {
    "heft_rt": make_policy_fabric,   # fabric front-end, oracle-identical
    "round_robin": make_policy_round_robin,
    "least_loaded": lambda: policy_least_loaded,
    "random": make_policy_random,
}


@dataclass
class ServeResult:
    offered_rps: float
    achieved_rps: float
    p50_latency: float
    p99_latency: float
    mean_latency: float
    replica_util: np.ndarray
    served_mask: np.ndarray | None = None   # per-request served flags (N,)
    requeued: np.ndarray | None = None      # per-request re-queue counts (N,)
    finish_times: np.ndarray | None = None  # per-request finish (NaN: unserved)
    final_avail: np.ndarray | None = None   # final-roster T_avail horizons (P,)


def simulate_serving(replicas: list[Replica], requests: list[Request],
                     policy, *, active_params: float,
                     sched_tick_s: float = 0.005,
                     exec_matrix: np.ndarray | None = None,
                     cost_registry=None,
                     fleet_events=None,
                     failure_events=None,
                     topology=None,
                     retry_budget: int = 3,
                     controller=None,
                     tracer=None,
                     metrics=None) -> ServeResult:
    """Tick-based continuous dispatch, event-horizon-driven: at every tick
    with arrived work, the ready queue is mapped by ``policy`` onto replica
    queues and committed in one vectorized pass; ticks with no ready work
    fast-forward to the next arrival's tick.

    ``exec_matrix`` overrides the roofline estimates with an explicit (N, P)
    matrix aligned with ``requests`` (rows of ``+inf`` mark requests no
    replica can serve; those are reported unserved rather than committed).
    ``cost_registry`` (a
    :class:`~repro_torch.sched_integration.cost_model.CostModelRegistry`) derives
    the Exec_TID matrix from dry-run cost cells for mesh-backed replicas,
    with the roofline as fallback for uncovered (arch × mesh) cells.

    Elastic fleet: ``fleet_events`` is a timeline of
    :class:`~repro_torch.sched_integration.fleet.ResizeEvent`s (replicas join /
    leave / split / merge at their event times); ``controller`` (a
    :class:`~repro_torch.sched_integration.fleet.FleetController`) closes the loop
    instead, observing (queue depth, p95 latency) at each mapping event and
    emitting resizes live.  Both recompute the Exec_TID columns for the new
    fleet mid-run — from ``cost_registry`` when given (joiners with never-
    dry-run shapes get ``scaled_cell``-projected cells via
    ``ensure_coverage``), roofline otherwise — and both are incompatible
    with a pinned ``exec_matrix``.  An empty/None timeline leaves every code
    path untouched: results are bit-identical to the fixed-fleet simulator.
    Removal is drain-then-leave (committed work finishes; no new
    assignments).  With an elastic fleet, ``replica_util`` covers the final
    roster.

    Chaos tier: ``failure_events`` is a timeline of
    :class:`~repro_torch.sched_integration.fleet.FailureEvent`s beside the resize
    timeline — ``replica_loss`` kills a replica instantly (its unfinished
    work, mid-decode included, re-queues through the mapping policy with no
    budget check: losses are never dropped), ``straggler`` slows a replica
    ×factor for a window (exec column, queue horizon, and in-flight
    starts/finishes stretch around the event time, then restore bit-exact
    from the cost model at the window's end), and ``link_degrade`` /
    ``link_partition`` drive an attached
    :class:`~repro_torch.sched_integration.topology.Topology` (partitioned
    replicas' columns mask to ``+inf`` for the window — in-flight work keeps
    running, new admissions divert).  Like resizes, failures apply lazily at
    the next mapping event at or after their ``t``; failures striking after
    the last dispatch are drained against in-flight work and their re-queues
    re-enter the dispatch loop.  ``topology`` additionally charges each
    joining replica's migration (``migration_bytes(active_params)`` from the
    gateway to its pod, with link contention) as its initial queue horizon.
    Straggler *remap* is controller-driven: a controller with a finite
    ``straggler_factor`` observes per-replica backlogs each mapping event
    and flagged replicas' not-yet-started work re-queues, bounded per
    request by ``retry_budget``.  An empty/None failure timeline leaves
    every code path untouched — bit-identical to the failure-free
    simulator.

    Recovery is *provable*, not assumed: the end-of-run invariant check
    raises unless ``commits - requeues == served`` and every unserved
    request holds no assignment — ``served_mask`` + ``requeued`` +
    unserved account for the request set exactly, so a silently dropped
    request is a crash, not a statistic.

    Observability: ``tracer`` (a :class:`repro_torch.obs.Tracer`) gets a
    ``serve.queue_depth`` counter timeline stamped at each mapping event's
    *simulated* time plus ``serve.resize`` / ``serve.failure`` /
    ``serve.recovery`` / ``serve.requeue`` instants; ``metrics`` (a
    :class:`repro_torch.obs.MetricsRegistry`) gets mapping-event / commit
    counters, ``serve.failures`` / ``serve.retries`` (labeled by kind /
    cause), and, at the end, per-replica busy/idle utilization gauges and
    served/unserved counts.  Both only *read* simulator state — the
    ``ServeResult`` is bit-identical with or without them.
    """
    replicas = list(replicas)
    P = len(replicas)
    N = len(requests)
    arrivals = np.array([r.arrival for r in requests])
    events = sorted(fleet_events, key=lambda e: e.t) if fleet_events else []
    fails = sorted(failure_events, key=lambda e: e.t) if failure_events else []
    elastic = bool(events) or controller is not None
    dynamic = elastic or bool(fails)
    if fails and topology is None and any(
            e.kind in ("link_degrade", "link_partition") for e in fails):
        raise ValueError(
            "link_degrade/link_partition failure events need a topology — "
            "pass simulate_serving(topology=...)")
    if exec_matrix is not None:
        if elastic:
            raise ValueError(
                "fleet_events/controller recompute Exec_TID columns as the "
                "fleet resizes — use cost_registry or the roofline, not a "
                "pinned exec_matrix")
        if any(e.kind != "replica_loss" for e in fails):
            raise ValueError(
                "straggler/link failure events restore Exec_TID columns "
                "from the cost model — use cost_registry or the roofline, "
                "not a pinned exec_matrix")
        ex_all = np.asarray(exec_matrix, dtype=np.float64)
    elif cost_registry is not None:
        ex_all = cost_registry.exec_tid_matrix(requests, replicas,
                                               active_params=active_params)
    else:
        ex_all = service_time_matrix(requests, replicas,
                                     active_params=active_params)
    by_arrival = np.argsort(arrivals, kind="stable")
    arr_sorted = arrivals[by_arrival]

    tick = sched_tick_s
    end = float(arrivals.max()) + 1.0
    guard_end = end + 3600.0                     # runaway-clock guard horizon

    # Per-replica slot chains (Replica.slots concurrent FIFO chains — the
    # simulator twin of the paged engine's batch slots).  ``free_at`` stays
    # the scheduler-facing availability register = min over the replica's
    # chains; at slots=1 every operation below degenerates to the original
    # single-chain arithmetic bit-for-bit.
    slot_free = [[0.0] * max(int(r.slots), 1) for r in replicas]
    free_at = [0.0] * P                          # per-replica queue horizon
    busy = [0.0] * P
    finish_all = np.full(N, np.nan)              # per-request finish (NaN: unserved)
    ready: list[int] = []                        # request indices awaiting dispatch
    done_lat: list[tuple[float, float]] = []     # (commit_t, latency) window
    # Only pay for the p95 signal when the controller consults it, and keep
    # it *windowed*: a cumulative percentile would latch "overloaded"
    # forever after one spike (and grow O(N log N) per mapping event).
    ctl_cfg = getattr(controller, "cfg", None)
    p95_enabled = (controller is not None
                   and np.isfinite(getattr(ctl_cfg, "grow_p95_s", np.inf)))
    p95_window_s = float(getattr(ctl_cfg, "p95_window_s", 5.0) or 5.0)
    idx = 0
    t = 0.0

    # Unified event queue: scripted resizes, the failure timeline, and the
    # recovery events windowed failures push at apply time, all popped in
    # (t, insertion) order — at equal t resizes apply before failures, and
    # both apply lazily at the next mapping event (commits only happen
    # there, so the timelines are equivalent).
    evq: list[tuple[float, int, str, object]] = []
    ev_seq = 0
    for e in events:
        heapq.heappush(evq, (float(e.t), ev_seq, "resize", e))
        ev_seq += 1
    for e in fails:
        heapq.heappush(evq, (float(e.t), ev_seq, "fail", e))
        ev_seq += 1

    # Per-request recovery accounting — the end-of-run invariant's books.
    assigned_name: list[str | None] = [None] * N   # committed-to replica
    start_all = np.full(N, np.nan)                 # committed start times
    requeued_ct = np.zeros(N, dtype=np.int64)      # per-request re-queues
    commits_total = 0
    requeues_total = 0
    strag_factors: dict[str, list[float]] = {}     # active straggler windows
    masked: set[str] = set()                       # partition-unreachable
    lost_at: dict[str, float] = {}                 # replica_loss instants

    def _exec_column(rep):
        # Exec_TID columns are independent per replica, so a resize only
        # touches the added/removed columns — bitwise identical to a full
        # recompute, without the O(N·P) cost per event.
        if cost_registry is not None:
            return cost_registry.exec_tid_matrix(
                requests, [rep], active_params=active_params)
        return service_time_matrix(requests, [rep],
                                   active_params=active_params)

    def _apply(e):
        nonlocal ex_all
        for name in e.remove:
            i = next((j for j, r in enumerate(replicas) if r.name == name),
                     None)
            if i is None:
                raise ValueError(
                    f"resize event at t={e.t}: no replica named {name!r} "
                    f"in {[r.name for r in replicas]}")
            replicas.pop(i)
            free_at.pop(i)
            slot_free.pop(i)
            busy.pop(i)
            ex_all = np.delete(ex_all, i, axis=1)
        for rep in e.add:
            if cost_registry is not None:
                cost_registry.ensure_coverage(rep)
            replicas.append(rep)
            horizon = 0.0
            if topology is not None and topology.gateway is not None:
                pod = topology.pod_of.get(rep.name)
                if pod is not None:
                    # Topology-derived join: the joiner's params migrate
                    # gateway → pod over contended links, so its horizon
                    # opens at the transfer's finish instead of instantly.
                    _, horizon = topology.transfer_s(
                        migration_bytes(active_params), topology.gateway,
                        pod, at=t)
            free_at.append(horizon)
            slot_free.append([horizon] * max(int(rep.slots), 1))
            busy.append(0.0)
            lost_at.pop(rep.name, None)    # a re-used name is a new replica
            ex_all = np.concatenate([ex_all, _exec_column(rep)], axis=1)
            if (topology is not None
                    and not topology.replica_reachable(rep.name, at=t)):
                masked.add(rep.name)
                ex_all[:, len(replicas) - 1] = _INF
        if not replicas:
            raise ValueError(f"resize event at t={e.t} left the fleet empty")
        if tracer is not None:
            tracer.instant("serve.resize", ts_us=t * 1e6,
                           add=[r.name for r in e.add], remove=list(e.remove),
                           fleet=len(replicas))

    def _rep_index(name):
        return next((j for j, r in enumerate(replicas) if r.name == name),
                    None)

    def _refresh_column(i):
        # Recompose replica i's Exec_TID column from its live chaos state:
        # cost-model base × active straggler factors, +inf while
        # partition-masked.  Bit-exact restore once all windows close.
        rep = replicas[i]
        if rep.name in masked:
            ex_all[:, i] = _INF
            return
        col = _exec_column(rep)[:, 0]
        for fac in strag_factors.get(rep.name, ()):
            col = col * fac
        ex_all[:, i] = col

    def _remask(at):
        # Re-derive the partition mask from topology reachability at `at`
        # and refresh only the columns whose masked state flipped.
        for i, rep in enumerate(replicas):
            want = not topology.replica_reachable(rep.name, at=at)
            if want == (rep.name in masked):
                continue
            (masked.add if want else masked.discard)(rep.name)
            _refresh_column(i)

    def _requeue(rids, cause):
        nonlocal requeues_total
        for rid in rids:
            finish_all[rid] = np.nan
            start_all[rid] = np.nan
            assigned_name[rid] = None
            requeued_ct[rid] += 1
            requeues_total += 1
            ready.append(rid)
        if metrics is not None:
            metrics.counter("serve.retries", cause=cause).inc(len(rids))
        if tracer is not None:
            tracer.instant("serve.requeue", ts_us=t * 1e6, cause=cause,
                           requests=len(rids))

    def _lose_replica(e):
        nonlocal ex_all
        name, tl = e.target, float(e.t)
        lost_at[name] = tl
        # Everything unfinished at the loss instant — mid-decode included,
        # and regardless of whether the replica is still in the roster or
        # already draining — re-queues.  No budget check: never dropped.
        lost = [rid for rid, an in enumerate(assigned_name)
                if an == name and finish_all[rid] > tl]
        if lost:
            _requeue(lost, "replica_loss")
        strag_factors.pop(name, None)
        masked.discard(name)
        i = _rep_index(name)
        if i is not None:
            if len(replicas) == 1:
                raise ValueError(
                    f"replica_loss at t={tl} left the fleet empty")
            replicas.pop(i)
            free_at.pop(i)
            slot_free.pop(i)
            busy.pop(i)
            ex_all = np.delete(ex_all, i, axis=1)
        grown = getattr(controller, "grown", None)
        if grown is not None and name in grown:
            grown.remove(name)      # the controller must not re-shrink it

    def _start_straggler(e):
        # Window active [e.t, e.t + duration): exec column ×factor for new
        # commits; in-flight starts/finishes and the queue horizon stretch
        # around the pivot (work past e.t runs ×factor slower).
        heapq.heappush(evq, (float(e.t) + e.duration_s, _push_seq(),
                             "recover", e))
        i = _rep_index(e.target)
        if i is None:
            return                   # target already left the roster: no-op
        k, pivot, name = e.factor, float(e.t), e.target
        strag_factors.setdefault(name, []).append(k)
        _refresh_column(i)
        for rid, an in enumerate(assigned_name):
            if an != name or not finish_all[rid] > pivot:
                continue
            busy[i] += (k - 1.0) * (finish_all[rid]
                                    - max(start_all[rid], pivot))
            finish_all[rid] = pivot + k * (finish_all[rid] - pivot)
            if start_all[rid] > pivot:
                start_all[rid] = pivot + k * (start_all[rid] - pivot)
        slot_free[i] = [pivot + k * (c - pivot) if c > pivot else c
                        for c in slot_free[i]]
        free_at[i] = min(slot_free[i])

    def _apply_failure(e):
        if tracer is not None:
            tracer.instant("serve.failure", ts_us=t * 1e6, kind=e.kind,
                           target=e.target, reason=e.reason)
        if metrics is not None:
            metrics.counter("serve.failures", kind=e.kind).inc()
        if e.kind == "replica_loss":
            _lose_replica(e)
        elif e.kind == "straggler":
            _start_straggler(e)
        else:
            a, b = parse_link_target(e.target)
            heapq.heappush(evq, (float(e.t) + e.duration_s, _push_seq(),
                                 "recover", e))
            if e.kind == "link_degrade":
                topology.degrade(a, b, e.factor)
            else:
                topology.set_down(a, b, float(e.t) + e.duration_s)
                _remask(at=float(e.t))

    def _apply_recovery(e):
        if tracer is not None:
            tracer.instant("serve.recovery", ts_us=t * 1e6, kind=e.kind,
                           target=e.target)
        tr = float(e.t) + e.duration_s
        if e.kind == "link_degrade":
            topology.restore(*parse_link_target(e.target))
            return
        if e.kind == "link_partition":
            _remask(at=tr)
            return
        # Straggler window closes: un-stretch the portion past tr and
        # restore the exec column bit-exact from the cost model.
        name, k = e.target, e.factor
        facs = strag_factors.get(name)
        if not facs or k not in facs:
            return                   # replica was lost mid-window
        facs.remove(k)
        if not facs:
            strag_factors.pop(name, None)
        i = _rep_index(name)
        if i is None:
            return                   # drained out of the roster mid-window
        for rid, an in enumerate(assigned_name):
            if an != name or not finish_all[rid] > tr:
                continue
            busy[i] -= (1.0 - 1.0 / k) * (finish_all[rid]
                                          - max(start_all[rid], tr))
            finish_all[rid] = tr + (finish_all[rid] - tr) / k
            if start_all[rid] > tr:
                start_all[rid] = tr + (start_all[rid] - tr) / k
        slot_free[i] = [tr + (c - tr) / k if c > tr else c
                        for c in slot_free[i]]
        free_at[i] = min(slot_free[i])
        _refresh_column(i)

    def _push_seq():
        nonlocal ev_seq
        ev_seq += 1
        return ev_seq

    def _apply_event(kind, e):
        if kind == "resize":
            _apply(e)
        elif kind == "fail":
            _apply_failure(e)
        else:
            _apply_recovery(e)

    def _remap_stragglers(flagged):
        # Controller-flagged stragglers: re-queue their *not-yet-started*
        # work (a FIFO-chain suffix — starts are nondecreasing along the
        # chain) onto the healthy fleet, bounded per request by the retry
        # budget; in-flight decode keeps running.
        for name in flagged:
            i = _rep_index(name)
            if i is None:
                continue
            moved = [rid for rid, an in enumerate(assigned_name)
                     if an == name and start_all[rid] > t
                     and requeued_ct[rid] < retry_budget]
            if not moved:
                continue
            mset = set(moved)
            for rid in moved:
                busy[i] -= finish_all[rid] - start_all[rid]
            keep = [finish_all[rid] for rid, an in enumerate(assigned_name)
                    if an == name and rid not in mset]
            _requeue(moved, "straggler")
            if len(slot_free[i]) > 1:
                # A multi-slot chain suffix can't be re-attributed to its
                # chains after the fact — the commit pass doesn't record
                # which chain a request ran on.  Fail loudly rather than
                # silently corrupting the horizon.
                raise ValueError(
                    f"straggler remap is not supported for multi-slot "
                    f"replica {name!r} (slots={len(slot_free[i])})")
            free_at[i] = max(keep, default=0.0)
            slot_free[i] = [free_at[i]]

    # With a failure timeline, the loop stays alive past the last dispatch
    # while timeline/recovery events remain: a loss can strike *in-flight*
    # work after the final commit, and its re-queues re-enter dispatch.
    pending_chaos = bool(fails)
    while idx < N or ready or (pending_chaos and evq):
        t += tick
        # Runaway-clock guard — hoisted so every tick (including empty-ready
        # ticks and stalled backlogs) hits it before any scheduling work.
        if t > guard_end:
            break
        if not ready and idx < N:
            # Event horizon: no backlog, so fast-forward to the next
            # arrival's tick.  The clock still *accumulates* tick-by-tick
            # (bit-identical to the seed simulator's timeline) but the empty
            # ticks do no scheduling work.
            nxt = arr_sorted[idx]
            while t < nxt and t <= guard_end:
                t += tick
            if t > guard_end:
                break
        j = int(np.searchsorted(arr_sorted, t, side="right"))
        if j > idx:
            ready.extend(by_arrival[idx:j].tolist())
            idx = j
        if not ready:
            if idx >= N:
                # Dispatch is done; only the pending chaos timeline keeps
                # the loop alive.  Jump to the next event and apply it
                # against in-flight work — a loss's re-queues repopulate
                # the ready queue and dispatch resumes.
                if not evq:
                    break
                t = max(t, float(evq[0][0]))
                while evq and evq[0][0] <= t:
                    _, _, kind, e = heapq.heappop(evq)
                    _apply_event(kind, e)
            continue

        if dynamic:
            # Scripted timeline first, then the closed-loop controller.
            # Resizes/failures between mapping events apply lazily at the
            # next one — commits only happen here, so the timelines are
            # equivalent.
            while evq and evq[0][0] <= t:
                _, _, kind, e = heapq.heappop(evq)
                _apply_event(kind, e)
            if controller is not None:
                if p95_enabled:
                    # commits arrive in time order: prune the stale prefix
                    cut = 0
                    while (cut < len(done_lat)
                           and done_lat[cut][0] < t - p95_window_s):
                        cut += 1
                    if cut:
                        del done_lat[:cut]
                p95 = (float(np.percentile([l for _, l in done_lat], 95))
                       if p95_enabled and done_lat else 0.0)
                backlog = float(np.mean(np.maximum(
                    np.asarray(free_at) - t, 0.0)))
                ev = controller.observe(t, queue_depth=len(ready),
                                        backlog_s=backlog, p95_s=p95)
                if ev is not None:
                    _apply(ev)
                if hasattr(controller, "observe_stragglers"):
                    # Per-replica backlog rail → controller straggler
                    # detection (threshold × fleet median, per-replica
                    # backoff) → re-queue the flagged replicas' queued work.
                    flagged = controller.observe_stragglers(
                        t, [r.name for r in replicas],
                        [max(f - t, 0.0) for f in free_at])
                    if flagged:
                        _remap_stragglers(flagged)

        if tracer is not None:
            # Queue-depth timeline on the *simulated* clock: Perfetto renders
            # "C" counter samples as a step chart, so one sample per mapping
            # event reconstructs the full backlog curve.
            tracer.counter("serve.queue_depth", ts_us=t * 1e6,
                           depth=len(ready),
                           backlog_s=float(np.mean(np.maximum(
                               np.asarray(free_at) - t, 0.0))))
        if metrics is not None:
            metrics.counter("serve.mapping_events").inc()

        ex = ex_all[ready]
        assignment = policy(ex, np.maximum(free_at, t))
        a_list = np.asarray(assignment).tolist()

        # Commit pass: per-replica FIFO chains in ready order, the same
        # scalar left-fold (max(free_at, t) then += dur) as the seed's
        # sequential loop — bit-identical finish times, no per-request numpy.
        ex_rows = ex.tolist()
        committed = False
        leftovers: list[int] = []
        for k, p in enumerate(a_list):
            # Unassigned (-1) or infinite-exec picks (baseline policies
            # don't check supportability) stay in the backlog instead of
            # permanently poisoning a replica's horizon.
            if p < 0 or ex_rows[k][p] == _INF:
                leftovers.append(ready[k])
                continue
            committed = True
            commits_total += 1
            # Earliest-free slot chain takes the request (first index on
            # ties — deterministic); the availability register becomes the
            # min over chains.  At slots=1 this is exactly the original
            # f = free_at[p]; ...; free_at[p] = fin left-fold.
            chains = slot_free[p]
            j = chains.index(min(chains))
            f = chains[j]
            start = f if f > t else t            # arrivals are all <= t
            fin = start + ex_rows[k][p]
            chains[j] = fin
            free_at[p] = min(chains)
            busy[p] += ex_rows[k][p]
            finish_all[ready[k]] = fin
            start_all[ready[k]] = start
            assigned_name[ready[k]] = replicas[p].name
            if p95_enabled:
                done_lat.append((t, fin - arrivals[ready[k]]))
        if metrics is not None:
            n_committed = len(a_list) - len(leftovers)
            if n_committed:
                metrics.counter("serve.committed").inc(n_committed)
        ready = leftovers

        if not committed:
            # Nothing schedulable this event.  With no arrivals left the
            # backlog can never drain by itself — but a pending scripted
            # resize (or a failure-window recovery unmasking the fleet) may
            # still make it schedulable, so jump to the next event's time
            # instead of giving up; with nothing pending, fast-forward into
            # the guard.  (With arrivals pending the next tick re-maps as
            # usual.)
            if idx >= N:
                if evq:
                    t = max(t, float(evq[0][0]))
                else:
                    t = guard_end
            continue

    served = np.isfinite(finish_all)
    offered = N / (arrivals.max() + 1e-9)

    # Recovery invariant — the "provable" in provable recovery.  Every
    # commit either ends served or was re-queued (so served + requeued +
    # unserved partition the request set exactly), no unserved request
    # still holds an assignment, and no served request outlived its
    # replica's loss instant.  A silently dropped request is a crash here,
    # not a statistic.
    n_served = int(served.sum())
    if commits_total - requeues_total != n_served:
        raise AssertionError(
            f"recovery invariant violated: {commits_total} commits - "
            f"{requeues_total} requeues != {n_served} served")
    orphans = [rid for rid in np.nonzero(~served)[0].tolist()
               if assigned_name[rid] is not None]
    if orphans:
        raise AssertionError(
            f"recovery invariant violated: unserved requests still hold "
            f"assignments: {orphans[:8]}")
    ghosts = [rid for rid in np.nonzero(served)[0].tolist()
              if assigned_name[rid] in lost_at
              and finish_all[rid] > lost_at[assigned_name[rid]]]
    if ghosts:
        raise AssertionError(
            f"recovery invariant violated: served requests outlive their "
            f"replica's loss: {ghosts[:8]}")

    def _final_metrics(util):
        if metrics is None:
            return
        metrics.counter("serve.served").inc(n_served)
        metrics.counter("serve.unserved").inc(N - n_served)
        for rep, u in zip(replicas, util):
            u = float(u)
            metrics.gauge("serve.replica_util", replica=rep.name).set(u)
            metrics.gauge("serve.replica_idle", replica=rep.name).set(1.0 - u)

    if not served.any():
        # Nothing ever scheduled (e.g. an all-+inf exec_matrix): report an
        # empty, well-defined result instead of NaN-percentile crashes.
        _final_metrics(np.zeros(len(replicas)))
        return ServeResult(offered_rps=offered, achieved_rps=0.0,
                           p50_latency=np.nan, p99_latency=np.nan,
                           mean_latency=np.nan,
                           replica_util=np.zeros(len(replicas)),
                           served_mask=served, requeued=requeued_ct,
                           finish_times=finish_all,
                           final_avail=np.asarray(free_at, dtype=float))
    lat = finish_all[served] - arrivals[served]
    span = np.nanmax(finish_all) - arrivals.min()
    _final_metrics(np.array(busy) / span)
    return ServeResult(
        offered_rps=offered,
        achieved_rps=n_served / span,
        p50_latency=float(np.percentile(lat, 50)),
        p99_latency=float(np.percentile(lat, 99)),
        mean_latency=float(lat.mean()),
        replica_util=np.array(busy) / span,
        served_mask=served,
        requeued=requeued_ct,
        finish_times=finish_all,
        final_avail=np.asarray(free_at, dtype=float),
    )


def goodput(result: ServeResult, requests: list[Request],
            slo_s: float) -> int:
    """Requests served within their SLO deadline (``arrival + slo_s``).

    The chaos tier's acceptance metric: a re-queued request that still
    lands inside its deadline counts; one pushed past it (or never served)
    does not — so goodput under a failure trace measures recovery quality,
    not just liveness.
    """
    arr = np.array([r.arrival for r in requests])
    lat = result.finish_times - arr
    with np.errstate(invalid="ignore"):          # NaN finish = not served
        return int(np.sum(result.served_mask & (lat <= slo_s)))


def default_fleet() -> list[Replica]:
    """A heterogeneous fleet: two v5e pods, one older-gen pod, one small pod.

    Effective rates assume ~50% MFU prefill / ~60% of HBM streaming decode
    (per-chip 197 TF, 819 GB/s scaled by pod size).
    """
    return [
        Replica("v5e-256", 256 * 197e0 * 0.5, 256 * 819 * 0.6),
        Replica("v5e-256b", 256 * 197e0 * 0.5, 256 * 819 * 0.6),
        Replica("v4-128", 128 * 275e0 * 0.4, 128 * 1200 * 0.5),
        Replica("v5e-64", 64 * 197e0 * 0.5, 64 * 819 * 0.6),
    ]


def mesh_fleet(arch: str = "deepseek-7b",
               mesh_shapes=((16, 16), (16, 16), (4, 16), (4, 4)),
               *, chip_tflops: float = 197.0, chip_hbm_gbps: float = 819.0,
               ici_gbps: float = 0.0, slots: int = 1,
               mfu: float = 0.5, hbm_eff: float = 0.6) -> list[Replica]:
    """A heterogeneous *mesh-backed* fleet: same-generation chips carved into
    mixed mesh slices (the serving analogue of the paper's non-uniform PEs).
    Aggregate rates scale with slice size; ``arch`` + each slice shape key
    the replicas into the cost-model registry.  ``slots`` gives every
    replica that many concurrent batch slots (continuous batching twin).
    """
    import math

    fleet = []
    for i, shape in enumerate(mesh_shapes):
        shape = tuple(int(d) for d in shape)
        n = math.prod(shape)
        fleet.append(Replica(
            f"{arch}@{'x'.join(map(str, shape))}#{i}",
            n * chip_tflops * mfu, n * chip_hbm_gbps * hbm_eff,
            arch=arch, mesh_shape=shape, ici_gbps=ici_gbps, slots=slots))
    return fleet

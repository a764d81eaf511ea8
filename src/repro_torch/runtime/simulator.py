"""Discrete-event simulator of the CEDR runtime on a heterogeneous SoC.

Mirrors the paper's runtime environment (Section III-A): applications arrive
dynamically as DAG instances; the CEDR *management thread* (a single daemon
loop) parses incoming DAGs, performs task-completion bookkeeping, maintains
the ready queue, and — at each *mapping event* — invokes the scheduler over
the whole ready queue together with per-PE availability estimates.

Two modeling choices carry the paper's dynamics:

1. **The management thread is serial.** DAG parsing, dependency bookkeeping
   and scheduling compete for one loop.  Expensive mapping events delay
   everything behind them.

2. **Tasks stay in the ready queue until they begin execution.**  Every
   mapping event re-maps the *entire* backlog (this is what makes dynamic
   scheduling responsive — late-arriving high-priority tasks can jump ahead —
   and it is why the paper observes ready queues up to 1330 entries).  A PE
   that falls idle can only receive work at a mapping-event boundary, so the
   mapping-event latency directly gates PE utilization: with the software
   scheduler at large n this is milliseconds per event and throughput
   collapses; the hardware scheduler keeps events cheap.  This is the 26.7%
   achieved-frame-rate mechanism of Fig. 6.

PyTorch port: the simulator is host code copied from ``repro.runtime.
simulator``; its mapping events reach the card through
:func:`make_dispatch_fabric` (the port's :class:`MappingFabric`).

The scheduler decision function is pluggable (HEFT_RT, round-robin,
earliest-idle-PE, random) and its overhead is modeled separately
(:mod:`repro_torch.runtime.overhead`).  The dispatch fast path uses an early-exit
EFT loop that is prefix-identical to the full HEFT_RT assignment (it stops
once every idle PE has been claimed — later iterations cannot dispatch), so
simulated decisions are bit-identical to ``heft_rt_numpy`` / the CUDA
kernels while keeping multi-thousand-event sweeps fast.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass

import numpy as np

from repro_torch.core.heft_rt import heft_rt_numpy  # noqa: F401 — re-exported oracle
from repro_torch.runtime.apps import AppDAG, get_app
from repro_torch.runtime.overhead import OverheadModel, ZERO_MODEL
from repro_torch.sched_integration.fabric import MappingFabric, eft_dispatch_numpy

# event kinds
ARRIVAL, TASK_DONE, MGMT_DONE = 0, 1, 2

# management-thread costs (seconds) — CEDR bookkeeping on the A53
PARSE_COST_PER_TASK_S = 2.0e-6    # DAG parse/instantiate, per task
COMPLETION_COST_S = 8.0e-6        # per-completion dependency bookkeeping


# ---------------------------------------------------------------------------
# Dispatch policies.  Signature:
#   dispatch(avg[n], exec[n,P], avail[P], idle[P] bool) -> list[(i, pe)]
# returning ready-queue positions to start NOW on which idle PE.  Each idle PE
# may receive at most one task (it is busy afterwards).
# ---------------------------------------------------------------------------

def dispatch_heft_rt(avg, exec_times, avail, capacity):
    """Early-exit HEFT_RT: follow priority order + EFT chain, commit tasks to
    PEs with free worker-queue capacity, stop once no capacity remains.

    Identical to running the full ``heft_rt_numpy`` and committing, for each
    PE, the first ``capacity[pe]`` tasks assigned to it: the EFT availability
    chain is computed exactly as in the full algorithm, so committed
    decisions are bit-identical to the full scheduler / CUDA kernels.

    Implemented by the mapping fabric's host fast path
    (:func:`repro_torch.sched_integration.fabric.eft_dispatch_numpy`); use
    :func:`make_dispatch_fabric` to route mapping events through the
    fabric's device backends instead.
    """
    return eft_dispatch_numpy(avg, exec_times, avail, capacity)


def make_dispatch_fabric(backend: str = "auto", **fabric_kw):
    """Dispatch factory routing mapping events through a
    :class:`~repro_torch.sched_integration.fabric.MappingFabric` backend
    (``"numpy"``, ``"torch"``, ``"cuda"`` or ``"fused"``); ``fabric_kw``
    goes to the fabric (``device="cpu"`` runs the plain CPU path).

    Fidelity caveat: the ``"numpy"`` backend is bit-identical to
    :func:`dispatch_heft_rt` for any float64 inputs; the device backends
    compute in float32, so their decisions match the oracle only when
    exec/avail values are exactly representable in f32 (EFT gaps below f32
    resolution can resolve differently).  Compare a device backend's run
    with another float32 run (the kernels' plain versions), not with
    ``backend="numpy"``."""
    fab: MappingFabric | None = None

    def dispatch(avg, exec_times, avail, capacity):
        nonlocal fab
        P = exec_times.shape[1]
        if fab is None:
            fab = MappingFabric(P, backend=backend, **fabric_kw)
        elif fab.num_pes != P:
            # elastic PE pool: resize in place (avail is explicit here, so
            # only the compiled-dispatch cache is worth preserving)
            fab.resize(P)
        return fab.dispatch(avg, exec_times, avail, capacity)

    return dispatch


def make_dispatch_round_robin():
    counter = itertools.count()

    def dispatch(avg, exec_times, avail, capacity):
        n, P = exec_times.shape
        out = []
        cap = capacity.copy()
        for i in range(n):
            if cap.sum() == 0:
                break
            for _ in range(P):
                pe = next(counter) % P
                if cap[pe] > 0 and np.isfinite(exec_times[i, pe]):
                    out.append((i, pe))
                    cap[pe] -= 1
                    break
        return out

    return dispatch


def dispatch_earliest_idle(avg, exec_times, avail, capacity):
    """FIFO ready queue onto free PEs, fastest-available first (no sort, no
    heterogeneity-aware EFT chain) — a baseline 'naive dynamic' scheduler."""
    out = []
    cap = capacity.copy()
    for i in range(exec_times.shape[0]):
        if cap.sum() == 0:
            break
        free = cap > 0
        cand = np.where(free & np.isfinite(exec_times[i]), exec_times[i], np.inf)
        pe = int(np.argmin(cand))
        if np.isfinite(cand[pe]):
            out.append((i, pe))
            cap[pe] -= 1
    return out


def make_dispatch_random(seed: int = 0):
    rng = np.random.default_rng(seed)

    def dispatch(avg, exec_times, avail, capacity):
        out = []
        cap = capacity.copy()
        for i in range(exec_times.shape[0]):
            if cap.sum() == 0:
                break
            sup = np.flatnonzero((cap > 0) & np.isfinite(exec_times[i]))
            if sup.size:
                pe = int(rng.choice(sup))
                out.append((i, pe))
                cap[pe] -= 1
        return out

    return dispatch


DISPATCHERS = {
    "heft_rt": lambda: dispatch_heft_rt,
    "heft_rt_fabric": make_dispatch_fabric,
    "round_robin": make_dispatch_round_robin,
    "earliest_idle": lambda: dispatch_earliest_idle,
    "random": make_dispatch_random,
}

# Backwards-compatible aliases used by tests/benchmarks.
DECIDERS = DISPATCHERS


@dataclass
class AppInstance:
    inst_id: int
    dag: AppDAG
    arrival: float
    exec_matrix: np.ndarray            # (T, P) seconds
    remaining_deps: np.ndarray         # (T,) int
    succ: dict[int, list[int]]
    first_start: float = np.inf
    last_finish: float = -np.inf
    cumulative_exec: float = 0.0
    tasks_done: int = 0

    @property
    def complete(self) -> bool:
        return self.tasks_done == self.dag.num_tasks


@dataclass
class SimResult:
    num_apps: int
    completed_apps: int
    app_exec_times: list[float]          # last-task-end − first-task-start
    app_latencies: list[float]           # completion − arrival
    cumulative_exec_times: list[float]   # Σ task exec on assigned PEs
    mapping_events: list[tuple[float, int, float]]  # (time, queue size, overhead)
    makespan: float
    first_arrival: float
    last_completion: float
    pe_busy_time: np.ndarray             # (P,) seconds of actual execution

    @property
    def achieved_frame_rate(self) -> float:
        span = self.last_completion - self.first_arrival
        return self.completed_apps / span if span > 0 else 0.0

    @property
    def avg_app_exec_time(self) -> float:
        return float(np.mean(self.app_exec_times)) if self.app_exec_times else np.nan

    @property
    def avg_cumulative_exec_time(self) -> float:
        return float(np.mean(self.cumulative_exec_times)) if self.cumulative_exec_times else np.nan

    @property
    def total_scheduling_overhead(self) -> float:
        return float(sum(o for _, _, o in self.mapping_events))

    @property
    def avg_queue_size(self) -> float:
        return float(np.mean([n for _, n, _ in self.mapping_events]))

    @property
    def max_queue_size(self) -> int:
        return max((n for _, n, _ in self.mapping_events), default=0)

    def pe_utilization(self) -> np.ndarray:
        span = max(self.makespan - self.first_arrival, 1e-12)
        return self.pe_busy_time / span


class CedrSimulator:
    """Event-driven model of CEDR's daemon (management thread) + workers."""

    def __init__(
        self,
        pe_types: list[str],
        dispatch=dispatch_heft_rt,
        overhead: OverheadModel = ZERO_MODEL,
        exec_noise: float | None = 0.03,
        seed: int = 0,
        worker_queue_depth: int = 1,
    ):
        self.pe_types = pe_types
        self.P = len(pe_types)
        self.dispatch = dispatch
        self.overhead = overhead
        self.rng = np.random.default_rng(seed)
        self.exec_noise = exec_noise
        # committed-but-unfinished tasks a worker may hold (running + queued).
        # Small in CEDR: workers pull from short to-do queues; everything not
        # yet committed stays in the ready queue and is re-mapped each event.
        self.worker_queue_depth = worker_queue_depth

    def run(self, arrivals: list[tuple[float, str]]) -> SimResult:
        P = self.P
        heap: list[tuple[float, int, int, object]] = []
        seq = itertools.count()

        def push(t, kind, payload=None):
            heapq.heappush(heap, (t, next(seq), kind, payload))

        for t, name in arrivals:
            push(t, ARRIVAL, name)

        instances: dict[int, AppInstance] = {}
        inst_counter = itertools.count()
        ready: list[tuple[int, int]] = []          # backlog until COMMITTED
        mgmt_queue: list[tuple[str, object]] = []  # serialized daemon work
        mgmt_busy = False
        dirty = False                              # re-map warranted?
        pe_running: list[tuple[int, int] | None] = [None] * P
        pe_fifo: list[list[tuple[int, int]]] = [[] for _ in range(P)]
        pe_busy_until = np.zeros(P)          # availability estimate (incl. FIFO)
        pe_busy_until_running = np.zeros(P)  # end time of the running task
        pe_busy_time = np.zeros(P)
        mapping_log: list[tuple[float, int, float]] = []
        depth = self.worker_queue_depth
        now = 0.0

        def start_task(iid: int, ti: int, pe: int, t: float) -> None:
            inst = instances[iid]
            dur = inst.exec_matrix[ti, pe]
            pe_running[pe] = (iid, ti)
            inst.first_start = min(inst.first_start, t)
            inst.cumulative_exec += dur
            pe_busy_time[pe] += dur
            push(t + dur, TASK_DONE, (iid, ti, pe))

        def refresh_estimate(pe: int, t: float) -> None:
            """T_avail estimate: running task's end + queued FIFO durations."""
            est = t
            run = pe_running[pe]
            if run is not None:
                est = max(est, pe_busy_until_running[pe])
            for iid, ti in pe_fifo[pe]:
                est += instances[iid].exec_matrix[ti, pe]
            pe_busy_until[pe] = est

        def commit_task(iid: int, ti: int, pe: int, t: float) -> None:
            """Worker-queue commit: start now if idle, else join the short FIFO."""
            if pe_running[pe] is None:
                start_task(iid, ti, pe, t)
                pe_busy_until_running[pe] = t + instances[iid].exec_matrix[ti, pe]
            else:
                pe_fifo[pe].append((iid, ti))
            refresh_estimate(pe, t)

        def mgmt_kick(t: float) -> None:
            nonlocal mgmt_busy, dirty
            if mgmt_busy:
                return
            if mgmt_queue:
                kind, payload = mgmt_queue.pop(0)
                if kind == "arrival":
                    dur = PARSE_COST_PER_TASK_S * get_app(payload).num_tasks
                else:  # completion
                    dur = COMPLETION_COST_S
                mgmt_busy = True
                push(t + dur, MGMT_DONE, (kind, payload))
            elif ready and dirty:
                # mapping event: the scheduler sees the whole ready queue
                n = len(ready)
                ex = np.stack([instances[i].exec_matrix[ti] for i, ti in ready])
                with np.errstate(invalid="ignore"):
                    avg = np.nanmean(np.where(np.isfinite(ex), ex, np.nan), axis=1)
                ov = self.overhead(n, avg, ex,
                                   np.maximum(pe_busy_until, t))
                mapping_log.append((t, n, ov))
                mgmt_busy = True
                dirty = False
                push(t + ov, MGMT_DONE, ("mapping", (avg, ex)))

        while heap:
            now, _, kind, payload = heapq.heappop(heap)

            if kind == ARRIVAL:
                mgmt_queue.append(("arrival", payload))
                mgmt_kick(now)

            elif kind == TASK_DONE:
                iid, ti, pe = payload
                inst = instances[iid]
                inst.tasks_done += 1
                inst.last_finish = max(inst.last_finish, now)
                pe_running[pe] = None
                if pe_fifo[pe]:  # workers drain their own short queue
                    niid, nti = pe_fifo[pe].pop(0)
                    start_task(niid, nti, pe, now)
                    pe_busy_until_running[pe] = now + instances[niid].exec_matrix[nti, pe]
                refresh_estimate(pe, now)
                dirty = True          # freed worker capacity warrants a re-map
                mgmt_queue.append(("completion", (iid, ti)))
                mgmt_kick(now)

            elif kind == MGMT_DONE:
                wkind, wpayload = payload
                mgmt_busy = False
                if wkind == "arrival":
                    dag = get_app(wpayload)
                    iid = next(inst_counter)
                    noise = self.rng if self.exec_noise else None
                    ex_ms = dag.exec_matrix(self.pe_types, noise=noise)
                    inst = AppInstance(
                        inst_id=iid, dag=dag, arrival=now,
                        exec_matrix=ex_ms * 1e-3,  # ms → seconds
                        remaining_deps=np.array([len(t.deps) for t in dag.tasks]),
                        succ=dag.successors(),
                    )
                    instances[iid] = inst
                    for ti in np.flatnonzero(inst.remaining_deps == 0):
                        ready.append((iid, int(ti)))
                        dirty = True
                elif wkind == "completion":
                    iid, ti = wpayload
                    inst = instances[iid]
                    for s in inst.succ[ti]:
                        inst.remaining_deps[s] -= 1
                        if inst.remaining_deps[s] == 0:
                            ready.append((iid, s))
                            dirty = True
                elif wkind == "mapping":
                    avg, ex = wpayload
                    # the queue may have grown since the snapshot; map the
                    # snapshot prefix (positions align: ready is append-only
                    # between snapshot and now)
                    n = ex.shape[0]
                    capacity = np.array([
                        depth - len(pe_fifo[p]) - (pe_running[p] is not None)
                        for p in range(P)
                    ], dtype=np.int64).clip(min=0)
                    avail = np.maximum(pe_busy_until, now)
                    committed = self.dispatch(avg, ex, avail, capacity)
                    for i, pe in sorted(committed, reverse=True):
                        iid, ti = ready[i]
                        commit_task(iid, ti, pe, now)
                        del ready[i]
                    if len(ready) > n - len(committed):
                        dirty = True  # new tasks appeared during mapping
                    if committed:
                        dirty = True  # chain: capacity may remain elsewhere
                mgmt_kick(now)

        completed = [i for i in instances.values() if i.complete]
        return SimResult(
            num_apps=len(instances),
            completed_apps=len(completed),
            app_exec_times=[i.last_finish - i.first_start for i in completed],
            app_latencies=[i.last_finish - i.arrival for i in completed],
            cumulative_exec_times=[i.cumulative_exec for i in completed],
            mapping_events=mapping_log,
            makespan=now,
            first_arrival=min((i.arrival for i in instances.values()), default=0.0),
            last_completion=max((i.last_finish for i in completed), default=0.0),
            pe_busy_time=pe_busy_time,
        )

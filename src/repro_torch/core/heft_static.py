"""Classic (static) HEFT — Topcuoglu & Hariri 2002 — the paper's reference [3].

The paper contrasts HEFT_RT against classic HEFT: classic HEFT requires the
*full application DAG* up front (upward ranks need successor knowledge) and can
only schedule one application at a time — which is exactly why Aliyev et al.
[10]'s hardware HEFT is "not suitable for runtime execution" (Section II) and
why HEFT_RT exists.  We implement classic HEFT as the quality baseline: the
runtime benchmarks compare HEFT_RT's dynamically-built schedules against the
static HEFT schedule computed with perfect knowledge (an upper bound on
schedule quality for a single DAG).

Implementation is plain numpy — it is a baseline/oracle, not a hot path
(the PyTorch port's copy of ``repro.core.heft_static``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DAG:
    """Task DAG with per-PE computation costs and edge communication costs."""

    num_tasks: int
    comp: np.ndarray                    # (T, P) computation cost; inf if unsupported
    succ: dict[int, list[tuple[int, float]]] = field(default_factory=dict)
    # succ[t] = [(child, comm_cost), ...]

    def predecessors(self) -> dict[int, list[tuple[int, float]]]:
        pred: dict[int, list[tuple[int, float]]] = {t: [] for t in range(self.num_tasks)}
        for t, children in self.succ.items():
            for c, w in children:
                pred[c].append((t, w))
        return pred


def upward_rank(dag: DAG) -> np.ndarray:
    """rank_u(t) = mean_p comp[t,p] + max_{c in succ(t)} (comm(t,c) + rank_u(c))."""
    comp_mean = np.where(np.isfinite(dag.comp), dag.comp, np.nan)
    wbar = np.nanmean(comp_mean, axis=1)
    rank = np.zeros(dag.num_tasks)
    # reverse topological order via DFS
    visited = np.zeros(dag.num_tasks, dtype=bool)
    order: list[int] = []

    def dfs(t: int) -> None:
        visited[t] = True
        for c, _ in dag.succ.get(t, []):
            if not visited[c]:
                dfs(c)
        order.append(t)

    for t in range(dag.num_tasks):
        if not visited[t]:
            dfs(t)
    for t in order:  # children already finalized
        best = 0.0
        for c, w in dag.succ.get(t, []):
            best = max(best, w + rank[c])
        rank[t] = wbar[t] + best
    return rank


@dataclass
class StaticSchedule:
    assignment: np.ndarray   # (T,) PE per task
    start: np.ndarray        # (T,)
    finish: np.ndarray       # (T,)

    @property
    def makespan(self) -> float:
        return float(np.max(self.finish))


def heft_static(dag: DAG, num_pes: int, insertion: bool = True) -> StaticSchedule:
    """Full classic HEFT: rank-order tasks, insertion-based EFT placement."""
    ranks = upward_rank(dag)
    order = np.argsort(-ranks, kind="stable")
    pred = dag.predecessors()

    # per-PE list of (start, finish) occupied slots, kept sorted
    slots: list[list[tuple[float, float]]] = [[] for _ in range(num_pes)]
    assignment = np.full(dag.num_tasks, -1, dtype=np.int64)
    start = np.full(dag.num_tasks, np.inf)
    finish = np.full(dag.num_tasks, np.inf)

    for t in order:
        best_pe, best_start, best_finish = -1, np.inf, np.inf
        for p in range(num_pes):
            cost = dag.comp[t, p]
            if not np.isfinite(cost):
                continue
            # data-ready time: all predecessors finished (+ comm if cross-PE)
            ready = 0.0
            for u, w in pred[t]:
                comm = 0.0 if assignment[u] == p else w
                ready = max(ready, finish[u] + comm)
            st = _earliest_slot(slots[p], ready, cost) if insertion else \
                max(ready, slots[p][-1][1] if slots[p] else 0.0)
            ft = st + cost
            if ft < best_finish:
                best_pe, best_start, best_finish = p, st, ft
        assignment[t] = best_pe
        start[t] = best_start
        finish[t] = best_finish
        _insert_slot(slots[best_pe], (best_start, best_finish))

    return StaticSchedule(assignment, start, finish)


def _earliest_slot(busy: list[tuple[float, float]], ready: float, dur: float) -> float:
    """Insertion-based policy: earliest gap ≥ dur starting at or after ready."""
    t = ready
    for s, f in busy:
        if t + dur <= s:
            return t
        t = max(t, f)
    return t


def _insert_slot(busy: list[tuple[float, float]], slot: tuple[float, float]) -> None:
    busy.append(slot)
    busy.sort()

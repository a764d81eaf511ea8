"""HEFT_RT, the paper's runtime mapping event, in plain NumPy float32.

At a mapping event the ready queue (per request its average execution time
and its time on each replica) and the replicas' availability registers
``T_avail`` give the decision: the queue sorted by descending average (a
stable sort, so equal averages keep their queue order), then each request
in that order to the replica with the earliest finish ``T_avail + exec``
(the lowest index among equal finishes), that replica's register becoming
the finish.  Registers and times are float32, as the scheduler's hardware
registers are.

The serving front end estimates a request's time on a replica from its
size alone: ``(1e-4 * prompt_tokens + 2e-3 * new_tokens) / speed`` seconds
(the launcher's modelled rates), and averages over the replicas.
"""

from __future__ import annotations

import numpy as np


def exec_estimates(prompt_lens, new_tokens, speeds) -> np.ndarray:
    """(n, P) float64 seconds of each request on each replica."""
    base = (1e-4 * np.asarray(prompt_lens, dtype=np.float64)
            + 2e-3 * np.asarray(new_tokens, dtype=np.float64))
    return base[:, None] / np.asarray(speeds, dtype=np.float64)[None, :]


def mapping_event(ex: np.ndarray, avail: np.ndarray):
    """One event over float64 estimates ``ex`` (n, P) and float32 registers
    ``avail`` (P,).  Returns ``(order, assignment, start, finish,
    new_avail)``: the queue positions in priority order, and per position
    the replica, start and finish (float32), then the new registers."""
    avg = ex.mean(axis=1).astype(np.float32)
    ex32 = ex.astype(np.float32)
    order = np.argsort(-avg, kind="stable").astype(np.int32)
    av = np.asarray(avail, dtype=np.float32).copy()
    n = len(order)
    assignment = np.empty(n, dtype=np.int32)
    start = np.empty(n, dtype=np.float32)
    finish = np.empty(n, dtype=np.float32)
    for i, q in enumerate(order):
        fin = av + ex32[q]
        p = int(np.argmin(fin))
        assignment[i], start[i], finish[i] = p, av[p], fin[p]
        av[p] = fin[p]
    return order, assignment, start, finish, av

"""Energy-aware HEFT_RT — the paper's stated future work (Section VII).

"As future work, we will explore acceleration of energy-aware scheduling
heuristics in order to expand our evaluations beyond focusing purely on
optimization of execution time."

This module implements the natural extension compatible with the hardware
datapath: the PE handlers additionally hold per-PE power coefficients, and
the selector minimizes

    cost[PE_i] = T_finish[PE_i] + λ · E(task, PE_i)
    E(task, PE_i) = Exec_TID[PE_i] · power[PE_i]

λ = 0 recovers exact HEFT_RT (tested); λ → ∞ approaches min-energy greedy.
Hardware cost: one extra multiplier + adder per PE handler and a wider
comparator tree — the resource model extension is a second W-bit multiplier
per handler (+≈6.3 LUTs/bit) with no change to the 3n+3 cycle count, since
the energy term folds into the same single-cycle select.

The Pareto sweep (`energy_pareto`) reproduces the classic energy/makespan
trade-off curve on the paper's SoC, where the FFT accelerator is both faster
AND lower-energy for FFTs, while for ARM-only tasks the trade-off is real.

Plain numpy: the PyTorch port's copy of ``repro.core.heft_energy``.
"""

from __future__ import annotations

import numpy as np


def heft_rt_energy_numpy(avg, exec_times, avail, power, lam: float = 0.0):
    """Energy-aware mapping event.

    power: (P,) relative power draw of each PE (W, arbitrary units).
    Returns (order, assignment, start, finish, new_avail, energy).
    """
    avg = np.asarray(avg, dtype=np.float64)
    exec_times = np.asarray(exec_times, dtype=np.float64)
    avail = np.array(avail, dtype=np.float64)
    power = np.asarray(power, dtype=np.float64)
    n = avg.shape[0]
    order = np.argsort(-avg, kind="stable")
    assignment = np.full(n, -1, dtype=np.int64)
    start = np.full(n, np.inf)
    finish = np.full(n, np.inf)
    energy = 0.0
    for i, t in enumerate(order):
        fin = avail + exec_times[t]
        cost = fin + lam * exec_times[t] * power
        pe = int(np.argmin(cost))
        if np.isfinite(fin[pe]):
            assignment[i] = pe
            start[i] = avail[pe]
            finish[i] = fin[pe]
            avail[pe] = fin[pe]
            energy += exec_times[t, pe] * power[pe]
    return order, assignment, start, finish, avail, energy


def energy_pareto(avg, exec_times, power, lams=(0.0, 0.25, 0.5, 1.0, 2.0, 8.0)):
    """Sweep λ → [(lam, makespan, energy)] — the energy/latency frontier."""
    P = exec_times.shape[1]
    out = []
    for lam in lams:
        _, _, _, _, new_avail, energy = heft_rt_energy_numpy(
            avg, exec_times, np.zeros(P), power, lam)
        out.append((lam, float(np.max(new_avail)), float(energy)))
    return out

"""Scheduling-overhead models for the software and hardware HEFT_RT paths.

The paper's measured behaviour (Section VI, Fig. 4) on the ZCU102:

  * software HEFT_RT on the A53 management core: O(n log n) growth,
  * hardware HEFT_RT: (3n+3) cycles at the 3.048 ns critical path, PLUS the
    AXI/DMA transfer of the ready queue into the overlay — which dominates and
    produces a *crossover at ready-queue size ≈ 5* below which software wins,
  * headline ratios at n = 1330: hardware is 183× faster on scheduling
    computation alone, 2.6× faster end-to-end including transfer.

The constants below are calibrated so the model reproduces those three
published anchors exactly (crossover n=5, 183×, 2.6× — see
``tests/test_runtime.py`` and ``benchmarks/bench_latency_vs_queue.py``).
The slightly super-linear transfer exponent models per-word uncached AXI
writes with increasing bus contention at long bursts, which the paper points
to as its outlier source ("data transfer overhead on the Zynq ZCU102").

A third, *measured* model wraps our actual software scheduler
(`heft_rt_numpy`) with a wall clock, for honest on-this-host numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.heft_rt import heft_rt_numpy
from repro_torch.core.queue_model import worst_case_cycles
from repro_torch.core.resource_model import PAPER_CRITICAL_PATH_NS
from repro_torch.obs.metrics import time_s

# software HEFT_RT on the A53 (seconds)
SW_BASE_S = 1.8e-6           # runtime entry/exit, queue marshalling
SW_PER_NLOGN_S = 0.161e-6    # sort + EFT loop per n·log2(n)

# hardware HEFT_RT (seconds)
HW_XFER_BASE_S = 1.79e-6     # DMA descriptor setup + doorbell + drain sync
HW_XFER_PER_TASK_S = 0.31e-6  # per-task AXI-S payload (Avg + Exec[P] words)
HW_XFER_EXPONENT = 1.1       # mild superlinearity: bus contention at long bursts
HW_CLOCK_S = PAPER_CRITICAL_PATH_NS * 1e-9  # D=512/P=4 design point


def sw_overhead_s(n: int) -> float:
    """Modeled software scheduling overhead for a ready queue of size n."""
    if n <= 0:
        return 0.0
    return SW_BASE_S + SW_PER_NLOGN_S * n * np.log2(max(n, 2))


def hw_compute_s(n: int) -> float:
    """Hardware scheduling time excluding transfer: (3n+3) × T_clk."""
    if n <= 0:
        return 0.0
    return worst_case_cycles(n) * HW_CLOCK_S


def hw_transfer_s(n: int) -> float:
    if n <= 0:
        return 0.0
    return HW_XFER_BASE_S + HW_XFER_PER_TASK_S * float(n) ** HW_XFER_EXPONENT


def hw_overhead_s(n: int) -> float:
    """End-to-end hardware scheduling overhead (transfer + compute)."""
    return hw_transfer_s(n) + hw_compute_s(n)


@dataclass
class OverheadModel:
    """Maps ready-queue size → scheduling overhead in seconds."""

    kind: str  # 'sw' | 'hw' | 'measured' | 'none'

    def __call__(self, n: int, avg=None, exec_times=None, avail=None) -> float:
        if self.kind == "sw":
            return sw_overhead_s(n)
        if self.kind == "hw":
            return hw_overhead_s(n)
        if self.kind == "none":
            return 0.0
        if self.kind == "measured":
            _, dt = time_s(heft_rt_numpy, avg, exec_times, avail)
            return dt
        raise ValueError(self.kind)


SW_MODEL = OverheadModel("sw")
HW_MODEL = OverheadModel("hw")
ZERO_MODEL = OverheadModel("none")

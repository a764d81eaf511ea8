"""Analytical FPGA resource & timing model for the hardware HEFT_RT scheduler.

Reproduces the scaling behaviour of Tables II, III and IV of the paper on the
Zynq ZCU102.  The paper's own analysis (Section VI-A) says:

  * Priority-queue LUTs/registers scale linearly with depth D and with the
    key bit-width W (each cell holds W(Avg) + W(QID) bits plus compare/swap
    muxes); W(QID) = ceil(log2 D).
  * LUT-RAM scales with P·D·W_exec (stores Exec[QID][PE_i]); past a size
    threshold the tools map it to BRAM instead (the P=16, D=512 row).
  * Path delay is INDEPENDENT of D (neighbour-only exchanges) and grows
    with P through the EFT-selector comparator tree (log2 P levels) plus
    wiring/mux fan-in effects.

The constants below are least-squares / exact fits to the paper's tables; the
benchmarks print model-vs-paper side by side so the fit quality is visible.
ZCU102 capacity: 274,080 LUTs; 548,160 registers; 1,824 half-BRAMs (912×36Kb).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

ZCU102_LUTS = 274_080
ZCU102_REGS = 548_160
ZCU102_LUTRAM = 144_000


@dataclass(frozen=True)
class SchedulerDesign:
    P: int = 4        # number of PEs
    D: int = 512      # priority-queue depth
    W_avg: int = 16   # bit width of Avg_TID
    W_exec: int = 16  # bit width of Exec_TID[PE_i]

    @property
    def W_qid(self) -> int:
        return max(1, math.ceil(math.log2(self.D)))


# --- fitted constants -------------------------------------------------------
# Priority queue cell cost per bit of (W_avg + W_qid) payload, fitted to
# Table IV's P=4 rows (D=256→512 slope; exact at D=256/512, <4% at D=64).
_LUT_PER_CELL_BIT = 1.4643   # logic LUTs per queue-cell payload bit
_REG_PER_CELL_BIT = 1.0503   # registers per queue-cell payload bit
_LUT_QUEUE_BASE = 409.0      # control FSM / sorted-detect / shift control
_REG_QUEUE_BASE = 962.0

# PE handler: adder (W_exec) + availability register + mux.
_LUT_PER_PE_BIT = 6.3        # from Table II: 404 LUTs / 4 PEs / 16 bits
_REG_PER_PE_BIT = 2.0        # 128 regs / 4 PEs / 16 bits

# EFT selector comparator tree: (P-1) comparators of W_exec bits.
_LUT_PER_CMP_BIT = 1.0       # from Table II: 48 LUTs / 3 comparators / 16 bits

# LUT-RAM: a Xilinx SLICEM LUT stores 64 bits; distributed RAM for the
# Exec[QID][PE] table costs P·D·W_exec/64 LUTs ≈ 0.625·P·D at W=16 with
# dual-port duplication (matches 160/320/640/1280/2560 in Table IV exactly).
_LUTRAM_PER_ENTRY_BIT = 0.625 / 16.0
_LUTRAM_BRAM_THRESHOLD = 4096  # P·D above which tools spill to BRAM (P=16 row)

# Path delay (ns): base queue compare-exchange + EFT tree depth + fanout term.
# Exact 3-point fit to Table IV (P=4:3.048, P=8:4.637, P=16:6.875 @ D=512):
#   delay = a + b·log2(P) + c·P·log2(P)
_DELAY_BASE = 0.519
_DELAY_PER_TREE_LEVEL = 1.15633
_DELAY_PER_PE_FANOUT = 0.027042


def queue_luts(d: SchedulerDesign) -> float:
    bits = d.W_avg + d.W_qid
    return _LUT_QUEUE_BASE + _LUT_PER_CELL_BIT * d.D * bits


def queue_registers(d: SchedulerDesign) -> float:
    bits = d.W_avg + d.W_qid
    return _REG_QUEUE_BASE + _REG_PER_CELL_BIT * d.D * bits


def pe_handler_luts(d: SchedulerDesign) -> float:
    return _LUT_PER_PE_BIT * d.P * d.W_exec


def pe_handler_registers(d: SchedulerDesign) -> float:
    return _REG_PER_PE_BIT * d.P * d.W_exec


def eft_selector_luts(d: SchedulerDesign) -> float:
    return _LUT_PER_CMP_BIT * (d.P - 1) * d.W_exec


def lutram(d: SchedulerDesign) -> float:
    if d.P * d.D > _LUTRAM_BRAM_THRESHOLD:
        # tools split between LUT-RAM and BRAM past the threshold (Table IV,
        # P=16 row: 3,200 LUT-RAM + 3.5 BRAM instead of 5,120 LUT-RAM).
        return _LUTRAM_PER_ENTRY_BIT * _LUTRAM_BRAM_THRESHOLD * d.W_exec + \
            0.25 * _LUTRAM_PER_ENTRY_BIT * (d.P * d.D - _LUTRAM_BRAM_THRESHOLD) * d.W_exec
    return _LUTRAM_PER_ENTRY_BIT * d.P * d.D * d.W_exec


def bram(d: SchedulerDesign) -> float:
    if d.P * d.D > _LUTRAM_BRAM_THRESHOLD:
        return 3.5
    return 0.5  # TID store (paper Table II "Total" row)


def total_luts(d: SchedulerDesign) -> float:
    return queue_luts(d) + pe_handler_luts(d) + eft_selector_luts(d)


def total_registers(d: SchedulerDesign) -> float:
    return queue_registers(d) + pe_handler_registers(d)


def critical_path_ns(d: SchedulerDesign) -> float:
    """Path delay: flat in D, tree-depth + fan-out growth in P."""
    tree_levels = math.ceil(math.log2(max(d.P, 2)))
    return _DELAY_BASE + _DELAY_PER_TREE_LEVEL * tree_levels + \
        _DELAY_PER_PE_FANOUT * d.P * tree_levels


def utilization(d: SchedulerDesign) -> dict[str, float]:
    return {
        "luts": total_luts(d) / ZCU102_LUTS,
        "registers": total_registers(d) / ZCU102_REGS,
        "lutram": lutram(d) / ZCU102_LUTRAM,
    }


# Paper ground truth for the benchmark comparison (Tables II–IV).
PAPER_TABLE_IV = [
    # (P, D, LUTs, LUT-RAM, Registers, BRAM, critical path ns)
    (4, 64, 2817, 160, 2520, 0.5, 3.060),
    (4, 128, 5190, 320, 4159, 0.5, 3.029),
    (4, 256, 9857, 640, 7543, 0.5, 2.976),
    (4, 512, 19603, 1280, 14534, 0.5, 3.048),
    (8, 512, 20471, 2560, 15243, 0.5, 4.637),
    (16, 512, 22038, 3200, 16422, 3.5, 6.875),
]

PAPER_TABLE_II = {
    "priority_queue": {"luts": 18632, "registers": 13433},
    "pe_handlers": {"luts": 404, "registers": 128},
    "eft_selector": {"luts": 48, "registers": 0},
    "total": {"luts": 19603, "lutram": 1280, "registers": 14534, "bram": 0.5},
}

PAPER_TABLE_III = {
    # HEFT_RT1: P=16, D=132, W=16 — vs Derafshi et al. [5]
    "heft_rt1": {"P": 16, "D": 132, "W": 16,
                 "luts": 7598, "lutram": 1920, "registers": 6430, "delay_ns": 5.91},
    # HEFT_RT2: P=4, D=64, W=32 — vs Tang & Bergmann [4]
    "heft_rt2": {"P": 4, "D": 64, "W": 32,
                 "luts": 4360, "lutram": 160, "registers": 3590, "delay_ns": 3.035},
}

# The design point used for the headline 9.144 ns/decision claim.
PAPER_DESIGN = SchedulerDesign(P=4, D=512, W_avg=16, W_exec=16)
PAPER_CRITICAL_PATH_NS = 3.048
PAPER_PER_DECISION_NS = 9.144

"""Application task DAGs — the paper's four CEDR signal-processing workloads.

The paper (Section V) evaluates with four real-world applications shipped with
CEDR: Radar Correlator (RC), Temporal Interference Mitigation (TM) — the *low
latency* pair — and Pulse Doppler (PD), WiFi TX (TX) — the *high latency*
pair.  The SoC is 3× ARM Cortex-A53 cores + 1× FFT accelerator on the ZCU102.

We model each application as a task DAG whose tasks are typed (FFT vs.
general-purpose DSP); per-PE execution times come from a PE-type table:
ARM cores run everything; the FFT accelerator runs only FFT-type tasks, ~11×
faster than an A53 (typical for the Xilinx FFT IP at these sizes).  Exec-time
magnitudes are calibrated so the high-latency workload saturates near the
paper's operating range (~200 frames/s on 4 PEs ⇒ ≈20 PE-milliseconds per
frame across both apps); the *relative* structure (fan-out, FFT fraction,
chain depth) follows each application's published signal chain.

These tables play the role of CEDR's profiled per-PE execution times — the
inputs the runtime hands the scheduler at every mapping event.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

# PE types
ARM = "arm"
FFT_ACC = "fft"

#: execution-time table (milliseconds): task_type -> {pe_type: time}
#: np.inf marks unsupported placements (accelerator can't run scalar DSP).
#: Magnitudes calibrated so the 4-PE SoC saturates near the paper's operating
#: point (~200-230 frames/s on the high-latency workload before scheduling
#: overhead; see bench_frame_rate.py).
EXEC_TABLE_MS: dict[str, dict[str, float]] = {
    # FFT-type tasks — supported everywhere, much faster on the accelerator.
    "fft_small":  {ARM: 0.083, FFT_ACC: 0.0083},
    "fft_large":  {ARM: 0.348, FFT_ACC: 0.0348},
    # general DSP tasks — ARM only.
    "mult":       {ARM: 0.139, FFT_ACC: np.inf},
    "detect":     {ARM: 0.083, FFT_ACC: np.inf},
    "modulate":   {ARM: 0.139, FFT_ACC: np.inf},
    "encode":     {ARM: 0.209, FFT_ACC: np.inf},
    "interleave": {ARM: 0.070, FFT_ACC: np.inf},
    "crc":        {ARM: 0.056, FFT_ACC: np.inf},
    "filter":     {ARM: 0.167, FFT_ACC: np.inf},
}


@dataclass
class AppTask:
    name: str
    task_type: str
    deps: list[int] = field(default_factory=list)   # indices within the app


@dataclass
class AppDAG:
    """An application instance template (the paper's "Frame" granularity)."""

    app_name: str
    tasks: list[AppTask]
    frame_kb: float          # input data size per frame (paper: 1280 / 1037 Kb)

    def exec_matrix(self, pe_types: list[str],
                    noise: np.random.Generator | None = None) -> np.ndarray:
        """(T, P) execution-time matrix in ms for a concrete SoC config."""
        mat = np.empty((len(self.tasks), len(pe_types)))
        for ti, t in enumerate(self.tasks):
            row = EXEC_TABLE_MS[t.task_type]
            for pi, pt in enumerate(pe_types):
                mat[ti, pi] = row[pt]
        if noise is not None:
            jitter = noise.normal(1.0, 0.03, mat.shape)  # profiling noise
            mat = np.where(np.isfinite(mat), mat * np.clip(jitter, 0.8, 1.2), mat)
        return mat

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def successors(self) -> dict[int, list[int]]:
        succ: dict[int, list[int]] = {i: [] for i in range(self.num_tasks)}
        for i, t in enumerate(self.tasks):
            for d in t.deps:
                succ[d].append(i)
        return succ


def radar_correlator() -> AppDAG:
    """RC: FFT(x), FFT(ref) → spectral multiply (conj) → IFFT → peak detect."""
    tasks = [
        AppTask("fft_x", "fft_small"),
        AppTask("fft_ref", "fft_small"),
        AppTask("xcorr_mult", "mult", deps=[0, 1]),
        AppTask("ifft", "fft_small", deps=[2]),
        AppTask("peak_detect", "detect", deps=[3]),
    ]
    return AppDAG("RC", tasks, frame_kb=1280.0)


def temporal_mitigation() -> AppDAG:
    """TM: split signal, filter both arms, correlate, subtract, detect."""
    tasks = [
        AppTask("fft_sig", "fft_small"),
        AppTask("filter_a", "filter", deps=[0]),
        AppTask("filter_b", "filter", deps=[0]),
        AppTask("corr_mult", "mult", deps=[1, 2]),
        AppTask("ifft", "fft_small", deps=[3]),
        AppTask("subtract", "mult", deps=[4]),
        AppTask("detect", "detect", deps=[5]),
    ]
    return AppDAG("TM", tasks, frame_kb=1280.0)


def pulse_doppler(num_pulses: int = 64) -> AppDAG:
    """PD: range FFT per pulse → corner turn → Doppler FFT bank → CFAR detect.

    The classic pulse-Doppler cube: wide FFT fan-out (this is what makes it a
    *high-latency* app that floods the ready queue — the regime where the
    paper's hardware scheduler wins).
    """
    tasks: list[AppTask] = []
    for p in range(num_pulses):
        tasks.append(AppTask(f"range_fft_{p}", "fft_large"))
    ct = len(tasks)
    tasks.append(AppTask("corner_turn", "mult", deps=list(range(num_pulses))))
    for d in range(num_pulses):
        tasks.append(AppTask(f"doppler_fft_{d}", "fft_large", deps=[ct]))
    cfar_deps = list(range(ct + 1, ct + 1 + num_pulses))
    tasks.append(AppTask("cfar_detect", "detect", deps=cfar_deps))
    return AppDAG("PD", tasks, frame_kb=1037.0)


def wifi_tx(num_symbols: int = 16) -> AppDAG:
    """TX: scramble→encode→interleave→modulate per OFDM symbol, IFFT, CRC."""
    tasks: list[AppTask] = [AppTask("crc_scramble", "crc")]
    prev_chain_heads = []
    for s in range(num_symbols):
        e = len(tasks)
        tasks.append(AppTask(f"encode_{s}", "encode", deps=[0]))
        tasks.append(AppTask(f"interleave_{s}", "interleave", deps=[e]))
        tasks.append(AppTask(f"modulate_{s}", "modulate", deps=[e + 1]))
        tasks.append(AppTask(f"ifft_{s}", "fft_small", deps=[e + 2]))
        prev_chain_heads.append(e + 3)
    tasks.append(AppTask("frame_assemble", "mult", deps=prev_chain_heads))
    return AppDAG("TX", tasks, frame_kb=1037.0)


APPS: dict[str, AppDAG] = {}


def get_app(name: str) -> AppDAG:
    if name not in APPS:
        APPS.update({
            "RC": radar_correlator(),
            "TM": temporal_mitigation(),
            "PD": pulse_doppler(),
            "TX": wifi_tx(),
        })
    return APPS[name]


def paper_soc_pe_types() -> list[str]:
    """The paper's emulated SoC: 3× ARM Cortex-A53 + 1× FFT accelerator."""
    return [ARM, ARM, ARM, FFT_ACC]


def make_soc(num_arm: int, num_fft: int) -> list[str]:
    return list(itertools.chain([ARM] * num_arm, [FFT_ACC] * num_fft))


def low_latency_workload() -> list[str]:
    """Paper §V: twenty frames each of RC and TM."""
    return ["RC", "TM"] * 20


def high_latency_workload() -> list[str]:
    """Paper §V: ten instances each of PD and TX."""
    return ["PD", "TX"] * 10

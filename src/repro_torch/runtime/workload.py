"""Workload generation — the paper's frame-based injection-rate methodology.

Section V: a *workload* is a sequence of application frames; the *injection
rate* (Mbps of input data entering the runtime) together with the per-frame
input size (Kb) fixes the frame arrival rate (frames/s).  The paper sweeps 29
injection rates and repeats each configuration 25 times.

  low-latency workload : 20 frames each of RC and TM, 1280 Kb/frame
  high-latency workload: 10 instances each of PD and TX, 1037 Kb/frame
"""

from __future__ import annotations

import numpy as np

from repro_torch.runtime.apps import get_app, high_latency_workload, low_latency_workload


def frames_per_second(injection_mbps: float, frame_kb: float) -> float:
    """rate [Mb/s] × 1000 [Kb/Mb] ÷ frame size [Kb] = frames/s."""
    return injection_mbps * 1000.0 / frame_kb


def injection_mbps(frame_rate: float, frame_kb: float) -> float:
    return frame_rate * frame_kb / 1000.0


def make_arrivals(
    app_names: list[str],
    frame_rate: float,
    seed: int = 0,
    jitter: float = 0.1,
    repeats: int = 1,
) -> list[tuple[float, str]]:
    """Evenly spaced arrivals at ``frame_rate`` frames/s with mild jitter.

    ``repeats`` replays the workload back-to-back (steady-state statistics at
    a given rate, standing in for the paper's 25 repetitions per point).
    """
    rng = np.random.default_rng(seed)
    names = list(app_names) * repeats
    inter = 1.0 / frame_rate
    times = np.arange(len(names)) * inter
    if jitter > 0:
        times = times + rng.uniform(0, jitter * inter, len(names))
    return sorted(zip(times.tolist(), names), key=lambda x: x[0])


def low_latency_arrivals(frame_rate: float, seed: int = 0, repeats: int = 1):
    return make_arrivals(low_latency_workload(), frame_rate, seed, repeats=repeats)


def high_latency_arrivals(frame_rate: float, seed: int = 0, repeats: int = 1):
    return make_arrivals(high_latency_workload(), frame_rate, seed, repeats=repeats)


def paper_injection_sweep_mbps(n: int = 29, lo: float = 25.0, hi: float = 700.0) -> np.ndarray:
    """29 injection rates spanning under- to over-subscription (paper §V)."""
    return np.linspace(lo, hi, n)


def workload_frame_kb(kind: str) -> float:
    names = {"low": "RC", "high": "PD"}
    return get_app(names[kind]).frame_kb

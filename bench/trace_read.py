"""Reduce a ``torch.profiler`` trace of the traced sub-window to numbers.

* the device's busy seconds: the union of the device intervals
  (:func:`bounds.busy_us`), against the sub-window's host-clock length;
* device time by kernel name, with launch counts;
* the device's idle gaps, each put down to what the host was doing at its
  middle: the innermost host range open there (the harness's
  ``bench.*`` labels of the wrapped calls, the program's ATen ops, the CUDA
  runtime calls), as ``"<harness label> / <innermost range>"``, or the
  label alone where the host ran Python between ops.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

import torch

from bench.bounds import busy_us

TOP = 10


def _device_events(prof):
    """(device kernels and copies, host ranges) as (start, end, name) in µs.
    The device-side mirrors of the harness's ``bench.*`` labels are
    annotations, not work, and are left out."""
    dev, host = [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not (ev.name.startswith("bench.")
                    or getattr(ev, "is_user_annotation", False)):
                dev.append((s, e, ev.name))
        else:
            host.append((s, e, ev.name))
    return dev, host


def _gaps(dev):
    """Idle (start, end) gaps between the merged device intervals."""
    gaps, end = [], None
    for s, e, _ in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _label_gaps(gaps, host):
    """For each gap (by its middle), the outermost ``bench.*`` range and the
    innermost host range open there."""
    host = sorted(host)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    labels = [None] * len(gaps)
    open_ = []          # heap of (end, -start, name)
    j = 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(open_, (host[j][1], -host[j][0], host[j][2]))
            j += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        live = sorted((-ns, e, n) for e, ns, n in open_)    # by start
        bench = next((n for _, _, n in live if n.startswith("bench.")),
                     "front end")
        inner = live[-1][2] if live else bench
        labels[i] = bench if inner == bench else f"{bench} / {inner}"
    return labels


def summarize(prof, window_s: float) -> dict:
    dev, host = _device_events(prof)
    by_name = defaultdict(float)
    launches = defaultdict(int)
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e6
        launches[name] += 1
    gaps = _gaps(dev)
    idle = defaultdict(float)
    for (s, e), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label] += (e - s) / 1e6
    busy = busy_us([(s, e) for s, e, _ in dev]) / 1e6
    return {
        "busy_s": busy,
        "window_s": window_s,
        "kernel_s": dict(by_name),
        "launches": dict(launches),
        "device_ops": sorted(([n, t] for n, t in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([n, t] for n, t in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }

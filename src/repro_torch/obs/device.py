"""Device-resident scheduler counters — the software analogue of the
paper's hardware performance counters.

Counterpart of ``repro.obs.device``.  The mapping fabric keeps an f32
register vector on the device and folds each dispatch's outputs into it in
place, with no per-event host sync; :meth:`MappingFabric.drain_counters`
reads it on demand (one host transfer), like reading the overlay's counter
file over AXI.

Counter lanes (:data:`COUNTER_NAMES`):

* ``events`` — mapping events dispatched (batch rows count individually),
* ``decisions`` — tasks actually committed to a PE (assignment ≥ 0),
* ``occupancy`` — real (non-padding) ready-queue slots seen,
* ``t_avail_spread`` — Σ per-event (max − min) of the post-event T_avail
  registers over real PE lanes.

Counters are f32 on the device: counts stay exact up to 2**24 per drain.
"""

from __future__ import annotations

import numpy as np
import torch

COUNTER_NAMES = ("events", "decisions", "occupancy", "t_avail_spread")
NUM_COUNTERS = len(COUNTER_NAMES)


def zero_counters(device) -> torch.Tensor:
    """Fresh counter registers (f32[NUM_COUNTERS]) on ``device``."""
    return torch.zeros((NUM_COUNTERS,), dtype=torch.float32, device=device)


def accumulate_counters(counters, assignment, new_avail, valid, p_valid):
    """Fold one dispatch's outputs into the counter registers, in place.

    ``assignment``/``valid``: (D,) or (B, D); ``new_avail``: (P,) or
    (B, P); ``p_valid``: (P,) real-lane mask (False on padded PE lanes,
    whose registers are inert).  Padded batch rows (no valid slot) count
    nothing.  Returns ``counters``.
    """
    if assignment.dim() == 1:
        assignment = assignment[None]
        new_avail = new_avail[None]
        valid = valid[None]
    row_valid = valid.any(dim=1)
    # made on the device: a host tensor's copy would wait for the stream
    # (the fused tick's whole decode step) before the decision's launch
    inf = torch.full((), float("inf"), device=new_avail.device)
    mx = torch.where(p_valid[None, :], new_avail, -inf).amax(dim=1)
    mn = torch.where(p_valid[None, :], new_avail, inf).amin(dim=1)
    spread = torch.where(row_valid, mx - mn, 0.0).sum()
    delta = torch.stack([
        row_valid.sum(),
        ((assignment >= 0) & valid).sum(),
        valid.sum(),
    ]).to(torch.float32)
    counters[:3] += delta
    counters[3:] += spread.to(torch.float32)
    return counters


def accumulate_counters_np(counters, assignment, new_avail, valid=None):
    """Host twin for the fabric's numpy backend (no padded lanes there).

    ``counters`` is a mutable f64 array updated in place; semantics match
    :func:`accumulate_counters` lane for lane.
    """
    assignment = np.asarray(assignment)
    new_avail = np.asarray(new_avail)
    if valid is None and assignment.ndim == 1:
        # Hot path (per-event map_event): scalar ops, no temporaries beyond
        # one bool mask — this runs once per mapping event.
        counters[0] += 1.0
        counters[1] += int((assignment >= 0).sum())
        counters[2] += assignment.size
        counters[3] += float(new_avail.max() - new_avail.min())
        return counters
    assignment = np.atleast_2d(assignment)
    new_avail = np.atleast_2d(new_avail)
    if valid is None:
        valid = np.ones(assignment.shape, dtype=bool)
    counters[0] += np.sum(np.any(valid, axis=1))
    counters[1] += np.sum((assignment >= 0) & valid)
    counters[2] += np.sum(valid)
    counters[3] += np.sum(new_avail.max(axis=1) - new_avail.min(axis=1))
    return counters


def counters_dict(values) -> dict[str, float]:
    """Name → value view of a drained register vector."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.shape != (NUM_COUNTERS,):
        raise ValueError(
            f"expected {NUM_COUNTERS} counter lanes, got shape {arr.shape}")
    return {name: float(arr[i]) for i, name in enumerate(COUNTER_NAMES)}

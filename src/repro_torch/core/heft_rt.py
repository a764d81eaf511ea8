"""HEFT_RT — the runtime variant of Heterogeneous Earliest Finish Time.

PyTorch counterpart of ``repro.core.heft_rt``.  At each *mapping event* the
scheduler receives the ready queue (per task its average execution time
``Avg_TID`` and its per-PE execution times ``Exec_TID[PE_i]``) and the
availability time of every PE (``T_avail``), sorts the queue by descending
average (the priority queue) and assigns tasks one by one to the PE with the
earliest finish time ``T_avail[PE_i] + Exec_TID[PE_i]``, updating the chosen
PE's availability register after each assignment.

This module is the plain eager version (a Python loop over the D steps): the
oracle for the port's CUDA kernels (:mod:`repro_torch.kernels`), never the
path the card runs.

Conventions (identical to the JAX reference):

* Invalid / padding slots (``valid=False``) sort last and get assignment -1.
* Unsupported (task, PE) pairs carry ``exec = +inf``; a task no PE supports
  is unschedulable (-1, start and finish ``+inf``).
* EFT ties resolve to the lowest PE index; a NaN finish wins the argmin and
  then fails the finite guard (``jnp.argmin``'s and ``np.argmin``'s rule).
* The priority sort is stable.  ``torch.argsort(-keys, stable=True)`` orders
  NaN keys last, as ``jnp.argsort(-keys, stable=True)`` does
  (``argsort(keys, descending=True)`` would put them first).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = float("inf")


class ScheduleResult(NamedTuple):
    """Output of one mapping event (or a batch of them, leading dims first).

    All per-task tensors are in *priority order*, length D.
    """

    order: torch.Tensor        # i32[..., D] — queue slot (QID) in priority order
    assignment: torch.Tensor   # i32[..., D] — selected PE, -1 if none
    start_time: torch.Tensor   # f32[..., D] — T_avail of the PE at assignment
    finish_time: torch.Tensor  # f32[..., D] — start + exec on the selected PE
    new_avail: torch.Tensor    # f32[..., P] — updated availability registers


def priority_order(avg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Stable descending sort order by average execution time over the last
    dim: highest ``Avg_TID`` first, NaN keys after ``-inf``, invalid slots
    last, stable among ties."""
    keys = torch.where(valid, avg.to(torch.float32),
                       torch.tensor(-INF, dtype=torch.float32,
                                    device=avg.device))
    return torch.argsort(-keys, dim=-1, stable=True).to(torch.int32)


def eft_assign(exec_sorted: torch.Tensor, avail: torch.Tensor,
               valid_sorted: torch.Tensor | None = None):
    """Sequential EFT assignment — the PE-handler / EFT-selector loop.

    ``exec_sorted``: f32[..., D, P] in priority order; ``avail``: f32[..., P];
    ``valid_sorted``: bool[..., D] or None (all valid).  Leading dims are
    independent events.  Returns (assignment i32[..., D], start f32[..., D],
    finish f32[..., D], new_avail f32[..., P]).
    """
    ex = exec_sorted.to(torch.float32)
    av = avail.to(torch.float32).clone()
    D = ex.shape[-2]
    lead = ex.shape[:-2]
    pes = torch.full((*lead, D), -1, dtype=torch.int32, device=ex.device)
    starts = torch.full((*lead, D), INF, dtype=torch.float32, device=ex.device)
    fins = torch.full((*lead, D), INF, dtype=torch.float32, device=ex.device)
    # A step whose exec rows hold no finite value in any event resolves to
    # -1 / +inf and leaves the registers alone (+inf or NaN finish fails the
    # finite guard), so the loop visits only steps with work; trailing
    # padded slots cost nothing.
    live = (torch.isfinite(ex).any(dim=-1).reshape(-1, D).any(dim=0).tolist()
            if D else [])
    for t in range(D):
        if not live[t]:
            continue
        finish = av + ex[..., t, :]                      # PE handlers: adders
        pe = torch.argmin(finish, dim=-1, keepdim=True)  # EFT selector
        f = finish.gather(-1, pe)
        start = av.gather(-1, pe)
        ok = torch.isfinite(f)
        if valid_sorted is not None:
            ok &= valid_sorted[..., t:t + 1]
        # Write-back of the selected register only (old value when not ok).
        av.scatter_(-1, pe, torch.where(ok, f, start))
        pes[..., t] = torch.where(ok, pe, -1)[..., 0].to(torch.int32)
        starts[..., t] = torch.where(ok, start, INF)[..., 0]
        fins[..., t] = torch.where(ok, f, INF)[..., 0]
    return pes, starts, fins, av


def heft_rt(avg: torch.Tensor, exec_times: torch.Tensor, avail: torch.Tensor,
            valid: torch.Tensor | None = None) -> ScheduleResult:
    """One HEFT_RT mapping event (plain reference implementation).

    ``avg``: f32[..., D]; ``exec_times``: f32[..., D, P]; ``avail``:
    f32[..., P]; ``valid``: bool[..., D] or None.  Leading dims, when
    present, are independent events.
    """
    if valid is None:
        valid = torch.ones(avg.shape, dtype=torch.bool, device=avg.device)
    order = priority_order(avg, valid)
    idx = order.to(torch.int64)
    exec_sorted = torch.gather(
        exec_times, -2,
        idx[..., None].expand(*idx.shape, exec_times.shape[-1]))
    valid_sorted = torch.gather(valid, -1, idx)
    pes, starts, fins, new_avail = eft_assign(exec_sorted, avail, valid_sorted)
    return ScheduleResult(order, pes, starts, fins, new_avail)


def heft_rt_batched(avg, exec_times, avail, valid=None) -> ScheduleResult:
    """B independent mapping events, the batch dim written out (the JAX
    reference vmaps).  ``avg``: (B, D), ``exec_times``: (B, D, P),
    ``avail``: (B, P), ``valid``: (B, D) or None."""
    if avg.dim() != 2 or exec_times.dim() != 3 or avail.dim() != 2:
        raise ValueError(
            f"heft_rt_batched wants (B, D), (B, D, P), (B, P); got "
            f"{tuple(avg.shape)}, {tuple(exec_times.shape)}, "
            f"{tuple(avail.shape)}")
    return heft_rt(avg, exec_times, avail, valid)


# ---------------------------------------------------------------------------
# Plain-numpy twin (copied from the reference) used by the runtime twin's
# overhead model and as the float64 oracle in the tests.
# ---------------------------------------------------------------------------

def heft_rt_numpy(avg, exec_times, avail):
    """Returns (order, assignment, start, finish, new_avail) as numpy arrays.

    ``avg``: (n,), ``exec_times``: (n, P), ``avail``: (P,). All slots valid.
    """
    avg = np.asarray(avg, dtype=np.float64)
    exec_times = np.asarray(exec_times, dtype=np.float64)
    avail = np.array(avail, dtype=np.float64)
    n = avg.shape[0]
    # numpy has no descending stable sort; negate with stable mergesort.
    order = np.argsort(-avg, kind="stable")
    assignment = np.full(n, -1, dtype=np.int64)
    start = np.full(n, np.inf)
    finish = np.full(n, np.inf)
    for i, t in enumerate(order):
        fin = avail + exec_times[t]
        pe = int(np.argmin(fin))
        if np.isfinite(fin[pe]):
            assignment[i] = pe
            start[i] = avail[pe]
            finish[i] = fin[pe]
            avail[pe] = fin[pe]
    return order, assignment, start, finish, avail

"""Plain PyTorch oracles for the HEFT_RT hardware-dataplane kernels.

Counterpart of ``repro.kernels.ref``.  Every CUDA kernel of the port is held
against these (on the card by ``chip_smoke.py``, on the CPU by the tests),
and these are held against :mod:`repro_torch.core.heft_rt` and the JAX
references, so kernel ⇔ software-scheduler equivalence (the paper's Fig. 3
functional verification) is transitive.  Leading dims, where a function
takes them, are independent events.
"""

from __future__ import annotations

import torch

from repro_torch.core.heft_rt import eft_assign

NEG_INF = float("-inf")


def oddeven_sort_ref(keys: torch.Tensor, payload: torch.Tensor):
    """Stable descending sort of (keys, payload) over the last dim — what the
    shift-register priority queue computes.  Odd–even transposition with
    strict compares is stable, so a stable descending argsort is the exact
    oracle (NaN keys last, as ``jnp.argsort(-keys, stable=True)``)."""
    order = torch.argsort(-keys.to(torch.float32), dim=-1, stable=True)
    return keys.gather(-1, order), payload.gather(-1, order)


def oddeven_sort_sim(keys: torch.Tensor, payload: torch.Tensor):
    """Step-by-step odd–even transposition (descending, strict swap) on a 1-D
    queue, written with the brick-wall even/odd-plane decomposition of the
    reference's Pallas kernel — an executable spec of its inner loop."""
    D = keys.shape[0]
    if D % 2:
        raise ValueError(f"oddeven_sort_sim needs an even length, got {D}")
    M = D // 2
    ke, ko = keys[0::2].to(torch.float32), keys[1::2].to(torch.float32)
    pe_, po = payload[0::2], payload[1::2]
    for _ in range(M + 1):
        # even phase: compare (2i, 2i+1) == (ke[i], ko[i])
        m = ke < ko
        ke, ko = torch.where(m, ko, ke), torch.where(m, ke, ko)
        pe_, po = torch.where(m, po, pe_), torch.where(m, pe_, po)
        # odd phase: compare (2i+1, 2i+2) == (ko[i], ke[i+1])
        b = torch.roll(ke, -1)
        b[M - 1] = NEG_INF                                # right neighbours
        pb = torch.roll(pe_, -1)
        m = ko < b
        ko_new = torch.where(m, b, ko)
        b_new = torch.where(m, ko, b)
        pb_new = torch.where(m, po, pb)
        po_new = torch.where(m, pb, po)
        ke_new = torch.roll(b_new, 1)
        ke_new[0] = ke[0]
        pe_new = torch.roll(pb_new, 1)
        pe_new[0] = pe_[0]
        ke, ko, pe_, po = ke_new, ko_new, pe_new, po_new
    keys_out = torch.stack([ke, ko], dim=1).reshape(D)
    payload_out = torch.stack([pe_, po], dim=1).reshape(D)
    return keys_out.to(keys.dtype), payload_out


def eft_select_ref(exec_sorted: torch.Tensor, avail: torch.Tensor):
    """PE-handler + EFT-selector feedback loop over a queue already in
    priority order.

    Returns (assignment i32[..., D], start f32[..., D], finish f32[..., D],
    new_avail f32[..., P]).  Rows whose every exec is +inf get assignment -1
    and start/finish +inf, and do not touch the availability registers.
    """
    return eft_assign(exec_sorted, avail)


def heft_fused_ref(avg: torch.Tensor, exec_times: torch.Tensor,
                   avail: torch.Tensor):
    """Full mapping event: stable descending sort by ``avg``, then the EFT
    drain with each row read by QID.  ``exec_times`` is in QUEUE order.

    Returns (order i32, assignment i32, start f32, finish f32, new_avail
    f32) — the plain version of the fused CUDA kernel and the exact mirror
    of :func:`repro_torch.core.heft_rt`.
    """
    D = avg.shape[-1]
    qids = torch.arange(D, dtype=torch.int32, device=avg.device)
    _, order = oddeven_sort_ref(avg, qids.expand(avg.shape))
    idx = order.to(torch.int64)
    exec_sorted = torch.gather(
        exec_times, -2,
        idx[..., None].expand(*idx.shape, exec_times.shape[-1]))
    pes, starts, fins, new_avail = eft_select_ref(exec_sorted, avail)
    return order, pes, starts, fins, new_avail

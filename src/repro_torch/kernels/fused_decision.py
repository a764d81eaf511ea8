"""The HEFT_RT decision with a device-resident PE mask: CUDA kernel
``csrc/fused_decision.cu``, its plain version and the host packing helpers.

Counterpart of ``repro.kernels.fused_decision``.  The decision's inputs (the
``T_avail`` register file, the PE mask, the counter registers) stay on the
card between events, and its outputs leave in one packed int32 transfer.

* :func:`decision_ref` — plain PyTorch: mask the exec lanes, then
  :func:`repro_torch.core.heft_rt`.
* :func:`fused_decision` — the kernel wrapper.  With an all-False mask it
  computes exactly what :func:`repro_torch.kernels.heft_fused.heft_fused`
  computes.

Masking contract: ``pe_mask`` is a bool lane vector; ``True`` lanes' exec
columns become ``+inf`` before the EFT selection (the chaos tier's partition
semantics), so a masked decision equals the ``heft_rt_numpy`` oracle on the
masked matrix.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.heft_rt import ScheduleResult, heft_rt
from repro_torch.kernels import _build
from repro_torch.kernels.heft_fused import _check_operands, launch_event

INF = float("inf")

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("fused_decision", "fused_decision.cu", {
    "fused_decision_launch": ([_P] * 10 + [_I] * 3 + [_P], ctypes.c_int),
    "fused_decision_scratch_slots": ([_I], ctypes.c_int),
})


def decision_ref(avg, exec_times, avail, valid, pe_mask) -> ScheduleResult:
    """One HEFT_RT mapping event with the PE mask applied (plain version).

    ``avg``: f32[..., D]; ``exec_times``: f32[..., D, P]; ``avail``:
    f32[..., P]; ``valid``: bool[..., D] or None; ``pe_mask``: bool[P],
    ``True`` lanes are withheld from dispatch (their registers stay).
    """
    ex = torch.where(pe_mask, torch.tensor(INF, device=exec_times.device),
                     exec_times.to(torch.float32))
    return heft_rt(avg, ex, avail, valid)


def fused_decision(keys, exec_times, avail, pe_mask, *,
                   out_avail=None) -> ScheduleResult:
    """B masked mapping events: ``keys`` f32[B, D], ``exec_times``
    f32[B, D, P], ``avail`` f32[B, P], ``pe_mask`` bool[P] shared by the
    batch.  ``out_avail`` (may be ``avail``) receives the new registers.
    CUDA tensors launch the kernel; CPU tensors run :func:`decision_ref`."""
    if keys.device.type == "cuda":
        return launch_event(KERNEL, "fused_decision_launch", keys,
                            exec_times, avail, pe_mask, out_avail)
    if keys.device.type != "cpu":
        raise ValueError(
            f"fused_decision runs on cuda or cpu, not {keys.device}")
    _check_operands(keys, exec_times, avail, pe_mask, out_avail)
    res = decision_ref(keys, exec_times, avail, None, pe_mask)
    if out_avail is not None:
        out_avail.copy_(res.new_avail)
        res = res._replace(new_avail=out_avail)
    return res


def pack_tick_outputs(toks, res: ScheduleResult) -> torch.Tensor:
    """Pack a decision's host-bound outputs into ONE int32 tensor:
    ``tokens | order | assignment | start | finish | new_avail``.

    Float lanes are reinterpreted with ``Tensor.view(torch.int32)``, a bit
    move: the host's ``.view(np.float32)`` recovers them bit-exactly, ±inf
    and every mantissa bit included.  One device→host copy then carries the
    whole decision.
    """
    def bits(x):
        return x.to(torch.float32).contiguous().view(torch.int32).reshape(-1)

    return torch.cat([
        toks.reshape(-1).to(torch.int32),
        res.order.reshape(-1).to(torch.int32),
        res.assignment.reshape(-1).to(torch.int32),
        bits(res.start_time),
        bits(res.finish_time),
        bits(res.new_avail),
    ])


def unpack_decision(buf, num_pes: int):
    """Host-side inverse of :func:`pack_tick_outputs`' decision lanes.

    ``buf``: the int32 host (numpy) buffer after the token prefix was sliced
    off (length ``4*D + P``); ``num_pes``: the padded lane count ``P``.
    Returns untrimmed ``(order, assignment, start, finish, new_avail)``
    numpy views, bit-identical to the tensors the card computed.
    """
    buf = np.asarray(buf)
    d = (buf.shape[0] - num_pes) // 4
    return (buf[:d], buf[d:2 * d],
            buf[2 * d:3 * d].view(np.float32),
            buf[3 * d:4 * d].view(np.float32),
            buf[4 * d:].view(np.float32))

"""Public wrappers for the HEFT_RT dataplane kernels and the paged
decode-attention kernel, the kernels' launch counters and their build.

Counterpart of ``repro.kernels.ops``.

Padding policy: none.  The reference pads the queue to a multiple of 256
slots and the PE axis to 128 lanes because that is the TPU's (8, 128) tile
layout, not part of the semantics.  The CUDA kernels take any queue depth
D >= 1 (the sort pads to a power of two in shared memory, or in scratch
above 4096 slots, with keys that sort after every real slot) and any P up to
1024 lanes (one thread steps up to 8 lanes, a warp strides over more).  The wrappers here only promote to
float32 / contiguous and add the batch dim the kernels want.

Public API
----------
``oddeven_sort(keys, payload)``               — stable descending sort (priority queue)
``eft_select(exec_sorted, avail)``            — EFT assignment over a sorted queue
``heft_rt_hw(avg, exec, avail)``             — fused mapping event
``decision_hw(avg, exec, avail, pe_mask)``    — mapping event with a PE mask
``paged_decode_attention(q, k, v, table, pos)`` — decode attention read from the pages
``build_kernels()``                           — nvcc every kernel, in parallel
``launch_counts()`` / ``reset_launch_counts()`` — per-kernel launch counters
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.heft_rt import ScheduleResult
from repro_torch.kernels import _build
from repro_torch.kernels import eft_select as _eft
from repro_torch.kernels import fused_decision as _decision
from repro_torch.kernels import heft_fused as _fused
from repro_torch.kernels import oddeven_sort as _sort
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels.paged_attention import paged_decode_attention

KERNELS = (_fused.KERNEL, _decision.KERNEL, _sort.KERNEL, _eft.KERNEL,
           _paged.KERNEL)


def build_kernels() -> None:
    """Build every kernel library that is missing, one nvcc per source, all
    started together (raises if nvcc is absent or a build fails)."""
    _build.build(KERNELS)
    for k in KERNELS:
        k.lib()


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _key_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the sort kernel takes the keys in: f32, bf16 and f16 as
    they are (the kernel compares the f32 values they widen to exactly),
    other floats in f32, integers in i32; anything else raises
    ``TypeError`` (the reference's rule: floats compare in f32, integers
    in i32)."""
    if dtype in (torch.float32, torch.bfloat16, torch.float16):
        return dtype
    if dtype.is_floating_point:
        return torch.float32
    if dtype != torch.bool and not dtype.is_complex:
        return torch.int32
    raise TypeError(f"unsupported key dtype {dtype}")


def oddeven_sort(keys: torch.Tensor, payload: torch.Tensor):
    """Stable descending sort of (keys, payload) over the last dim through
    the priority-queue kernel; leading dims are independent queues.

    Keys compare in :func:`_key_compute_dtype` (f32 keys: NaN last, -0.0
    tied with +0.0; integer keys: the exact int32 order) and come back in
    the input dtype, gathered from the inputs by the sorted slot (so -0.0
    stays -0.0); the payload comes back as int32.  An empty last dim
    launches nothing.
    """
    if keys.dim() == 0 or keys.shape != payload.shape:
        raise ValueError(f"want keys and payload of one shape (..., D); got "
                         f"{tuple(keys.shape)}, {tuple(payload.shape)}")
    cdt = _key_compute_dtype(keys.dtype)
    rows, D = math.prod(keys.shape[:-1]), keys.shape[-1]
    k = keys.to(cdt).reshape(rows, D).contiguous()
    p = payload.to(torch.int32).reshape(rows, D).contiguous()
    ks, ps = _sort.sort_rows(k, p)
    return ks.reshape(keys.shape).to(keys.dtype), ps.reshape(keys.shape)


def eft_select(exec_sorted: torch.Tensor, avail: torch.Tensor, *,
               out_avail=None):
    """EFT assignment over an already-sorted ready queue through the
    selector kernel: ``exec_sorted`` (..., D, P), ``avail`` (..., P); leading
    dims are independent events.

    Returns (assignment i32[..., D], start f32[..., D], finish f32[..., D],
    new_avail f32[..., P]).  ``out_avail`` (float32, contiguous, shaped like
    ``avail``) receives the new registers in place.
    """
    if exec_sorted.dim() < 2 or avail.shape != (*exec_sorted.shape[:-2],
                                                exec_sorted.shape[-1]):
        raise ValueError(f"want exec (..., D, P) and avail (..., P); got "
                         f"{tuple(exec_sorted.shape)}, {tuple(avail.shape)}")
    D, P = exec_sorted.shape[-2:]
    lead = exec_sorted.shape[:-2]
    B = math.prod(lead)
    ex = exec_sorted.to(torch.float32).reshape(B, D, P).contiguous()
    av = avail.to(torch.float32).reshape(B, P).contiguous()
    out = None
    if out_avail is not None:
        if out_avail.shape != avail.shape or not out_avail.is_contiguous():
            raise ValueError("out_avail must be contiguous and shaped like "
                             "avail")
        out = out_avail.view(B, P)
    pes, starts, fins, new_avail = _eft.eft_rows(ex, av, out_avail=out)
    new_avail = (new_avail.reshape(*lead, P) if out_avail is None
                 else out_avail)
    return (pes.reshape(*lead, D), starts.reshape(*lead, D),
            fins.reshape(*lead, D), new_avail)


def _operands(avg, exec_times, avail):
    """Promote to contiguous float32 and add the batch dim for 1-event
    inputs; returns (keys, exec, avail, batched)."""
    batched = exec_times.dim() == 3
    f32 = [t.to(torch.float32).contiguous() for t in (avg, exec_times, avail)]
    if not batched:
        f32 = [t.unsqueeze(0) for t in f32]
    return (*f32, batched)


def _unbatch(res: ScheduleResult, batched: bool) -> ScheduleResult:
    return res if batched else ScheduleResult(*(t[0] for t in res))


def heft_rt_hw(avg, exec_times, avail, *, out_avail=None) -> ScheduleResult:
    """One (``avg`` (D,), ``exec`` (D, P), ``avail`` (P,)) or B (leading
    batch dim) full HEFT_RT mapping events through the fused kernel.

    Mirrors :func:`repro_torch.core.heft_rt` exactly: returns (order,
    assignment, start, finish, new_avail).  ``out_avail`` (float32,
    contiguous, shaped like ``avail``) receives the new registers in place.
    """
    keys, ex, av, batched = _operands(avg, exec_times, avail)
    out = out_avail if out_avail is None or batched else out_avail.unsqueeze(0)
    return _unbatch(_fused.heft_fused(keys, ex, av, out_avail=out), batched)


def decision_hw(avg, exec_times, avail, pe_mask, *,
                out_avail=None) -> ScheduleResult:
    """Like :func:`heft_rt_hw` with a bool[P] ``pe_mask`` (True = lane
    withheld from dispatch) applied inside the kernel.  With an all-False
    mask this equals :func:`heft_rt_hw` bit for bit."""
    keys, ex, av, batched = _operands(avg, exec_times, avail)
    out = out_avail if out_avail is None or batched else out_avail.unsqueeze(0)
    mask = pe_mask.to(device=keys.device, dtype=torch.bool).contiguous()
    return _unbatch(_decision.fused_decision(keys, ex, av, mask,
                                             out_avail=out), batched)

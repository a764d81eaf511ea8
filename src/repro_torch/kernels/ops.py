"""Public wrappers for the HEFT_RT dataplane kernels, the kernels' launch
counters and their build.

Counterpart of ``repro.kernels.ops``.

Padding policy: none.  The reference pads the queue to a multiple of 256
slots and the PE axis to 128 lanes because that is the TPU's (8, 128) tile
layout, not part of the semantics.  The CUDA kernels take any queue depth
D >= 1 (the sort pads to a power of two in shared memory, or in scratch
above 4096 slots, with keys that sort after every real slot) and any P up to
1024 lanes (a warp strides over them).  The wrappers here only promote to
float32 / contiguous and add the batch dim the kernels want.

Public API
----------
``heft_rt_hw(avg, exec, avail)``             — fused mapping event
``decision_hw(avg, exec, avail, pe_mask)``    — mapping event with a PE mask
``build_kernels()``                           — nvcc every kernel, in parallel
``launch_counts()`` / ``reset_launch_counts()`` — per-kernel launch counters
"""

from __future__ import annotations

import torch

from repro_torch.core.heft_rt import ScheduleResult
from repro_torch.kernels import _build
from repro_torch.kernels import fused_decision as _decision
from repro_torch.kernels import heft_fused as _fused

KERNELS = (_fused.KERNEL, _decision.KERNEL)


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

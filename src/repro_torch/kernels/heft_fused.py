"""The fused HEFT_RT mapping event: CUDA kernel ``csrc/heft_fused.cu`` and
its wrapper.

Counterpart of ``repro.kernels.heft_fused`` (the Pallas ``_fused_kernel``).
One launch runs B independent mapping events, one CTA each: the priority
sort in shared memory, then the serial EFT drain over the event's rows
staged in shared memory, its no-op rows skipped (see the note at the top of
the ``.cu`` file).  The plain version beside it is
:func:`repro_torch.kernels.ref.heft_fused_ref`, and
:func:`repro_torch.kernels.ref.heft_event_sim` mirrors the kernel's drain
step by step.

The wrapper takes the kernel's exact operands and checks them; it launches
the kernel on a CUDA tensor and runs the plain version only on a CPU tensor.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.heft_rt import ScheduleResult
from repro_torch.kernels import _build
from repro_torch.kernels.ref import heft_fused_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("heft_fused", "heft_fused.cu", {
    "heft_fused_launch": ([_P] * 9 + [_I] * 3 + [_P], ctypes.c_int),
    "heft_fused_scratch_slots": ([_I], ctypes.c_int),
})


def _check_operands(keys, exec_times, avail, mask, out_avail):
    """Validate the kernel's operands; returns (B, D, P)."""
    if keys.dim() != 2 or exec_times.dim() != 3 or avail.dim() != 2:
        raise ValueError(
            f"want keys (B, D), exec (B, D, P), avail (B, P); got "
            f"{tuple(keys.shape)}, {tuple(exec_times.shape)}, "
            f"{tuple(avail.shape)}")
    B, D = keys.shape
    P = avail.shape[1]
    if exec_times.shape != (B, D, P) or avail.shape[0] != B:
        raise ValueError(
            f"shape mismatch: keys {tuple(keys.shape)}, exec "
            f"{tuple(exec_times.shape)}, avail {tuple(avail.shape)}")
    named = [("keys", keys), ("exec", exec_times), ("avail", avail)]
    if out_avail is not None:
        if out_avail.shape != (B, P):
            raise ValueError(f"out_avail must be ({B}, {P}), got "
                             f"{tuple(out_avail.shape)}")
        named.append(("out_avail", out_avail))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (P,):
            raise ValueError(f"mask must be bool ({P},), got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        named.append(("mask", mask))
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, D, P


def launch_event(kernel, symbol, keys, exec_times, avail, mask, out_avail):
    """Launch one of the event kernels on the current stream (no sync).

    ``mask`` is None for ``heft_fused`` and the bool[P] register for
    ``fused_decision``.  New registers land in ``out_avail`` (which may be
    ``avail`` itself: each CTA reads its row before it writes it)."""
    B, D, P = _check_operands(keys, exec_times, avail, mask, out_avail)
    if P > 1024:
        raise ValueError(f"the kernel holds at most 1024 PE lanes, got {P}")
    dev = keys.device
    if out_avail is None:
        out_avail = torch.empty_like(avail)
    order = torch.empty((B, D), dtype=torch.int32, device=dev)
    assignment = torch.empty((B, D), dtype=torch.int32, device=dev)
    start = torch.empty((B, D), dtype=torch.float32, device=dev)
    finish = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        if out_avail.data_ptr() != avail.data_ptr():
            out_avail.copy_(avail)
        return ScheduleResult(order, assignment, start, finish, out_avail)
    lib = kernel.lib()
    slots = getattr(lib, f"{kernel.name}_scratch_slots")(D)
    scratch = (torch.empty(B * slots, dtype=torch.int64, device=dev)
               if slots else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [keys.data_ptr(), exec_times.data_ptr(), avail.data_ptr()]
    if mask is not None:
        ptrs.append(mask.data_ptr())
    ptrs += [order.data_ptr(), assignment.data_ptr(), start.data_ptr(),
             finish.data_ptr(), out_avail.data_ptr(),
             scratch.data_ptr() if scratch is not None else None]
    status = getattr(lib, symbol)(*ptrs, B, D, P, stream)
    kernel.launches += 1
    _build.check_status(kernel, status)
    return ScheduleResult(order, assignment, start, finish, out_avail)


def heft_fused(keys, exec_times, avail, *, out_avail=None) -> ScheduleResult:
    """B mapping events: ``keys`` f32[B, D], ``exec_times`` f32[B, D, P] in
    queue order, ``avail`` f32[B, P] → :class:`ScheduleResult` with leading
    dim B.  ``out_avail`` (f32[B, P], may be ``avail``) receives the new
    registers.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if keys.device.type == "cuda":
        return launch_event(KERNEL, "heft_fused_launch", keys, exec_times,
                            avail, None, out_avail)
    if keys.device.type != "cpu":
        raise ValueError(f"heft_fused runs on cuda or cpu, not {keys.device}")
    _check_operands(keys, exec_times, avail, None, out_avail)
    res = ScheduleResult(*heft_fused_ref(keys, exec_times, avail))
    if out_avail is not None:
        out_avail.copy_(res.new_avail)
        res = res._replace(new_avail=out_avail)
    return res

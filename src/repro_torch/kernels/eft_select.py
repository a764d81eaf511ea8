"""The EFT selector: CUDA kernel ``csrc/eft_select.cu`` and its wrapper.

Counterpart of ``repro.kernels.eft_select`` (the Pallas ``_eft_kernel``,
the PE-handler / EFT-selector feedback loop over a queue already in
priority order).  One launch drains B independent events, one CTA each,
on the staged drain of the event kernels (``drain_event`` in
``csrc/heft_event.cuh``: rows staged in shared memory, no-op rows skipped;
see the note at the top of the ``.cu`` file).  Its plain version is
:func:`repro_torch.kernels.ref.eft_select_ref`, its step-by-step mirror
:func:`repro_torch.kernels.ref.eft_select_sim`.  The public entry point,
with dtype promotion and leading batch dims, is
:func:`repro_torch.kernels.eft_select`.

The wrapper takes the kernel's exact operands and checks them; it launches
the kernel on a CUDA tensor and runs the plain version only on a CPU
tensor.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import eft_select_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("eft_select", "eft_select.cu", {
    "eft_select_launch": ([_P] * 6 + [_I] * 3 + [_P], ctypes.c_int),
})


def _check_operands(exec_sorted, avail, out_avail):
    """Validate the kernel's operands; returns (B, D, P)."""
    if exec_sorted.dim() != 3 or avail.dim() != 2:
        raise ValueError(f"want exec (B, D, P), avail (B, P); got "
                         f"{tuple(exec_sorted.shape)}, {tuple(avail.shape)}")
    B, D, P = exec_sorted.shape
    if avail.shape != (B, P):
        raise ValueError(f"avail must be ({B}, {P}), got "
                         f"{tuple(avail.shape)}")
    if P == 0:
        raise ValueError("eft_select needs at least one PE")
    named = [("exec", exec_sorted), ("avail", avail)]
    if out_avail is not None:
        if out_avail.shape != (B, P):
            raise ValueError(f"out_avail must be ({B}, {P}), got "
                             f"{tuple(out_avail.shape)}")
        named.append(("out_avail", out_avail))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")
    return B, D, P


def eft_rows(exec_sorted: torch.Tensor, avail: torch.Tensor, *,
             out_avail: torch.Tensor | None = None):
    """B drains: ``exec_sorted`` f32[B, D, P] in priority order, ``avail``
    f32[B, P] → (assignment i32[B, D], start f32[B, D], finish f32[B, D],
    new_avail f32[B, P]).  ``out_avail`` (may be ``avail``) receives the new
    registers.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    B, D, P = _check_operands(exec_sorted, avail, out_avail)
    dev = exec_sorted.device
    if dev.type == "cpu":
        pes, starts, fins, new_avail = eft_select_ref(exec_sorted, avail)
        if out_avail is not None:
            out_avail.copy_(new_avail)
            new_avail = out_avail
        return pes, starts, fins, new_avail
    if dev.type != "cuda":
        raise ValueError(f"eft_select runs on cuda or cpu, not {dev}")
    if P > 1024:
        raise ValueError(f"the kernel holds at most 1024 PE lanes, got {P}")
    if out_avail is None:
        out_avail = torch.empty_like(avail)
    assignment = torch.empty((B, D), dtype=torch.int32, device=dev)
    start = torch.empty((B, D), dtype=torch.float32, device=dev)
    finish = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        if out_avail.data_ptr() != avail.data_ptr():
            out_avail.copy_(avail)
        return assignment, start, finish, out_avail
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = KERNEL.lib().eft_select_launch(
        exec_sorted.data_ptr(), avail.data_ptr(), assignment.data_ptr(),
        start.data_ptr(), finish.data_ptr(), out_avail.data_ptr(), B, D, P,
        stream)
    KERNEL.launches += 1
    _build.check_status(KERNEL, status)
    return assignment, start, finish, out_avail

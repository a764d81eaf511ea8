"""The priority queue's sort: CUDA kernel ``csrc/oddeven_sort.cu``, its plain
version and its wrapper.

Counterpart of ``repro.kernels.oddeven_sort`` (the Pallas ``_sort_kernel``,
an odd–even transposition network).  One launch sorts B independent rows,
one CTA each, with the bitonic network over composite (key rank, slot) keys
that the fused event kernels run as their phase 1: the keys in registers,
8 a thread, shared memory only for the stages whose pairs span warps (see
the note at the top of the ``.cu`` file); its step-by-step mirror is
:func:`repro_torch.kernels.ref.bitonic_sort_sim`.  The public entry point,
with dtype promotion and leading batch dims, is
:func:`repro_torch.kernels.oddeven_sort`.

The wrapper takes the kernel's exact operands (f32, bf16, f16 or i32 keys
``[B, D]``, i32 payload ``[B, D]``) and checks them; it launches the kernel on a CUDA
tensor and runs :func:`sort_plain` only on a CPU tensor.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("oddeven_sort", "oddeven_sort.cu", {
    "oddeven_sort_launch": ([_P] * 5 + [_I] * 3 + [_P], ctypes.c_int),
    "oddeven_sort_scratch_slots": ([_I], ctypes.c_int),
})

# Key dtypes the kernel takes, in the order of its key_kind code.
KEY_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16)


def sort_plain(keys: torch.Tensor, payload: torch.Tensor):
    """Stable descending sort of each row, the plain version of the kernel.

    Float keys take the order of ``torch.argsort(-keys.float(),
    stable=True)`` (NaN last, -0.0 tied with +0.0); i32 keys that of
    ``torch.sort(keys, descending=True, stable=True)``, the exact integer
    order.  Keys and payload are gathered from the inputs by the sorted
    slot."""
    if keys.dtype == torch.int32:
        order = torch.sort(keys, dim=-1, descending=True, stable=True).indices
    else:
        order = torch.argsort(-keys.float(), dim=-1, stable=True)
    return keys.gather(-1, order), payload.gather(-1, order)


def _check_operands(keys, payload):
    if keys.dim() != 2 or payload.shape != keys.shape:
        raise ValueError(f"want keys and payload (B, D); got "
                         f"{tuple(keys.shape)}, {tuple(payload.shape)}")
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"keys must be one of {KEY_DTYPES}, got "
                        f"{keys.dtype}")
    if payload.dtype != torch.int32:
        raise TypeError(f"payload must be int32, got {payload.dtype}")
    if keys.device != payload.device:
        raise ValueError(f"keys on {keys.device}, payload on {payload.device}")
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("keys and payload must be contiguous")


def sort_rows(keys: torch.Tensor, payload: torch.Tensor):
    """Sort B rows: ``keys`` f32, bf16, f16 or i32 ``[B, D]``, ``payload`` i32
    ``[B, D]`` → (sorted keys, sorted payload), fresh tensors.  CUDA tensors
    launch the kernel (none when B or D is 0); CPU tensors run
    :func:`sort_plain`."""
    _check_operands(keys, payload)
    if keys.device.type == "cpu":
        return sort_plain(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"oddeven_sort runs on cuda or cpu, not {keys.device}")
    B, D = keys.shape
    keys_out = torch.empty_like(keys)
    payload_out = torch.empty_like(payload)
    if B == 0 or D == 0:
        return keys_out, payload_out
    lib = KERNEL.lib()
    slots = lib.oddeven_sort_scratch_slots(D)
    scratch = (torch.empty(B * slots, dtype=torch.int64, device=keys.device)
               if slots else None)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    status = lib.oddeven_sort_launch(
        keys.data_ptr(), payload.data_ptr(), keys_out.data_ptr(),
        payload_out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        KEY_DTYPES.index(keys.dtype), B, D, stream)
    KERNEL.launches += 1
    _build.check_status(KERNEL, status)
    return keys_out, payload_out

"""Device resolution shared by the port's entry points.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (as the CPU tests do).  With no ``device`` and no card it
raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises without one); otherwise
    ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)

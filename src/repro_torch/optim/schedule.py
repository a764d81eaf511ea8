"""Learning-rate schedules: pure functions of the step counter.

Counterpart of ``repro.optim.schedule``.  Each schedule takes the int32
step *tensor* and computes in float32 on the step's device, so a training
step reads its learning rate without a host sync.
"""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return f


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(
            warmup_steps / torch.clamp_min(step, warmup_steps))
        return torch.where(step < warmup_steps, warm, decay)
    return f

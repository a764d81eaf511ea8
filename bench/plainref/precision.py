"""The precision a plain reference computes in.

``Float32`` is the reference: every weight read as float32, every product
in float32 with TF32 off.  ``Fp8`` is its control, the step below the
bfloat16 the configurations are served in: every matrix product takes its
weight and its input rounded to float8 e4m3 (a scale per weight column and
per input row, the usual fp8 GEMM recipe), accumulated in float32.  The
norms, softmax and recurrences stay in float32 in both.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to e4m3 with one scale per slice along
    ``dim``'s complement (the absolute maximum maps to 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Float32:
    name = "float32"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.to(torch.float32)

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for a float32 input and a weight from :meth:`weight`."""
        return x @ w


class Fp8(Float32):
    name = "fp8-e4m3"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        # a scale per output column: the reduction runs over dim 0
        return _fp8_round(w.to(torch.float32), dim=0)

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _fp8_round(x, dim=-1) @ w


PRECISIONS = {"float32": Float32, "fp8": Fp8}

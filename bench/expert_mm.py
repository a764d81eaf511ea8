"""The routed-expert product's work, for ``metrics/expert_mm_roofline.py``.

The product is the routed experts' SwiGLU over the rows routed to them:
a (token, expert) pair of a dropless MoE layer is one row, worked by its
expert's ``w_gate`` and ``w_up`` (D x F_e each) and ``w_down`` (F_e x D),
2 operations a weight.  Its least bytes are the experts it reads, each
once, and its rows in and out, once each, in the compute dtype: the
product's intermediate never has to leave the chip.  On the card the
program runs it as grouped GEMMs (``torch._grouped_mm``, CUTLASS's sm90
grouped kernel, and its setup kernel), found by name in the device trace.
"""

from __future__ import annotations

from bench import bounds

# the program's grouped GEMM on the card and the kernel that lays out its
# per-expert problems: the product's device time
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")
GEMM = "GroupProblemShape"
GEMMS_A_LAYER = 3           # gate, up, down


def is_product(kernel: str) -> bool:
    return any(k in kernel for k in KERNELS)


def moe_layers(cfg: dict) -> int:
    """The configuration's MoE layers (those after the leading dense ones,
    MoE every layer)."""
    if cfg.get("moe") is None:
        return 0
    return cfg["num_layers"] - cfg.get("first_dense_layers", 0)


def operations(cfg: dict, rows: int) -> float:
    """2 · 3 · D · F_e a routed row."""
    return 2.0 * 3 * cfg["d_model"] * cfg["moe"]["expert_d_ff"] * rows


def nbytes(cfg: dict, params: list, experts: int, rows: int) -> float:
    """``experts`` routed experts (summed over the layers) read once, and
    ``rows`` rows of D in and out."""
    _, expert = bounds.routed_experts(params)
    act = bounds.DTYPE_BYTES[cfg["compute_dtype"]]
    return experts * expert + 2.0 * rows * cfg["d_model"] * act


def least_ms(cfg: dict, params: list, experts: int, rows: int) -> float:
    """Least time (ms) of one product's run: its bytes at the memory rate
    or its operations at the bf16 rate, the larger."""
    return max(nbytes(cfg, params, experts, rows) / bounds.HBM_BYTES_PER_S,
               operations(cfg, rows) / bounds.BF16_OPS_PER_S) * 1e3

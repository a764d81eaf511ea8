"""The yardstick's arithmetic: the card's peaks, the least time of a decode
tick and of a mapping event, the model's operations, and the union of
device intervals.

``tick_bound``, ``event_bound`` (with ``bound``) and ``busy_us`` are frozen
copies of ``chip_smoke.py``'s ``tick_bound`` / ``event_bound`` and
``benchmarks/port/serve_tick_trace.py``'s ``busy_us``, as they stood when
this benchmark was written; they read the configuration's sizes from the
benchmark's own files instead of the program's ``cache_specs``.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _layers(cfg: dict) -> tuple[int, int]:
    """(attention layers, Mamba layers) of a configuration."""
    pattern = cfg.get("block_pattern", ["attn"])
    mamba = sum(pattern[i % len(pattern)] == "mamba"
                for i in range(cfg["num_layers"]))
    return cfg["num_layers"] - mamba, mamba


def cache_bytes(cfg: dict) -> tuple[int, int]:
    """(bytes of cache a token holds, bytes of state a lane holds): K and V
    of every attention layer in the compute dtype; the conv window (compute
    dtype) and the float32 ssm state of every Mamba layer."""
    attn, mamba = _layers(cfg)
    act = DTYPE_BYTES[cfg["compute_dtype"]]
    hd = cfg["d_model"] // cfg["num_heads"]
    per_token = attn * 2 * cfg["num_kv_heads"] * hd * act
    per_lane = 0
    if mamba:
        s = cfg["ssm"]
        per_lane = mamba * ((s["d_conv"] - 1) * s["d_inner"] * act
                            + s["d_inner"] * s["d_state"] * 4)
    return per_token, per_lane


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for the work: bytes moved (inputs once, outputs
    once) over the memory rate vs operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def event_bound(B: int, D: int, P: int, masked: bool) -> tuple[float, str]:
    """A mapping event: keys, exec, avail (and the mask) in; order,
    assignment, start, finish and avail out; an add and a compare per lane
    per step."""
    nbytes = 4 * B * D + 4 * B * D * P + 4 * B * P + (P if masked else 0)
    nbytes += 16 * B * D + 4 * B * P
    return bound(nbytes, 2 * B * D * P)


def tick_bound(cfg: dict, weight_bytes: int, kv_tokens: int,
               lanes: int) -> tuple[float, str]:
    """Least time (ms) for one decode tick: the weights read once (the
    embedding table only at the lanes' rows; ``weight_bytes`` counts them
    so), each lane's cached tokens up to its position read once and its new
    token's written once, each lane's Mamba state read and written once,
    the int32 tokens in and out; 2 operations a weight a lane, in bf16."""
    per_token, per_lane = cache_bytes(cfg)
    nbytes = (weight_bytes + per_token * (kv_tokens + lanes)
              + 2 * per_lane * lanes + 8 * lanes)
    params = weight_bytes / DTYPE_BYTES[cfg["param_dtype"]]
    ops = 2.0 * params * lanes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tick_weight_bytes(params: list, lanes: int, d_model: int) -> int:
    """Bytes of weights a tick reads: every weight but the embedding table,
    and the table's rows of the lanes' tokens.  ``params`` as the reference
    lists them: [(name, shape, dtype, init)]."""
    total = 0
    for name, shape, dtype, _ in params:
        n = math.prod(shape)
        if name == "embed":
            n = lanes * d_model
        total += n * DTYPE_BYTES[dtype]
    return total


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def token_flops(cfg: dict, params: list) -> tuple[float, float, float]:
    """(operations a token outside attention and the head, operations a
    token per key it attends to, operations of one row of logits).  The
    products count 2 a weight; attention 4 · heads · head size a key and
    layer (scores and the value sum); a Mamba layer adds its convolution
    (2 · K · d_inner) and its recurrence (7 · d_inner · N: the decay's
    product and exponential, the input term's two products, the state's
    product and sum, the readout's product and sum, less one)."""
    dense = 0.0
    for name, shape, _, _ in params:
        if name.startswith("layers.") and len(shape) == 2 \
                and not name.endswith(("conv_w", "A_log")):
            dense += 2.0 * math.prod(shape)
    attn, mamba = _layers(cfg)
    if mamba:
        s = cfg["ssm"]
        dense += mamba * (2 * s["d_conv"] * s["d_inner"]
                          + 7 * s["d_inner"] * s["d_state"])
    hd = cfg["d_model"] // cfg["num_heads"]
    per_key = 4.0 * cfg["num_heads"] * hd * attn
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"]
    return dense, per_key, head


def prefill_flops(cfg: dict, params: list, prompt_len: int) -> float:
    """A prefill of ``prompt_len`` tokens: every token through the layers,
    position p attending p + 1 keys, and one row of logits."""
    dense, per_key, head = token_flops(cfg, params)
    return (prompt_len * dense
            + per_key * prompt_len * (prompt_len + 1) / 2 + head)


def decode_flops(cfg: dict, params: list, tokens: int,
                 keys: int) -> float:
    """A tick producing ``tokens`` tokens that attend ``keys`` keys in all."""
    dense, per_key, head = token_flops(cfg, params)
    return tokens * (dense + head) + per_key * keys

"""The yardstick's arithmetic: the card's peaks, the least time of a decode
tick and of a mapping event, the model's operations, and the union of
device intervals.

``tick_bound``, ``event_bound`` (with ``bound``) and ``busy_us`` are frozen
copies of ``chip_smoke.py``'s ``tick_bound`` / ``event_bound`` and
``benchmarks/port/serve_tick_trace.py``'s ``busy_us``, as they stood when
this benchmark was written; they read the configuration's sizes from the
benchmark's own files instead of the program's ``cache_specs``.

The counts follow the published architecture, whatever implements it:
multi-head latent attention (``attn_type`` ``"mla"``, which states its
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim`` and
``v_head_dim``) caches its latent and rotary key, and works a key as the
unabsorbed attention does; of the stacked routed experts (weights with
``experts`` a part of their name, the experts on the first axis) a token
works ``top_k`` of ``num_experts``, and a decode tick reads the experts its
lanes routed to, which the caller counts.  ``first_dense_layers`` leading
layers are attention layers, as the program's ``layer_kind`` has them.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _layers(cfg: dict) -> tuple[int, int]:
    """(attention layers, Mamba layers) of a configuration: the leading
    ``first_dense_layers`` are attention, the rest follow the pattern."""
    pattern = cfg.get("block_pattern", ["attn"])
    first = cfg.get("first_dense_layers", 0)
    mamba = sum(pattern[(i - first) % len(pattern)] == "mamba"
                for i in range(first, cfg["num_layers"]))
    return cfg["num_layers"] - mamba, mamba


def _mla(cfg: dict) -> bool:
    return cfg.get("attn_type", "gqa") == "mla"


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def _routed(name: str) -> bool:
    """A leaf of the stacked routed experts."""
    return "experts" in name.split(".")


def routed_experts(params: list) -> tuple[int, int]:
    """(MoE layers, bytes of one routed expert of one layer) of a parameter
    list; (0, 0) where it has no routed experts."""
    per_layer = {}
    for name, shape, dtype, _ in params:
        if _routed(name):
            layer = name.split(".experts.")[0]
            per_layer[layer] = per_layer.get(layer, 0) + \
                math.prod(shape[1:]) * DTYPE_BYTES[dtype]
    sizes = set(per_layer.values())
    if len(sizes) > 1:
        raise ValueError(f"routed experts of unequal sizes: {per_layer}")
    return len(per_layer), sizes.pop() if sizes else 0


def cache_bytes(cfg: dict) -> tuple[int, int]:
    """(bytes of cache a token holds, bytes of state a lane holds): K and V
    of every attention layer in the compute dtype (under MLA the latent and
    the rotary key instead); the conv window (compute dtype) and the
    float32 ssm state of every Mamba layer."""
    attn, mamba = _layers(cfg)
    act = DTYPE_BYTES[cfg["compute_dtype"]]
    if _mla(cfg):
        latent = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
        per_token = attn * latent * act
    else:
        per_token = attn * 2 * cfg["num_kv_heads"] * _head_dim(cfg) * act
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


def tick_bound(cfg: dict, weight_bytes: int, kv_tokens: int, lanes: int,
               params: list | None = None,
               experts_read: int | None = None) -> tuple[float, str]:
    """Least time (ms) for one decode tick: the weights read once (the
    embedding table only at the lanes' rows, the routed experts only those
    read; ``weight_bytes`` counts them so), each lane's cached tokens up to
    its position read once and its new token's written once, each lane's
    Mamba state read and written once, the int32 tokens in and out; 2
    operations a weight a lane, in bf16, a lane working ``top_k`` routed
    experts a MoE layer.  A configuration with ``moe`` needs its
    ``params`` and the ``experts_read`` that ``weight_bytes`` counts."""
    per_token, per_lane = cache_bytes(cfg)
    nbytes = (weight_bytes + per_token * (kv_tokens + lanes)
              + 2 * per_lane * lanes + 8 * lanes)
    lane_bytes = weight_bytes
    if cfg.get("moe") is not None:
        if params is None or experts_read is None:
            raise ValueError("a MoE tick's bound needs the parameters and "
                             "the routed experts the tick read")
        layers, expert = routed_experts(params)
        lane_bytes += (layers * cfg["moe"]["top_k"] - experts_read) * expert
    ops = 2.0 * (lane_bytes / DTYPE_BYTES[cfg["param_dtype"]]) * lanes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tick_weight_bytes(params: list, lanes: int, d_model: int,
                      experts_read: int | None = None) -> int:
    """Bytes of weights a tick reads: every weight but the embedding table
    and the routed experts, the table's rows of the lanes' tokens, and the
    ``experts_read`` routed experts the lanes routed to, summed over the
    MoE layers (needed where ``params`` has routed experts).  ``params`` as
    the reference lists them: [(name, shape, dtype, init)]."""
    layers, expert = routed_experts(params)
    if layers and experts_read is None:
        raise ValueError("the parameters have routed experts: give the "
                         "experts the tick read")
    total = 0
    for name, shape, dtype, _ in params:
        if _routed(name):
            continue
        n = math.prod(shape)
        if name == "embed":
            n = lanes * d_model
        total += n * DTYPE_BYTES[dtype]
    if layers:
        total += experts_read * expert
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
    products count 2 a weight of the layers' matrices (2-D or stacked 3-D),
    the routed experts at ``top_k / num_experts``; attention 4 · heads ·
    head size a key and layer (scores and the value sum), under MLA 2 ·
    heads · (nope + rope) + 2 · heads · v_head (the published attention,
    however a decode absorbs it); a Mamba layer adds its convolution (2 · K
    · d_inner) and its recurrence (7 · d_inner · N: the decay's product and
    exponential, the input term's two products, the state's product and
    sum, the readout's product and sum, less one)."""
    dense = 0.0
    for name, shape, _, _ in params:
        if name.startswith("layers.") and len(shape) in (2, 3) \
                and not name.endswith(("conv_w", "A_log")):
            n = 2.0 * math.prod(shape)
            if _routed(name):
                n = n * cfg["moe"]["top_k"] / cfg["moe"]["num_experts"]
            dense += n
    attn, mamba = _layers(cfg)
    if mamba:
        s = cfg["ssm"]
        dense += mamba * (2 * s["d_conv"] * s["d_inner"]
                          + 7 * s["d_inner"] * s["d_state"])
    H = cfg["num_heads"]
    if _mla(cfg):
        qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        per_key = (2.0 * H * qk + 2.0 * H * cfg["v_head_dim"]) * attn
    else:
        per_key = 4.0 * H * _head_dim(cfg) * attn
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

"""Percentiles, rates, the bounds and the operation counts, on numbers
worked by hand."""

import json
import math
from pathlib import Path

import pytest

from bench import bounds, stats
from bench.plainref import llama, mamba1
from bench.tests.smoke import MLA_MOE

BENCH = Path(__file__).resolve().parents[1]

DEEPSEEK = {"num_layers": 30, "d_model": 4096, "num_heads": 32,
            "num_kv_heads": 32, "d_ff": 11008, "vocab_size": 102400,
            "norm_eps": 1e-6, "rope_theta": 10000.0,
            "param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
MAMBA = {"num_layers": 64, "d_model": 4096, "num_heads": 1, "num_kv_heads": 1,
         "d_ff": 0, "vocab_size": 65024, "block_pattern": ["mamba"],
         "norm_eps": 1e-5, "ssm": {"d_inner": 8192, "d_state": 16,
                                   "d_conv": 4, "dt_rank": 256, "chunk": 16,
                                   "bcdt_rms": True},
         "param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def test_percentiles_exact():
    xs = list(range(1, 101))              # 1 .. 100
    assert stats.percentile(xs, 50) == 50.5
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([], 95) is None


def test_gaps_and_rate_with_a_stall():
    # two requests; request b stalls 2 s between its 2nd and 3rd token
    times = {"a": [(0.1, 1), (0.2, 1), (0.3, 1), (0.4, 1)],
             "b": [(0.15, 1), (0.25, 1), (2.25, 1), (2.35, 1)]}
    gaps = sorted(stats.token_gaps(times, 0.12, 2.5))
    # a: three gaps end in the window; b: its 2nd..4th tokens
    assert len(gaps) == 6
    assert gaps[-1] == pytest.approx(2.0)
    # five gaps of 0.1 s and the stall: rank 0.95 * 5 = 4.75
    assert stats.percentile(gaps, 95) == pytest.approx(0.1 + 0.75 * 1.9)
    assert stats.tokens_in_window(times, 0.12, 2.5) == 7
    assert stats.rate(7, 0.12, 2.5) == pytest.approx(7 / 2.38)
    # the stall's tokens left out of a window that closes before them
    assert stats.tokens_in_window(times, 0.12, 2.0) == 5


def test_cache_bytes_by_hand():
    # deepseek-7b: 30 layers x (K and V) x 32 heads x 128 x 2 bytes
    assert bounds.cache_bytes(DEEPSEEK) == (491_520, 0)
    # falcon-mamba-7b: 64 x (3 x 8192 x 2 + 8192 x 16 x 4)
    assert bounds.cache_bytes(MAMBA) == (0, 64 * (49_152 + 524_288))


def test_tick_bound_by_hand():
    lanes, keys = 8, 1000
    params = llama.parameters(DEEPSEEK)
    wb = bounds.tick_weight_bytes(params, lanes, 4096)
    n_params = sum(math.prod(s) for _, s, _, _ in params)
    f32 = sum(math.prod(s) for _, s, d, _ in params if d == "float32")
    assert n_params == 6_910_365_696
    assert wb == 2 * (n_params - f32 - 102_400 * 4096 + 8 * 4096) + 4 * f32
    ms, by = bounds.tick_bound(DEEPSEEK, wb, keys, lanes)
    nbytes = wb + 491_520 * (keys + lanes) + 8 * lanes
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_event_bound_by_hand():
    # B=1, D=8, P=3: bytes 32 + 96 + 12 + 3 + 128 + 12 = 283; ops 48
    ms, by = bounds.event_bound(1, 8, 3, True)
    assert by == "bytes" and ms == pytest.approx(283 / 3.35e12 * 1e3)


def test_flops_by_hand():
    params = llama.parameters(DEEPSEEK)
    dense, per_key, head = bounds.token_flops(DEEPSEEK, params)
    layer = 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert dense == 2.0 * 30 * layer
    assert per_key == 4.0 * 4096 * 30
    assert head == 2.0 * 4096 * 102400
    # a 3-token prefill attends 1 + 2 + 3 keys
    assert bounds.prefill_flops(DEEPSEEK, params, 3) == \
        3 * dense + 6 * per_key + head
    assert bounds.decode_flops(DEEPSEEK, params, 2, 10) == \
        2 * (dense + head) + 10 * per_key
    mp = mamba1.parameters(MAMBA)
    dense, per_key, _ = bounds.token_flops(MAMBA, mp)
    layer = 4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
    assert per_key == 0
    assert dense == 64 * (2.0 * layer + 2 * 4 * 8192 + 7 * 8192 * 16)


def test_busy_union():
    assert bounds.busy_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20



def _mla_moe_params():
    """``MLA_MOE``'s weights as a reference lists them (the program's
    names), float32: per layer the latent projections, the query's latent,
    the output; a dense first layer's SwiGLU, then the router, 8 stacked
    routed experts and 2 shared ones (one SwiGLU of 96)."""
    f, n = "float32", ("normal", 0.02)
    out = [("embed", (160, 64), f, n), ("final_norm", (64,), f, n),
           ("lm_head", (64, 160), f, n)]
    for i in range(3):
        p = f"layers.{i}."
        out += [(p + "norm_1", (64,), f, n), (p + "norm_2", (64,), f, n),
                (p + "mixer.w_dkv", (64, 32), f, n),
                (p + "mixer.kv_norm", (32,), f, n),
                (p + "mixer.w_kr", (64, 8), f, n),
                (p + "mixer.w_uk", (32, 4, 16), f, n),
                (p + "mixer.w_uv", (32, 4, 16), f, n),
                (p + "mixer.wo", (64, 64), f, n),
                (p + "mixer.w_dq", (64, 48), f, n),
                (p + "mixer.q_norm", (48,), f, n),
                (p + "mixer.w_uq", (48, 4, 24), f, n)]
        if i == 0:
            out += [(p + "ffn.w_gate", (64, 192), f, n),
                    (p + "ffn.w_up", (64, 192), f, n),
                    (p + "ffn.w_down", (192, 64), f, n)]
        else:
            out += [(p + "ffn.router", (64, 8), f, n),
                    (p + "ffn.experts.w_gate", (8, 64, 48), f, n),
                    (p + "ffn.experts.w_up", (8, 64, 48), f, n),
                    (p + "ffn.experts.w_down", (8, 48, 64), f, n),
                    (p + "ffn.shared.w_gate", (64, 96), f, n),
                    (p + "ffn.shared.w_up", (64, 96), f, n),
                    (p + "ffn.shared.w_down", (96, 64), f, n)]
    return out


def test_mla_moe_cache_and_flops_by_hand():
    params = _mla_moe_params()
    # 3 attention layers x (latent 32 + rotary key 8) x 4 bytes
    assert bounds.cache_bytes(MLA_MOE) == (480, 0)
    dense, per_key, head = bounds.token_flops(MLA_MOE, params)
    attn = 64 * 32 + 64 * 8 + 2 * 32 * 4 * 16 + 64 * 64 + 64 * 48 \
        + 48 * 4 * 24                                   # 18,432 a layer
    first = 3 * 64 * 192                                # the dense layer
    moe = 64 * 8 + 3 * 64 * 48 * 2 + 3 * 64 * 96        # top 2 of 8
    assert dense == 2.0 * (3 * attn + first + 2 * moe) == 333_824
    # scores over nope + rope, values over v_head: 2·4·24 + 2·4·16 a layer
    assert per_key == 3 * (2 * 4 * 24 + 2 * 4 * 16) == 960
    assert head == 2.0 * 64 * 160
    assert bounds.prefill_flops(MLA_MOE, params, 3) == \
        3 * dense + 6 * per_key + head
    assert bounds.decode_flops(MLA_MOE, params, 2, 10) == \
        2 * (333_824 + 20_480) + 9_600


def test_mla_moe_tick_by_hand():
    params = _mla_moe_params()
    assert bounds.routed_experts(params) == (2, 3 * 64 * 48 * 4)
    with pytest.raises(ValueError, match="experts"):
        bounds.tick_weight_bytes(params, 4, 64)
    # everything but the embedding and the routed experts, 4 rows of the
    # embedding, and 5 experts read (say 3 in layer 1, 2 in layer 2)
    rest = 64 + 64 * 160 + (208 + 18_432 + 3 * 64 * 192) \
        + 2 * (208 + 18_432 + 64 * 8 + 3 * 64 * 96)
    wb = bounds.tick_weight_bytes(params, 4, 64, experts_read=5)
    assert wb == 4 * (rest + 4 * 64) + 5 * 36_864 == 749_248
    with pytest.raises(ValueError, match="experts"):
        bounds.tick_bound(MLA_MOE, wb, 100, 4)
    ms, by = bounds.tick_bound(MLA_MOE, wb, 100, 4, params=params,
                               experts_read=5)
    assert by == "bytes"
    assert ms == pytest.approx((wb + 480 * 104 + 8 * 4) / 3.35e12 * 1e3)
    # with many lanes the operations bind: each lane works 2 experts of
    # each of the 2 MoE layers, whatever the tick read
    lanes = 4096
    wb = bounds.tick_weight_bytes(params, lanes, 64, experts_read=16)
    ms, by = bounds.tick_bound(MLA_MOE, wb, 0, lanes, params=params,
                               experts_read=16)
    lane = wb - 16 * 36_864 + 2 * 2 * 36_864
    assert by == "operations"
    assert ms == pytest.approx(2 * lanes * lane / 4 / 989e12 * 1e3)


@pytest.mark.parametrize("name, ref, want", [
    ("deepseek-7b", llama,
     ((491520, 0), (12142510080.0, 491520.0, 838860800.0), 12982435840,
      (4.610139720597015, "bytes"), 9584132587520.0, 106308567040.0)),
    ("falcon-mamba-7b", mamba1,
     ((0, 36700160), (13518241792.0, 0.0, 532676608.0), 14033174528,
      (4.3642916871641795, "bytes"), 10504206548992.0, 112407347200.0)),
])
def test_existing_configs_count_as_before(name, ref, want):
    """The configuration files' counts, bitwise as they were before MLA
    and MoE were counted (8 lanes, 5000 keys, a 777-token prefill)."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]
    params = ref.parameters(cfg)
    wb = bounds.tick_weight_bytes(params, 8, cfg["d_model"])
    got = (bounds.cache_bytes(cfg), bounds.token_flops(cfg, params), wb,
           bounds.tick_bound(cfg, wb, 5000, 8),
           bounds.prefill_flops(cfg, params, 777),
           bounds.decode_flops(cfg, params, 8, 5000))
    assert got == want

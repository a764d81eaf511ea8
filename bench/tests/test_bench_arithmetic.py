"""Percentiles, rates, the bounds and the operation counts, on numbers
worked by hand."""

import math

import pytest

from bench import bounds, stats
from bench.plainref import llama, mamba1

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


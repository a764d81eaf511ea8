"""The traffic generator: deterministic from the seed, the stated laws."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench.generators import tick_poisson as tp

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = {p.stem: json.loads(p.read_text())
           for p in (BENCH / "configs").glob("*.json")}
TRAFFIC = {p.stem: json.loads(p.read_text())
           for p in (BENCH / "traffic").glob("*.json")}
CELL = {"rate": 0.5, "speeds": [1.0, 0.7, 1.4]}
BIG = 2 ** 31 + 12345


def _gen(mix, conf, seed, rate=0.5):
    return tp.generate(TRAFFIC[mix], dict(CELL, rate=rate), CONFIGS[conf],
                       seed, fill=24)


@pytest.mark.parametrize("mix", sorted(TRAFFIC))
@pytest.mark.parametrize("conf", sorted(CONFIGS))
def test_same_seed_same_schedule_other_seed_same_sizes(mix, conf):
    a, b = _gen(mix, conf, BIG), _gen(mix, conf, BIG)
    assert a["arrival_ticks"] == b["arrival_ticks"]
    assert all(np.array_equal(p, q) and n == m for (p, n), (q, m)
               in zip(a["requests"], b["requests"]))
    c = _gen(mix, conf, BIG + 1)
    assert c["arrival_ticks"] != a["arrival_ticks"]
    # stratified: the same multiset of sizes in the fill and in every
    # whole block after it
    block = TRAFFIC[mix]["block"]
    n = 24 + (min(len(a["requests"]), len(c["requests"])) - 24) \
        // block * block
    for lo, hi in ((0, 24), (24, n)):
        for i in (0, 1):
            sa, sc = ([len(p) if i == 0 else o for p, o in s["requests"][lo:hi]]
                      for s in (a, c))
            assert sorted(sa) == sorted(sc)


def test_long_context_laws():
    conf, mix = CONFIGS["deepseek-7b"], TRAFFIC["long-context"]
    s = _gen("long-context", "deepseek-7b", 3)
    prompts = np.array([len(p) for p, _ in s["requests"]])
    outputs = np.array([o for _, o in s["requests"]])
    assert prompts.min() >= 128 and prompts.max() <= 1536
    assert outputs.min() >= 32 and outputs.max() <= 256
    # log-uniform outputs: mean (256 - 32) / ln 8
    assert abs(outputs.mean() - 224 / np.log(8)) < 1.5
    # prompts above 512 are whole multiples of 512 (the prefill's chunks)
    assert np.all((prompts <= 512) | (prompts % 512 == 0))
    assert all(p + o <= mix["max_len"] for p, o in zip(prompts, outputs))
    assert all(0 <= t.min() and t.max() < conf["model"]["vocab_size"]
               for t, _ in s["requests"])
    mamba = _gen("long-context", "falcon-mamba-7b", 3)
    assert all(len(p) % 16 == 0 for p, _ in mamba["requests"])


def test_launcher_burst_laws():
    s = _gen("launcher-burst", "deepseek-7b", 5, rate=1.2)
    prompts = np.array([len(p) for p, _ in s["requests"]])
    assert prompts.min() == 8 and prompts.max() == 47
    assert abs(prompts.mean() - 27.5) < 0.3
    assert {o for _, o in s["requests"]} == {16}
    m = _gen("launcher-burst", "falcon-mamba-7b", 5, rate=1.2)
    assert set(len(p) for p, _ in m["requests"]) <= \
        set(range(8, 17)) | {32, 48}


def test_opening_fill_and_rates():
    ticks = np.array(_gen("long-context", "deepseek-7b", 9, rate=0.2)
                     ["arrival_ticks"])
    assert np.sum(ticks == 0) == 24 and np.all(ticks[24:] >= 1)
    horizon = TRAFFIC["long-context"]["horizon"]
    assert abs(np.sum(ticks >= 1) / horizon - 0.2) < 0.01
    burst = np.array(_gen("launcher-burst", "deepseek-7b", 9, rate=1.0)
                     ["arrival_ticks"][24:])
    phase = (burst - 1) % 30
    assert np.all(phase < 10)                      # nothing in the lulls
    assert abs(len(burst) / TRAFFIC["launcher-burst"]["horizon"] - 1.0) < 0.03


def test_prefill_length_rule():
    assert [tp.prefill_length(n, 16) for n in (8, 16, 17, 32, 33)] == \
        [8, 16, 32, 32, 48]
    assert tp.prefill_length(513, 512) == 1024


def test_warmup_covers_the_extremes():
    w = tp.warmup(TRAFFIC["long-context"], CONFIGS["deepseek-7b"], 1)
    lens = [len(p) for p, _ in w["requests"]]
    assert min(lens) == 128 and max(lens) == 1536
    assert w["arrival_ticks"][:2] == [0, 0] and 1 in w["arrival_ticks"]

"""The harness end to end on the CPU at smoke widths: a sound run comes out
correct, and each fault a serving cell can have, planted under the timed
path, makes ``correct`` false, for every model reference under
``bench/plainref/``.  (The harness's look for a card is skipped: these
call ``result.measure`` with ``device="cpu"``.)"""

import time

import pytest
import torch

from bench import result
from bench.tests.smoke import cell, references

SECONDS = 2.0


def measure(spec, seed=2 ** 31 + 7):
    torch.set_num_threads(1)
    return result.measure(spec, seed, SECONDS, False, "cpu",
                          time.perf_counter())


@pytest.mark.parametrize("reference", references())
def test_sound_run_is_correct(reference):
    line = measure(cell(reference))
    assert line["correct"], line["checks"]
    assert line["checks"]["logit_gap"]["value"] <= 1e-3
    assert line["checked"]["decisions"] > 0
    assert line["checked"]["tokens"] >= 20
    m = line["metrics"]
    assert set(m) == {"output_tokens_per_s", "itl_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert list(line)[-1] == "checks"


def test_traced_run_reads_the_program_spans():
    line = result.measure(cell("llama", trace=True), 3, SECONDS, True, "cpu",
                          time.perf_counter())
    m = line["metrics"]
    for name in ("tick_ms", "admit_ms", "admit_ms.tokens", "tick_roofline",
                 "serve_mfu", "token_gap_p95_ms"):
        assert m[name]["value"] > 0, name
    assert m["admit_ms.tokens"] == m["admit_ms"]
    assert 0 < m["tick_roofline"]["value"] < 100
    # no card: no device trace, so no device metric is made up
    assert "device_idle_pct" not in m and "fused_decision_roofline" not in m


def _stale_state(orig):
    def tick(self, ints):
        saved = {k: v.clone() for k, v in self.pool.pools.items()}
        toks = orig(self, ints)
        for k, v in saved.items():
            self.pool.pools[k].copy_(v)
        return toks
    return tick


def _half_batch(orig):
    def tick(self, ints):
        toks = orig(self, ints).clone()
        lanes, pp = self.engine.lanes, self.pool.pages_per_slot
        given = ints[lanes * (pp + 1):lanes * (pp + 2)]
        toks[lanes // 2:] = given[lanes // 2:]     # left undecoded
        return toks
    return tick


def _altered_token(orig):
    def tick(self, ints):
        toks = orig(self, ints).clone()
        toks[0] = (toks[0] + 1) % self.engine.cfg.vocab_size
        return toks
    return tick


TICK_FAULTS = {"state_unchanged": _stale_state, "half_batch": _half_batch,
               "token_altered": _altered_token}


@pytest.mark.parametrize("reference", references())
@pytest.mark.parametrize("fault", sorted(TICK_FAULTS))
def test_planted_tick_fault_is_not_correct(monkeypatch, fault, reference):
    from repro_torch.serve import paging
    monkeypatch.setattr(paging.PagedRuntime, "_tick",
                        TICK_FAULTS[fault](paging.PagedRuntime._tick))
    line = measure(cell(reference))
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > 1e-3


def test_altered_decision_is_not_correct(monkeypatch):
    from repro_torch.serve import paging
    orig = paging.decision_hw

    def decision(*args, **kw):
        res = orig(*args, **kw)
        a = res.assignment.clone()
        a[0] = (a[0] + 1) % 3
        return res._replace(assignment=a)

    monkeypatch.setattr(paging, "decision_hw", decision)
    line = measure(cell("llama"))
    assert not line["correct"]
    assert line["checks"]["decisions_differing"]["value"] > 0

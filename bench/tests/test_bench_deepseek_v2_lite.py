"""The deepseek-v2-lite configuration on the benchmark's CPU tests: its
file, its plain reference (``plainref/deepseek_v2.py``, whose small size is
``SMALL``), a small cell of it served through the harness with the
configuration's ``program_builder``, and the two readers it adds
(``tick_roofline.moe``, ``expert_mm_roofline``).  The reference's
``SMALL`` is not named ``SMOKE``, so the tests that find references by
that name do not run it; the checks they would make are here."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import expert_mm, harness, result
from bench.generators import tick_poisson as tp
from bench.plainref import deepseek_v2 as ref
from bench.plainref.precision import Float32, Fp8
from bench.spec import CellSpec, load_cell, metric_reader, program_config
from bench.tests.smoke import MLA_MOE, TRAFFIC, cell
from bench.tests.test_bench_isolation import FORBIDDEN, _loaded
from bench.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]
NAME = "deepseek-v2-lite"
WORKLOAD = "deepseek-v2-lite.long-context-8k"
READERS = ("tick_roofline.moe", "expert_mm_roofline")
SECONDS = 2.0


def _file() -> dict:
    return json.loads((BENCH / "configs" / f"{NAME}.json").read_text())


def small_cell(*, trace=False, limit=1e-3) -> CellSpec:
    """The configuration's file with its model at ``SMALL``, the smoke
    traffic at 16 lanes."""
    conf = dict(_file(), name="small-" + NAME, model=ref.SMALL,
                prefill_multiple=512)
    return CellSpec(name="small-" + NAME, config=conf,
                    traffic=dict(TRAFFIC, lanes=16, max_len=64),
                    cell={"rate": 2.0, "speeds": [1.0, 0.7, 1.4],
                          "limits": {"logit_gap": limit,
                                     "decisions_differing": 0}},
                    metrics=load_cell(WORKLOAD, trace).metrics)


def test_file_is_the_published_model_at_full_width():
    """Every width as published, nothing reduced; the program's parameters
    (on the meta device) are the reference's list, name for name."""
    from repro_torch.configs import deepseek_v2_lite as lite
    from repro_torch.models.model import param_specs
    f = _file()
    assert f["reduced"] == [] and f["published"]["num_hidden_layers"] == 27
    cfg = program_config(f)
    assert cfg == lite.CONFIG
    pub = f["published"]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size,
            cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.first_dense_d_ff) == \
        (pub["num_hidden_layers"], pub["hidden_size"],
         pub["num_attention_heads"], pub["vocab_size"], pub["kv_lora_rank"],
         pub["qk_nope_head_dim"], pub["qk_rope_head_dim"],
         pub["v_head_dim"], pub["intermediate_size"])
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_d_ff,
            cfg.moe.num_shared_experts, cfg.moe.capacity_factor) == \
        (pub["n_routed_experts"], pub["num_experts_per_tok"],
         pub["moe_intermediate_size"], pub["n_shared_experts"], None)
    assert cfg.norm_topk_prob is pub["norm_topk_prob"] is False
    assert cfg.routed_scaling_factor == pub["routed_scaling_factor"]
    s = pub["rope_scaling"]
    assert (cfg.rope_scaling.factor, cfg.rope_scaling.mscale_all_dim,
            cfg.rope_scaling.original_max_position_embeddings) == \
        (s["factor"], s["mscale_all_dim"],
         s["original_max_position_embeddings"])
    for key, value in pub.items():       # the catalog's keys, top level
        assert f[key] == value, key
    want = {n: (tuple(s), d) for n, s, d, _ in ref.parameters(f["model"])}
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for n, p in param_specs(cfg).named_parameters()}
    assert got == want
    total = sum(int(np.prod(s)) for s, _ in want.values())
    assert 15.6e9 < total < 15.8e9                 # 15.7 B as published


def test_reference_unbatched_equals_batched_and_fp8_differs():
    """As ``test_bench_reference`` checks every found reference: one row
    against a padded batch, at ``SMALL`` and with a query latent (the
    236B smoke's MLA, dropless here)."""
    latent_q = dict(MLA_MOE, norm_eps=1e-6, rope_theta=10000.0,
                    moe=dict(MLA_MOE["moe"], capacity_factor=None))
    for cfg in (ref.SMALL, latent_q):
        w = make_weights(ref.parameters(cfg), 11, "cpu")
        g = torch.Generator().manual_seed(3)
        lens = [9, 30, 4]
        toks = torch.randint(0, cfg["vocab_size"], (3, max(lens)),
                             generator=g)
        for b, n in enumerate(lens):
            toks[b, n:] = 0
        batch = ref.hidden(w, toks, cfg, Float32())
        for b, n in enumerate(lens):
            one = ref.hidden(w, toks[b:b + 1, :n], cfg, Float32())
            torch.testing.assert_close(batch[b, :n], one[0], atol=1e-5,
                                       rtol=1e-5)
        lg = ref.logits(w, batch[:, -1], cfg, Float32())
        low = ref.logits(w, ref.hidden(w, toks, cfg, Fp8())[:, -1], cfg,
                         Fp8())
        assert lg.shape == (3, cfg["vocab_size"])
        assert (lg - low).abs().max() > 1e-3


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import bench.plainref.deepseek_v2, bench.expert_mm")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_small_cell_is_correct_and_reads_the_moe_tick():
    torch.set_num_threads(1)
    line = result.measure(small_cell(trace=True), 2 ** 31 + 28, SECONDS,
                          True, "cpu", time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["checks"]["logit_gap"]["value"] <= 1e-3
    assert line["checked"]["tokens"] >= 20
    m = line["metrics"]
    assert set(m) == {"tick_roofline.moe"}   # no device trace on the CPU
    assert 0 < m["tick_roofline.moe"]["value"] < 100


def test_planted_token_fault_is_not_correct(monkeypatch):
    from repro_torch.serve import paging
    orig = paging.PagedRuntime._tick

    def tick(self, ints):
        toks = orig(self, ints).clone()
        toks[0] = (toks[0] + 1) % self.engine.cfg.vocab_size
        return toks

    monkeypatch.setattr(paging.PagedRuntime, "_tick", tick)
    torch.set_num_threads(1)
    line = result.measure(small_cell(), 2 ** 31 + 29, SECONDS, False, "cpu",
                          time.perf_counter())
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > 1e-3


@pytest.mark.parametrize("reference", ["llama", "mamba1"])
def test_new_readers_read_nothing_without_routed_experts(reference):
    torch.set_num_threads(1)
    run, _ = harness.execute(cell(reference, trace=True), 2 ** 31 + 5, 1.0,
                             True, "cpu", time.perf_counter())
    run.profile = {"kernel_s": {}, "launches": {}, "busy_s": 0.0,
                   "window_s": 1.0}
    run.prof_window = (run.window_start, run.window_end)
    for name in READERS:
        assert metric_reader(name)(run) is None, name


def test_expert_mm_reader_on_a_planted_device_trace():
    """The reader's arithmetic on a traced small run with a device trace
    planted around its sub-window: the least time of its ticks and
    admissions over the kernels' time; None where a launch is missing."""
    torch.set_num_threads(1)
    run, _ = harness.execute(small_cell(trace=True), 2 ** 31 + 30, SECONDS,
                             True, "cpu", time.perf_counter())
    cfg = run.spec.model
    t0, t1 = run.window_start, run.window_end
    ticks = [a for s, d, a in run.spans["engine.decode_tick"]
             if t0 <= s and s + d <= t1 and a["active"] > 0]
    admits = [a for s, d, a in run.spans["engine.admit"]
              if t0 <= s and s + d <= t1 and "rows" in a]
    assert ticks and admits
    layers = expert_mm.moe_layers(cfg)
    assert layers == 2
    least = sum(expert_mm.least_ms(cfg, run.params, a["experts"],
                                   a["active"] * 2 * layers) for a in ticks)
    least += sum(expert_mm.least_ms(cfg, run.params, a["experts"],
                                    a["rows"]) for a in admits)
    gemm = "cutlass::device_kernel<GroupProblemShape>"
    launches = 3 * layers * (len(ticks) + len(admits))
    run.prof_window = (t0, t1)
    run.profile = {"kernel_s": {gemm: 0.004, "prepare_grouped_gemm_data":
                                0.001, "other": 9.0},
                   "launches": {gemm: launches,
                                "prepare_grouped_gemm_data": launches,
                                "other": 1}}
    read = metric_reader("expert_mm_roofline")
    assert read(run) == pytest.approx(100 * least / 5.0)
    run.profile["launches"][gemm] -= 1
    assert read(run) is None


def test_expert_mm_counts_by_hand():
    # DeepSeek-V2-Lite: an expert 3 x 2048 x 1408 bf16 weights, 17.3 MB
    f = _file()
    params = ref.parameters(f["model"])
    cfg = f["model"]
    assert expert_mm.moe_layers(cfg) == 26
    assert expert_mm.operations(cfg, 1) == 2 * 3 * 2048 * 1408
    assert expert_mm.nbytes(cfg, params, 51, 96) == \
        51 * 3 * 2048 * 1408 * 2 + 2 * 96 * 2048 * 2
    # 16 lanes x 6 rows x 26 layers, 51 x 26 experts: bound by bytes
    ms = expert_mm.least_ms(cfg, params, 51 * 26, 96 * 26)
    assert ms == pytest.approx((51 * 26 * 17_301_504 + 2 * 96 * 26 * 4096)
                               / 3.35e12 * 1e3)


def test_long_context_8k_laws_and_cell():
    spec = load_cell(WORKLOAD, False)
    assert spec.chips == 1 and spec.traffic["lanes"] == 16
    assert {m["name"] for m in spec.metrics} == {"output_tokens_per_s",
                                                 "setup_s"}
    assert {m["name"] for m in load_cell(WORKLOAD, True).metrics} == \
        set(READERS)
    s = tp.generate(spec.traffic, spec.cell, spec.config, 2 ** 31 + 1,
                    fill=48)
    prompts = np.array([len(p) for p, _ in s["requests"]])
    outputs = np.array([o for _, o in s["requests"]])
    assert prompts.min() >= 1024 and prompts.max() <= 8192
    assert np.all(prompts % 512 == 0)
    assert outputs.min() >= 64 and outputs.max() <= 512
    assert np.all(prompts + outputs <= spec.traffic["max_len"])
    # the sample holds at least 6 requests whatever their lengths
    assert spec.traffic["sample_tokens"] > 5 * 512

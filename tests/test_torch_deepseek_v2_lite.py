"""DeepSeek-V2-Lite on the port's served path, at the builder's smoke widths
on the CPU: YaRN on MLA's rotary dims, dropless routed experts, and the
routed-expert counts a tick and an admission carry.

* the builder's smoke (``configs/deepseek_v2_lite.py``) built through the
  benchmark's configuration contract (``bench.spec.program_config``);
* served paged through ``HeftFrontEnd.run_continuous(fused=True)`` on three
  replicas of 16 lanes: every prefill's and every tick lane's logits
  against the plain float32 reference's full forward over the served
  sequence (``bench/plainref/deepseek_v2.py``), on the same seeded weights;
* a lane's logits at 16 lanes whatever batch-mates share the step, bitwise
  (the row-by-row expert product), and paged == the dense ``generate``;
* YaRN's frequencies and scales against the reference's, at the smoke's
  and the published rope dims;
* each tick's ``experts`` and each admission's ``experts`` / ``rows`` span
  args against a count from the routing itself;
* the grouped product's device-offset convention against
  ``torch._grouped_mm`` where this PyTorch runs it on the CPU.

The logits agree to 2e-5 (f32 throughout on both sides: the program's
absorbed decode and chunked prefill reassociate the reference's sums,
~1e-6 on logits of ~0.5).  A card test (``-m cuda``) holds the graphed
tick, bfloat16 and the grouped GEMM, to the eager tick bit for bit.
Nothing here imports JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.plainref import deepseek_v2 as ref  # noqa: E402
from bench.plainref.precision import Float32  # noqa: E402
from bench.spec import program_config  # noqa: E402
from bench.weights import make_weights  # noqa: E402
from repro_torch.configs import deepseek_v2_lite as lite  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import (YaRN, yarn_frequencies,  # noqa: E402
                                       yarn_scales)
from repro_torch.models.model import decode_step, prefill_step  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.sched_integration import MappingFabric  # noqa: E402
from repro_torch.serve import (HeftFrontEnd, ReplicaHandle,  # noqa: E402
                               ServeEngine)

PROGRAM_ONLY = ["rope_scaling", "moe.norm_topk_prob",
                "moe.routed_scaling_factor"]
BUILDER = "repro_torch.configs.deepseek_v2_lite:build"
LANES = 16
TOL = dict(atol=2e-5, rtol=2e-5)
_CACHE: dict = {}


def _config(model=None, name="small"):
    return program_config({"name": name, "model": model or ref.SMALL,
                           "program_only": PROGRAM_ONLY,
                           "program_builder": BUILDER})


def _setup():
    """(config, the reference's weights, the program's parameters holding
    the same tensors)."""
    if "setup" not in _CACHE:
        from bench.harness import program_params
        cfg = _config()
        w = make_weights(ref.parameters(ref.SMALL), 2 ** 31 + 28, "cpu")
        _CACHE["setup"] = cfg, w, program_params(cfg, w)
    return _CACHE["setup"]


def _requests(n, seed, vocab=160):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 40)))
             .astype(np.int32), int(rng.integers(2, 9))) for _ in range(n)]


def _reference_logits(w, seq):
    toks = torch.from_numpy(np.asarray(seq, dtype=np.int64))[None]
    with torch.no_grad():
        h = ref.hidden(w, toks, ref.SMALL, Float32())
        return ref.logits(w, h[0], ref.SMALL, Float32())


def test_smoke_builds_through_the_configuration_contract():
    cfg = _config(name="deepseek-v2-lite-smoke")
    assert cfg == lite.smoke()
    assert isinstance(cfg, lite.DeepseekV2Config)
    assert cfg.moe.capacity_factor is None and moe_mod.dropless(cfg)
    assert cfg.norm_topk_prob is False and cfg.routed_scaling_factor == 1.5
    assert cfg.rope_scaling == YaRN(40, 16, 32, 1, 0.707, 0.707)
    assert (cfg.q_lora_rank, cfg.first_dense_layers, cfg.moe.num_experts,
            cfg.moe.top_k, cfg.moe.num_shared_experts) == (0, 1, 8, 2, 2)
    full = _config(lite.MODEL, "deepseek-v2-lite")
    assert full == lite.CONFIG


@pytest.mark.parametrize("d, scaling", [
    (8, ref.SMALL["rope_scaling"]),
    (64, lite.MODEL["rope_scaling"]),
])
def test_yarn_frequencies_and_scales_are_the_references(d, scaling):
    cfg = dict(ref.SMALL, rope_scaling=scaling)
    inv, cos_sin, soft = ref.yarn(cfg, d, "cpu")
    s = _config(cfg).rope_scaling
    torch.testing.assert_close(yarn_frequencies(d, 10000.0, s), inv,
                               atol=0, rtol=1e-6)
    assert yarn_scales(s) == pytest.approx((cos_sin, soft), rel=1e-12)
    # DeepSeek-V2-Lite: mscale = 0.1·0.707·ln 40 + 1, cos / sin unscaled
    assert soft == pytest.approx((0.1 * 0.707 * np.log(40) + 1) ** 2)
    assert cos_sin == 1.0
    # interpolated at the low end, the published frequencies at the top
    base = 1.0 / 10000.0 ** (torch.arange(0, d, 2) / d)
    assert float(inv[0]) == pytest.approx(float(base[0]))
    assert float(inv[-1]) == pytest.approx(float(base[-1]) / 40)


def _serve(reqs, arrivals, record):
    """``reqs`` through ``run_continuous(fused=True)`` on three replicas of
    16 lanes, recording every prefill's and tick's logits."""
    cfg, _, params = _setup()
    orig_prefill, orig_decode = ServeEngine._prefill, ServeEngine._decode

    def prefill(self, tokens):
        logits, caches = orig_prefill(self, tokens)
        record.append(("prefill", tokens[0].numpy().copy(),
                       logits[0].clone()))
        return logits, caches

    def decode(self, caches, tok, pos):
        logits, caches = orig_decode(self, caches, tok, pos)
        rt = self.paged
        lanes = [(rt.slots[s].prompt, len(rt.slots[s].tokens))
                 for s in rt.active_slots()]
        record.append(("tick", lanes, logits.clone()))
        return logits, caches

    fleet = [ReplicaHandle(f"r{i}", ServeEngine(cfg, params, max_len=64,
                                                lanes=LANES), speed=s)
             for i, s in enumerate((1.0, 0.7, 1.4))]
    front = HeftFrontEnd(fleet, fabric=MappingFabric(3, backend="fused",
                                                     device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ServeEngine, "_prefill", prefill)
        mp.setattr(ServeEngine, "_decode", decode)
        out, _ = front.run_continuous(reqs, arrival_ticks=arrivals,
                                      max_batch=LANES, page_size=8,
                                      fused=True)
    return out


def test_served_prefill_and_decode_logits_are_the_references():
    torch.set_num_threads(1)
    _, w, _ = _setup()
    reqs = _requests(40, 3)
    arrivals = sorted(np.random.default_rng(4).integers(0, 12, len(reqs)))
    record = []
    out = _serve(reqs, [int(a) for a in arrivals], record)
    seqs = {p.tobytes(): out[i] for i, (p, _) in enumerate(reqs)}
    full = {k: _reference_logits(w, s) for k, s in seqs.items()}
    prefills = ticks = lanes_seen = 0
    for kind, what, logits in record:
        if kind == "prefill":
            S0 = len(what)
            torch.testing.assert_close(logits, full[what.tobytes()][S0 - 1],
                                       **TOL)
            prefills += 1
            continue
        ticks += 1
        for i, (prompt, n) in enumerate(what):
            # lane i decodes the request's n-th token, written at S0 + n - 1
            pos = len(prompt) + n - 1
            torch.testing.assert_close(logits[i], full[prompt.tobytes()][pos],
                                       **TOL)
            lanes_seen += 1
    assert prefills == len(reqs)
    assert ticks > 10 and lanes_seen == sum(nt - 1 for _, nt in reqs)
    assert max(len(what) for kind, what, _ in record if kind == "tick") > 4


@pytest.mark.parametrize("variant", ["small", "query_latent_no_yarn"])
def test_forward_is_the_references(variant):
    """The whole forward over 40 positions (past YaRN's 16-position
    original context) against the reference, and with a query latent and
    plain RoPE (the 236B's MLA, dropless, renormalised gates)."""
    from bench.harness import program_params
    from repro_torch.models.model import _unembed, forward
    model = dict(ref.SMALL)
    if variant != "small":
        model.pop("rope_scaling")
        model.update(q_lora_rank=48, moe=dict(model["moe"],
                                              norm_topk_prob=True,
                                              routed_scaling_factor=1.0))
    cfg = program_config({"name": variant, "model": model,
                          "program_only": [k for k in PROGRAM_ONLY
                                           if k != "rope_scaling"
                                           or "rope_scaling" in model],
                          "program_builder": BUILDER})
    w = make_weights(ref.parameters(model), 5, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 160,
                                                              (2, 40)))
    with torch.inference_mode():
        h, _, _ = forward(program_params(cfg, w), toks, cfg)
        got = _unembed(program_params(cfg, w), h, cfg)
        want = ref.logits(w, ref.hidden(w, toks, model, Float32()), model,
                          Float32())
    torch.testing.assert_close(got, want, **TOL)


def test_a_lanes_logits_do_not_depend_on_its_batch_mates():
    """Row 0 of a 16-row decode step, its cache, token and position fixed,
    against three sets of batch-mates (other tokens, positions and caches,
    so other experts): bitwise the same logits, though the batch-mates'
    routing moves row 0's pairs within the sorted expert rows."""
    torch.set_num_threads(1)
    cfg, _, params = _setup()
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, 160, 20))[None]
    with torch.inference_mode():
        _, c0 = prefill_step(params, prompt, cfg, max_len=64)
        outs, experts = [], set()
        for trial in range(3):
            others = torch.from_numpy(rng.integers(0, 160, (LANES - 1, 20)))
            _, c = prefill_step(params, others, cfg, max_len=64)
            caches = {k: torch.cat([c0[k], c[k]], dim=1) for k in c0}
            tok = torch.from_numpy(rng.integers(0, 160, (LANES, 1)))
            tok[0] = 5
            pos = torch.from_numpy(rng.integers(1, 20, LANES)).to(torch.int32)
            pos[0] = 20
            with moe_mod.recording_routes() as routes:
                logits, _ = decode_step(params, caches, tok, pos, cfg)
            experts.add(tuple(tuple(r[1:].flatten().tolist())
                              for r in routes))
            outs.append(logits[0])
    assert len(experts) == 3
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_paged_at_16_lanes_is_the_dense_generate():
    torch.set_num_threads(1)
    cfg, _, params = _setup()
    eng = ServeEngine(cfg, params, max_len=64, lanes=LANES)
    reqs = _requests(10, 9)
    dense = [eng.generate(p[None], nt)[0] for p, nt in reqs]
    rt = eng.start_paged(max_batch=LANES, page_size=8)
    slots = {eng.admit(p, nt): i for i, (p, nt) in enumerate(reqs)}
    while rt.active_slots():
        eng.decode_tick()
    for s, i in slots.items():
        np.testing.assert_array_equal(eng.retire(s), dense[i])


@pytest.mark.parametrize("graphed", [False, True])
def test_span_experts_are_counted_from_the_routing(graphed):
    """Each traced tick's ``experts`` (and the ``moe.experts`` counter) is
    the distinct experts of its active lanes, summed over the MoE layers;
    each admission's ``experts`` / ``rows`` those of its prompt's routed
    pairs, read from the router's own choices.  The graph's body over its
    fixed buffers (the CPU's stand-in for the captured tick) counts the
    same."""
    torch.set_num_threads(1)
    cfg, _, params = _setup()
    eng = ServeEngine(cfg, params, max_len=64, lanes=LANES,
                      tracer=Tracer())
    rt = eng.start_paged(max_batch=LANES, page_size=8)
    rt._graphed = graphed
    calls = []
    orig = moe_mod.route_dropless

    def route(router, xt, c):
        out = orig(router, xt, c)
        calls.append(out[3].clone())
        return out

    want_admit, want_tick = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_mod, "route_dropless", route)
        for p, nt in _requests(6, 11):
            calls.clear()
            eng.admit(p, nt)
            want_admit.append((sum(len(set(c.flatten().tolist()))
                                   for c in calls),
                               sum(c.numel() for c in calls)))
        while rt.active_slots():
            n = len(rt.active_slots())
            calls.clear()
            eng.decode_tick()
            layers = calls[-(cfg.num_layers - cfg.first_dense_layers):]
            want_tick.append(sum(len(set(c[:n].flatten().tolist()))
                                 for c in layers))
    ev = eng.tracer.events()
    got_admit = [(e.args["experts"], e.args["rows"]) for e in ev
                 if e.name == "engine.admit"]
    got_tick = [e.args["experts"] for e in ev
                if e.name == "engine.decode_tick"]
    counter = [e.args["experts"] for e in ev if e.name == "moe.experts"]
    assert got_admit == want_admit and got_tick == want_tick == counter
    # rows: a prompt token's top 2 in each of the 2 MoE layers
    assert [r for _, r in got_admit] == [4 * len(p) for p, _
                                         in _requests(6, 11)]


def test_grouped_offsets_convention_is_torchs_grouped_mm():
    """The row-by-row product equals ``torch._grouped_mm`` over the same
    device offsets, where this PyTorch runs the grouped product on the CPU
    (the card runs it in bfloat16)."""
    if not hasattr(torch, "_grouped_mm"):
        pytest.skip("this PyTorch has no grouped GEMM")
    cfg, _, params = _setup()
    w = params.layers[1].ffn.experts
    g = torch.Generator().manual_seed(0)
    ids = torch.sort(torch.randint(0, 8, (30,), generator=g)).values
    ids[ids == 3] = 4                           # an expert with no rows
    xs = torch.randn(30, cfg.d_model, generator=g)
    offs = torch.bincount(ids, minlength=8).cumsum(0).to(torch.int32)
    try:
        h = torch.nn.functional.silu(torch._grouped_mm(xs, w.w_gate,
                                                       offs=offs)) \
            * torch._grouped_mm(xs, w.w_up, offs=offs)
        want = torch._grouped_mm(h, w.w_down, offs=offs)
    except RuntimeError as e:
        pytest.skip(f"no grouped GEMM on this device: {e}")
    got = moe_mod.grouped_swiglu(xs, ids, offs, w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_capacity_configs_keep_their_dispatch():
    """A config that states a capacity factor runs the capacity dispatch
    (``deepseek-v2-236b``'s smoke), and dropless is the builder's choice
    alone."""
    from repro_torch.configs import get_smoke_config
    assert not moe_mod.dropless(get_smoke_config("deepseek_v2_236b"))
    assert moe_mod.dropless(lite.CONFIG)


@pytest.mark.cuda
def test_graphed_bf16_tick_is_the_eager_tick_on_the_card():
    """On the card, bfloat16 (the grouped GEMM's dtype), 16 lanes: the
    graph's replays give the eager tick's tokens and expert counts bit for
    bit, with admissions, retires and page reuse between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured on one")
    cfg = lite.smoke().with_(param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    runs = []
    for graphed in (False, True):
        eng = ServeEngine(cfg, params, max_len=64, lanes=LANES,
                          tracer=Tracer())
        rt = eng.start_paged(max_batch=LANES, page_size=8, num_pages=60)
        rt._graphed = graphed
        rng = np.random.default_rng(25)
        pending = [(rng.integers(0, 160, int(rng.integers(3, 30)))
                    .astype(np.int32), int(rng.integers(6, 30)))
                   for _ in range(40)]
        ticks, done = [], []
        while pending or rt.slots:
            while pending and eng.admit(*pending[0]) is not None:
                pending.pop(0)
            ticks.append((eng.decode_tick(), rt.tick_experts))
            done += [eng.retire(s).tolist() for s in eng.finished_slots()]
        runs.append((ticks, sorted(done), dict(rt.tick_graph)))
    (te, de, ne), (tg, dg, ng) = runs
    assert tg == te and dg == de
    assert ng["captures"] == 1 and ng["eager"] == 0 and ne["replays"] == 0
    assert len(te) >= 40

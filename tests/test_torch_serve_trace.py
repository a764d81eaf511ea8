"""The served loop's spans (``HeftFrontEnd.run_continuous(fused=True)`` with a
``Tracer`` on the engines only, as the benchmark attaches it), on the CPU at
smoke widths:

* one ``request.queue`` record a request, one ``frontend.iteration`` span
  (and one ``frontend.backlog`` counter) an iteration, their counts adding
  up to the run's;
* every ``tick.*`` / ``admit.*`` / ``map.*`` span lies inside its parent,
  and siblings do not overlap;
* a decision's ``map.*`` spans share one ``event``;
* tracing changes no token and no decision;
* untraced, and traced with no profiler recording, no ``record_function``
  is reached; under a CPU ``torch.profiler`` the spans are host ranges.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import ModelConfig, init_params
from repro_torch.obs import Tracer
from repro_torch.sched_integration import MappingFabric
from repro_torch.serve import HeftFrontEnd, ReplicaHandle, ServeEngine

CFG = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=4, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32")
SPEEDS = (1.0, 0.7, 1.4)
ARRIVALS = [0, 0, 0, 1, 2, 2, 3, 5, 5, 6, 9, 9]

# children and the one kind of span each lies inside
PARENT = {"engine.admit": "frontend.iteration",
          "engine.decode_tick": "frontend.iteration",
          "engine.retire": "frontend.iteration",
          "map.stage": "frontend.iteration",
          "map.event": "frontend.iteration",
          "map.adopt": "frontend.iteration",
          "map.inputs": "engine.decode_tick",
          "map.launch": "engine.decode_tick",
          "map.commit": "engine.decode_tick",
          "tick.upload": "engine.decode_tick",
          "tick.gather": "engine.decode_tick",
          "tick.step": "engine.decode_tick",
          "tick.scatter": "engine.decode_tick",
          "tick.wait": "engine.decode_tick",
          "tick.tokens": "engine.decode_tick",
          "admit.prefill": "engine.admit",
          "admit.write": "engine.admit",
          "admit.wait": "engine.admit"}

# a fused tick's decision phases (the front end's map.* lie outside it)
TICK_MAP = ("map.inputs", "map.launch", "map.commit")

_CACHE: dict = {}


def _params(device="cpu"):
    if ("params", device) not in _CACHE:
        _CACHE["params", device] = init_params(
            CFG, torch.Generator(device=device).manual_seed(0), device=device)
    return _CACHE["params", device]


def _requests():
    rng = np.random.default_rng(24)
    out = []
    for _ in ARRIVALS:
        nt = int(rng.integers(2, 7))
        s0 = int(rng.integers(2, 32 - nt))
        out.append((rng.integers(1, CFG.vocab_size, size=s0).astype(np.int32),
                    nt))
    return out


def _watch(eng, i, graphed, ticks, move):
    """Record replica ``i``'s tick results in ``ticks``; before its tick
    ``move[0]``, rebind its runtime (``move[1] == "rebind"``) or move its
    pools to new addresses (``"pools"``), as a reshard would."""
    tick, n = eng.decode_tick, [0]

    def watched(sched=None):
        rt = eng.paged
        if move is not None and n[0] == move[0]:
            if move[1] == "rebind":
                rt.rebind()
                rt._graphed = graphed
            else:
                for name in list(rt.pool.pools):
                    rt.pool.pools[name] = rt.pool.pools[name].clone()
        n[0] += 1
        out = tick(sched)
        ticks.append((i, out[0] if sched is not None else out))
        return out

    eng.decode_tick = watched


def _serve(tracer=None, graphed=False, engines=None, device="cpu",
           ticks=None, moves=None):
    """One fused ``run_continuous`` on a fresh fleet; the tracer, if any, on
    the engines only.  Returns the outputs, the stats and each adopted
    plan.  Two lanes and 6 pages a replica make admissions queue.
    ``graphed`` runs each replica's ticks on the graph path's fixed buffers
    (on the CPU, the captured body called directly); on a card, False keeps
    them eager.  ``engines``, a list, receives the replicas' engines;
    ``ticks``, a list, every tick's (replica, tokens); ``moves`` maps a
    replica to a :func:`_watch` move."""
    fleet = [ReplicaHandle(f"replica{i}", ServeEngine(
        CFG, _params(device), max_len=32, lanes=2, tracer=tracer), speed=s)
        for i, s in enumerate(SPEEDS)]
    if graphed or device != "cpu":
        for r in fleet:
            r.engine.start_paged(max_batch=2, page_size=8, num_pages=6)
            r.engine.paged._graphed = graphed
    if ticks is not None:
        for i, r in enumerate(fleet):
            _watch(r.engine, i, graphed, ticks, (moves or {}).get(i))
    if engines is not None:
        engines.extend(r.engine for r in fleet)
    fab = MappingFabric(len(fleet), backend="fused", device=device,
                        device_counters=True)
    front = HeftFrontEnd(fleet, fabric=fab)
    plans, adopt = [], front._adopt_decision

    def adopt_rec(n, decision):
        plans.append(adopt(n, decision))
        return plans[-1]

    front._adopt_decision = adopt_rec
    outs, stats = front.run_continuous(_requests(), arrival_ticks=ARRIVALS,
                                       max_batch=2, page_size=8,
                                       num_pages=6, fused=True)
    return outs, stats, plans, [r.avail_at for r in fleet]


def _traced():
    if "traced" not in _CACHE:
        tr = Tracer()
        _CACHE["traced"] = (tr, *_serve(tr))
    return _CACHE["traced"]


def _traced_graph():
    if "traced_graph" not in _CACHE:
        tr, engines = Tracer(), []
        _CACHE["traced_graph"] = (tr, *_serve(tr, graphed=True,
                                              engines=engines),
                                  [e.paged for e in engines])
    return _CACHE["traced_graph"]


def _spans(tr, prefix=""):
    return [e for e in tr.events() if e.ph == "X"
            and e.name.startswith(prefix)]


def test_one_queue_record_a_request_and_one_iteration_span_an_iteration():
    tr, outs, stats, _, _ = _traced()
    assert tr.dropped == 0
    queue = _spans(tr, "request.queue")
    assert sorted(e.args["req"] for e in queue) == list(range(len(ARRIVALS)))
    assert all(e.dur >= 0 and e.args["replica"] in range(len(SPEEDS))
               for e in queue)
    iters = _spans(tr, "frontend.iteration")
    assert [e.args["it"] for e in iters] == list(range(stats["ticks"]))
    backlog = [e for e in tr.events() if e.name == "frontend.backlog"]
    assert len(backlog) == stats["ticks"] and all(e.ph == "C"
                                                  for e in backlog)
    assert [e.args["backlog"] for e in iters] == \
        [e.args["backlog"] for e in backlog]
    n = len(ARRIVALS)
    for key in ("arrived", "mapped", "admitted", "retired"):
        assert sum(e.args[key] for e in iters) == n, key
    assert sum(e.args["refused"] for e in iters) > 0      # admissions queued
    assert iters[-1].args["backlog"] == 0
    admits = _spans(tr, "engine.admit")
    assert len(admits) == n + sum(e.args["refused"] for e in iters)
    # a request is queued from its arrival iteration to its admission's
    # iteration, which the record names
    for e in queue:
        assert e.args["it"] >= ARRIVALS[e.args["req"]]
    assert sum(e.args["active"] for e in iters) == \
        sum(nt - 1 for _, nt in _requests())
    assert len(_spans(tr, "engine.retire")) == n


def _parent_of(child, parents):
    eps = 1e-3       # µs: a child's ends lie inside its parent's
    hits = [p for p in parents
            if p.ts - eps <= child.ts and child.ts + child.dur
            <= p.ts + p.dur + eps]
    assert len(hits) == 1, (child.name, child.ts, len(hits))
    return hits[0]


def test_phase_spans_lie_inside_their_parents_and_do_not_overlap():
    tr = _traced()[0]
    by_name = {}
    for e in _spans(tr):
        by_name.setdefault(e.name, []).append(e)
    assert set(PARENT) <= set(by_name), set(PARENT) - set(by_name)
    children = {}
    for name, parent in PARENT.items():
        for e in by_name[name]:
            p = _parent_of(e, by_name[parent])
            children.setdefault(id(p), []).append(e)
    for kids in children.values():
        kids.sort(key=lambda e: e.ts)
        for a, b in zip(kids, kids[1:]):
            assert a.ts + a.dur <= b.ts + 1e-3, (a.name, b.name)
    # every tick that decoded a lane has each of its phases once
    for tick in by_name["engine.decode_tick"]:
        kids = [e.name for e in children.get(id(tick), [])]
        if tick.args["active"]:
            for phase in ("tick.upload", "tick.gather", "tick.step",
                          "tick.scatter", "tick.wait", "tick.tokens"):
                assert kids.count(phase) == 1, (phase, kids)
        else:
            assert kids == []
    # an admission that took a request has its three phases; a refused one
    # none
    for adm in by_name["engine.admit"]:
        kids = sorted(e.name for e in children.get(id(adm), []))
        assert kids in ([], ["admit.prefill", "admit.wait", "admit.write"])


def test_a_decisions_map_spans_share_one_event():
    tr, _, stats, plans, _ = _traced()
    events = {}
    for e in _spans(tr, "map."):
        events.setdefault(e.args["event"], []).append(e)
    assert sorted(events) == list(range(len(plans)))
    fused = host = 0
    for ev, spans in events.items():
        names = sorted(e.name for e in spans)
        stage = [e for e in spans if e.name == "map.stage"]
        assert len(stage) == 1 and names.count("map.adopt") == 1
        if "map.event" in names:          # cold or idle fleet: host path
            assert names == ["map.adopt", "map.event", "map.stage"]
            host += stage[0].args["n"]
        else:                             # in the carrier's tick
            assert names == ["map.adopt", "map.commit", "map.inputs",
                             "map.inputs", "map.launch", "map.stage"]
            fused += stage[0].args["n"]
        assert stage[0].args["n"] == len(plans[ev])
    assert (fused, host) == (stats["fused_decisions"],
                             stats["host_decisions"])
    assert fused > 0 and host > 0


def test_tracing_changes_no_token_and_no_decision():
    _, outs, stats, plans, avail = _traced()
    outs0, stats0, plans0, avail0 = _serve()
    for a, b in zip(outs, outs0):
        np.testing.assert_array_equal(a, b)
    assert plans == plans0 and avail == avail0
    assert {k: v for k, v in stats.items() if k != "latency_s"} == \
        {k: v for k, v in stats0.items() if k != "latency_s"}


def test_no_profiler_range_is_opened_untraced_or_with_no_profiler(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function reached")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    outs0 = _serve()[0]
    tr = Tracer()
    outs = _serve(tr)[0]
    assert len(_spans(tr, "tick.")) > 0
    for a, b in zip(outs, outs0):
        np.testing.assert_array_equal(a, b)


def test_spans_are_host_ranges_of_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(tr)
    host = {e.name for e in prof.events()}
    spans = {e.name for e in _spans(tr)}
    assert set(PARENT) | {"frontend.iteration"} <= spans
    assert spans - {"request.queue"} <= host
    # records made after the fact are not mirrored
    assert "request.queue" not in host


@pytest.mark.parametrize("stop_inside", [False, True])
def test_a_span_open_across_a_profilers_start_or_stop(stop_inside):
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    prof = profile(activities=[ProfilerActivity.CPU])
    if stop_inside:
        prof.start()
    with tr.span("outer"):
        if stop_inside:
            prof.stop()
        else:
            prof.start()
        with tr.span("inner"):
            torch.ones(2).sum()
    if not stop_inside:
        prof.stop()
    host = {e.name for e in prof.events()}
    assert [e.name for e in tr.events()] == ["inner", "outer"]
    assert ("outer" in host) == stop_inside
    assert ("inner" in host) == (not stop_inside)


def test_graph_path_replay_lies_inside_the_tick_beside_its_other_phases():
    """On the graph path (the CPU stand-in: the captured body over the fixed
    buffers) one ``tick.replay`` replaces a tick's gather, step and
    scatter, inside ``engine.decode_tick``, overlapping none of its other
    phases (``tick.upload``, ``tick.wait``, ``map.*``); each runtime has one
    ``tick.capture``, on its first tick."""
    tr, _, stats, _, _, runtimes = _traced_graph()
    assert tr.dropped == 0
    ticks = _spans(tr, "engine.decode_tick")
    kids = {}
    for e in _spans(tr):
        if e.name.startswith("tick.") or e.name in TICK_MAP:
            kids.setdefault(id(_parent_of(e, ticks)), []).append(e)
    captures = 0
    for tick in ticks:
        mine = sorted(kids.get(id(tick), []), key=lambda e: e.ts)
        names = [e.name for e in mine]
        for a, b in zip(mine, mine[1:]):
            assert a.ts + a.dur <= b.ts + 1e-3, (a.name, b.name)
        if not tick.args["active"]:
            assert names == []
            continue
        captures += names.count("tick.capture")
        for phase in ("tick.upload", "tick.replay", "tick.wait",
                      "tick.tokens"):
            assert names.count(phase) == 1, (phase, names)
        assert not {"tick.gather", "tick.step", "tick.scatter"} & set(names)
        if "map.launch" in names:
            i = names.index("tick.replay")
            assert names[i - 1:i + 2] in (["tick.upload", "tick.replay",
                                           "map.launch"],
                                          ["map.inputs", "tick.replay",
                                           "map.launch"])
    assert captures == len(runtimes) == len(SPEEDS)
    assert sum(rt.tick_graph["replays"] for rt in runtimes) == \
        sum(1 for t in ticks if t.args["active"])


def test_graph_counter_counts_what_the_runtimes_count():
    """One ``tick.graph`` counter a tick taken, carrying its runtime's
    cumulative counts: together, each runtime's counts after each of its
    ticks, and the last equal to the runtime's own ints."""
    from collections import Counter
    tr, _, _, _, _, runtimes = _traced_graph()
    seen = Counter(tuple(e.args[k] for k in ("captures", "replays", "eager"))
                   for e in tr.events() if e.name == "tick.graph")
    assert all(e.ph == "C" for e in tr.events() if e.name == "tick.graph")
    want = Counter()
    for rt in runtimes:
        n = rt.tick_graph
        assert n["captures"] == 1 and n["eager"] == 0 and n["replays"] > 0
        want.update((1, k, 0) for k in range(1, n["replays"] + 1))
    assert seen == want
    eager = [e.args for e in _traced()[0].events() if e.name == "tick.graph"]
    assert eager and all(a["captures"] == a["replays"] == 0 for a in eager)


def test_graph_path_changes_no_token_and_no_decision():
    _, outs, stats, plans, avail, _ = _traced_graph()
    outs0, stats0, plans0, avail0 = _serve()
    for a, b in zip(outs, outs0):
        np.testing.assert_array_equal(a, b)
    assert plans == plans0 and avail == avail0
    assert {k: v for k, v in stats.items() if k != "latency_s"} == \
        {k: v for k, v in stats0.items() if k != "latency_s"}


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_graphed_fleet_with_a_rebind_and_a_pool_move_is_the_eager_fleet(
        device):
    """A fused ``run_continuous`` over three graphed replicas (on the card
    they share one graph memory pool), one rebound and another's pools
    moved mid-run, so each captures again while the others' graphs stay
    live: every tick's tokens, every output, every adopted plan and the
    fabric's resident availabilities are the eager fleet's, bit for bit.
    One capture a runtime and one more a move, one replay a tick taken.
    (On the CPU the graph path is its stand-in.)"""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured on one")
    moves = {0: (3, "rebind"), 2: (5, "pools")}
    runs = []
    for graphed in (False, True):
        engines, ticks = [], []
        runs.append((*_serve(graphed=graphed, engines=engines, device=device,
                             ticks=ticks, moves=moves),
                     ticks, [dict(e.paged.tick_graph) for e in engines]))
    (outs_e, stats_e, plans_e, avail_e, ticks_e, n_e), \
        (outs_g, stats_g, plans_g, avail_g, ticks_g, n_g) = runs
    assert ticks_g == ticks_e and plans_g == plans_e and plans_g
    assert np.array_equal(np.array(avail_g).view(np.int64),
                          np.array(avail_e).view(np.int64))
    for a, b in zip(outs_g, outs_e):
        np.testing.assert_array_equal(a, b)
    assert {k: v for k, v in stats_g.items() if k != "latency_s"} == \
        {k: v for k, v in stats_e.items() if k != "latency_s"}
    for i in range(len(SPEEDS)):
        taken = sum(1 for r, t in ticks_e if r == i and t)
        assert sum(1 for r, _ in ticks_e if r == i) > moves.get(i, (0,))[0]
        assert n_e[i] == {"captures": 0, "replays": 0, "eager": taken}
        assert n_g[i] == {"captures": 1 + (i in moves), "replays": taken,
                          "eager": 0}

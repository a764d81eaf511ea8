"""One run of one cell: the served path of the program, timed from outside.

The window drives what ``launch/serve.py --paged --fused-scheduler
--full-width`` builds: ``HeftFrontEnd.run_continuous(fused=True)`` over
three ``ServeEngine`` replicas sharing one set of weights (the cell's
declared speeds), on a ``MappingFabric(3, backend="fused",
device_counters=True)``, with 16-token pages.  One ``run_continuous`` call
a run:

1. set-up: the weights from the seed, the kernels' libraries loaded (built
   on a checkout's first run), the fleet, a short warm-up call at the
   cell's shapes on the same fleet;
2. the timed call over the cell's request schedule: its opening fill is
   iteration 0, and the window starts when iteration 0 ends;
3. the window is ``seconds`` long; the first ``admit`` or ``decode_tick``
   after it raises :class:`WindowClosed` from the harness's wrapper, which
   ends the call.  Only what returned inside the window counts.  The
   collector is off for the call (everything made in set-up frozen
   first), so no collection of the set-up's heap lands in the window.

The harness sets wrappers on the replica instances and the front end (as
``chip_smoke.py``'s ``record_decisions`` does) and reads the host clock
after each call returns: ``admit`` returns with a request's first token,
``decode_tick`` with one token for every active lane, ``retire`` with the
whole sequence, each after a device-to-host copy, so the readings are
complete on the device.  The iteration a wrapped call belongs to is counted
from the last replica's ``decode_tick``: iteration k ends when the last
replica's tick of that iteration, and the retires that follow it, return.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bench.weights import make_weights


SPANS_DIR = Path(__file__).resolve().parents[1] / "build" / "bench"
BACKLOG_EVERY = 30


class WindowClosed(Exception):
    """Raised inside the timed call when the window's seconds are up."""


@dataclass
class Run:
    """The readings of one run, which the metric readers take."""

    spec: object
    seed: int
    seconds: float
    t_process: float                       # process start (host clock)
    requests: list = field(default_factory=list)
    arrival_ticks: list = field(default_factory=list)
    window_start: float | None = None
    window_end: float | None = None
    closed_at: float | None = None         # when the call was ended
    setup_s: float | None = None
    admits: list = field(default_factory=list)     # (req, rep, t0, t1, S0)
    admit_calls: list = field(default_factory=list)  # admitted or refused
    ticks: list = field(default_factory=list)      # (rep, t0, t1, n, keys)
    token_times: dict = field(default_factory=lambda: defaultdict(list))
    retired: dict = field(default_factory=dict)    # req -> (t, sequence)
    iter_end: list = field(default_factory=list)
    decisions: list = field(default_factory=list)  # (kind, reqs, out, t)
    avail0: np.ndarray | None = None
    spans: dict = field(default_factory=dict)      # name -> [(t0, dur_s, args)]
    profile: dict | None = None
    prof_window: tuple | None = None         # the traced sub-window
    memory_peak_bytes: int = 0
    params: list = field(default_factory=list)     # the reference's list


def now() -> float:
    return time.perf_counter()


def log(run, msg: str) -> None:
    """A progress line on standard error, stamped from process start."""
    print(f"[bench {now() - run.t_process:8.3f} s] {msg}", file=sys.stderr,
          flush=True)


def program_params(cfg, weights: dict):
    """The program's parameter module holding the benchmark's tensors."""
    from repro_torch.models.model import param_specs
    shell = param_specs(cfg)
    want = {n: (tuple(p.shape), p.dtype) for n, p in shell.named_parameters()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in weights.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise RuntimeError(f"the reference's parameters are not the "
                           f"program's: {diff}")
    for name, t in weights.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = shell.get_submodule(mod_name) if mod_name else shell
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=False))
    return shell


def build_fleet(cfg, params, spec, device: str):
    """The served path's fleet: replicas over shared weights, a fused
    fabric, the HEFT_RT front end."""
    from repro_torch.sched_integration import MappingFabric
    from repro_torch.serve import HeftFrontEnd, ReplicaHandle, ServeEngine
    tr = spec.traffic
    fleet = [ReplicaHandle(f"replica{i}(x{s})",
                           ServeEngine(cfg, params, max_len=tr["max_len"],
                                       lanes=tr["lanes"]), speed=s)
             for i, s in enumerate(spec.cell["speeds"])]
    fab = MappingFabric(len(fleet), backend="fused", device=device,
                        device_counters=True)
    return HeftFrontEnd(fleet, fabric=fab)


def run_call(front, spec, sched: dict):
    """One ``run_continuous`` call of the served path."""
    tr = spec.traffic
    return front.run_continuous(sched["requests"],
                                arrival_ticks=sched["arrival_ticks"],
                                max_batch=tr["lanes"],
                                page_size=tr["page_size"], fused=True)


class Recorder:
    """Wrappers on one fleet's instances that read the host clock, keep the
    tokens and decisions, close the window, and (traced) start and stop the
    profiler over a fixed run of iterations."""

    def __init__(self, run: Run, front, profiler=None):
        self.run = run
        self.front = front
        self.P = len(front.replicas)
        self.req_of = {id(p): i for i, (p, _) in enumerate(run.requests)}
        self.slot_req = [dict() for _ in range(self.P)]
        self.pending = []
        self.profiler = profiler
        self.prof_state = "off"
        trace = run.spec.traffic["trace"]
        self.prof_from = 1 + trace["start_iteration"]
        self.prof_to = self.prof_from + trace["iterations"]
        self.t_prof = [None, None]

    # -- the window and the profiler, checked before each admit / tick ---

    def before(self):
        run = self.run
        t = now()
        if run.window_start is None and len(run.iter_end) >= 1:
            run.window_start = run.iter_end[0]
        if run.window_start is not None and t - run.window_start >= run.seconds:
            # the window is exactly ``seconds`` long; the call ends at the
            # first admit or tick after it, and what returns later counts
            # for nothing
            run.window_end = run.window_start + run.seconds
            run.closed_at = t
            raise WindowClosed
        if self.profiler is not None:
            done = len(run.iter_end)
            if self.prof_state == "off" and done >= self.prof_from:
                torch.cuda.synchronize()
                self.profiler.start()
                self.t_prof[0] = now()
                self.prof_state = "on"
            elif self.prof_state == "on" and done >= self.prof_to:
                self.stop_profiler()

    def stop_profiler(self):
        if self.prof_state == "on":
            torch.cuda.synchronize()
            self.t_prof[1] = now()
            self.profiler.stop()
            self.prof_state = "done"

    def label(self, name):
        if self.prof_state == "on":
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # -- wrappers ----------------------------------------------------------

    def install(self):
        for i, r in enumerate(self.front.replicas):
            eng = r.engine
            eng.admit = self._admit(i, eng, eng.admit)
            eng.decode_tick = self._tick(i, eng, eng.decode_tick)
            eng.retire = self._retire(i, eng.retire)
        front, fab = self.front, self.front.fabric
        stage, commit, mapper = (front._stage_event, fab.commit_tick_decision,
                                 fab.map_event)

        def stage_event(reqs):
            self.pending.append([self.req_of[id(p)] for p, _ in reqs])
            with self.label("bench.stage_event"):
                return stage(reqs)

        def commit_tick_decision(n, buf, new_avail, counters=None):
            out = commit(n, buf, new_avail, counters)
            self.run.decisions.append(("tick", self.pending.pop(0),
                                       tuple(np.array(a) for a in out), now()))
            return out

        def map_event(*args, **kw):
            with self.label("bench.map_event"):
                out = mapper(*args, **kw)
            self.run.decisions.append(("host", self.pending.pop(0),
                                       tuple(np.array(a) for a in out), now()))
            return out

        front._stage_event = stage_event
        fab.commit_tick_decision = commit_tick_decision
        fab.map_event = map_event

    def uninstall(self):
        for r in self.front.replicas:
            for name in ("admit", "decode_tick", "retire"):
                r.engine.__dict__.pop(name, None)
        self.front.__dict__.pop("_stage_event", None)
        for name in ("commit_tick_decision", "map_event"):
            self.front.fabric.__dict__.pop(name, None)

    def _admit(self, i, eng, orig):
        run = self.run

        def admit(prompt, new_tokens):
            self.before()
            t0 = now()
            with self.label("bench.admit"):
                slot = orig(prompt, new_tokens)
            t1 = now()
            run.admit_calls.append(slot is not None)
            if slot is None:
                return slot
            req = self.req_of[id(prompt)]
            self.slot_req[i][slot] = req
            run.admits.append((req, i, t0, t1, len(prompt)))
            run.token_times[req].append((t1, eng.paged.slots[slot].tokens[0]))
            return slot
        return admit

    def _tick(self, i, eng, orig):
        run = self.run

        def decode_tick(sched=None):
            self.before()
            rt = eng.paged
            keys = sum(rt.slots[s].write_pos + 1 for s in rt.active_slots())
            t0 = now()
            with self.label("bench.decode_tick"):
                out = orig() if sched is None else orig(sched)
            t1 = now()
            toks = out if sched is None else out[0]
            for slot, tok in toks.items():
                run.token_times[self.slot_req[i][slot]].append((t1, tok))
            run.ticks.append((i, t0, t1, len(toks), keys))
            if i == self.P - 1:
                run.iter_end.append(t1)
            return out
        return decode_tick

    def _retire(self, i, orig):
        run = self.run

        def retire(slot):
            with self.label("bench.retire"):
                seq = orig(slot)
            t1 = now()
            run.retired[self.slot_req[i].pop(slot)] = (t1, seq)
            if i == self.P - 1:
                run.iter_end[-1] = t1
            return seq
        return retire


def execute(spec, seed: int, seconds: float, trace: bool, device: str,
            t_process: float) -> tuple[Run, dict]:
    """Set up, run the window, and return the run's readings and the
    weights (the reference reads the same tensors)."""
    from repro_torch.kernels import ops
    from bench.spec import program_config

    run = Run(spec=spec, seed=seed, seconds=seconds, t_process=t_process)
    cfg = program_config(spec.config)
    ref = spec.reference()
    run.params = ref.parameters(spec.model)
    weights = make_weights(run.params, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
        log(run, "weights made")
        ops.build_kernels()
        log(run, "kernels loaded")
    front = build_fleet(cfg, program_params(cfg, weights), spec, device)
    gen = spec.generator()
    run_call(front, spec, gen.warmup(spec.traffic, spec.config, seed))
    log(run, "warm-up call done")
    lanes = spec.traffic["lanes"] * len(front.replicas)
    sched = gen.generate(spec.traffic, spec.cell, spec.config, seed,
                         fill=lanes)
    run.requests, run.arrival_ticks = sched["requests"], sched["arrival_ticks"]
    tracer = None
    if trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(capacity=1 << 18)
        for r in front.replicas:
            r.engine.tracer = tracer
    profiler = None
    if trace and device == "cuda":
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = Recorder(run, front, profiler)
    rec.install()
    run.avail0 = np.array([r.avail_at for r in front.replicas],
                          dtype=np.float32)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        run_call(front, spec, sched)
    except WindowClosed:
        pass
    finally:
        gc.enable()
        gc.unfreeze()
        rec.stop_profiler()
        rec.uninstall()
    if run.window_end is None:
        raise RuntimeError("the request schedule ran out before the window "
                           "closed: raise the traffic's horizon")
    run.setup_s = run.window_start - t_process
    log(run, f"window {run.window_end - run.window_start:.3f} s (call ended "
        f"{run.closed_at - run.window_end:.3f} s after it) after "
        f"{run.setup_s:.3f} s of set-up: {len(run.iter_end)} iterations, "
        f"{len(run.admits)} admissions, {len(run.retired)} retired")
    log(run, f"backlog every {BACKLOG_EVERY} iterations: "
        f"{[backlog(run, t) for t in run.iter_end[::BACKLOG_EVERY]]}, at the "
        f"window's end {backlog(run, run.window_end)}")
    if device == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if tracer is not None:
        run.spans = _spans(tracer)
        out = SPANS_DIR / f"{spec.name}.{seed}.trace.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        tracer.export(str(out))
    if profiler is not None and rec.t_prof[1] is not None:
        from bench.trace_read import summarize
        run.prof_window = tuple(rec.t_prof)
        run.profile = summarize(profiler, rec.t_prof[1] - rec.t_prof[0])
        log(run, "trace read")
    del front
    return run, weights


def backlog(run, t: float) -> int:
    """Requests visible by host time ``t`` and not admitted by then.  A
    rate the cell sustains keeps it from growing from reading to reading
    (read every ``BACKLOG_EVERY`` iterations, a burst's cycle)."""
    k = sum(1 for e in run.iter_end if e <= t)      # iterations begun by t
    admitted = {req for req, _, _, t1, _ in run.admits if t1 <= t}
    return sum(1 for i, a in enumerate(run.arrival_ticks)
               if a <= k and i not in admitted)


def _spans(tracer) -> dict:
    """The program's spans by name as (host start, seconds, args)."""
    epoch = now() - tracer.now_us() / 1e6
    out = defaultdict(list)
    for ev in tracer.events():
        if ev.ph == "X":
            out[ev.name].append((epoch + ev.ts / 1e6, ev.dur / 1e6,
                                 ev.args or {}))
    return dict(out)

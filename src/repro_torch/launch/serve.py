"""Serving launcher — batched-request demo with the HEFT_RT front end.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --paged --fused-scheduler
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged

Counterpart of ``repro.launch.serve``.  It builds a small heterogeneous fleet
of replicas (speeds 1.0 / 0.7 / 1.4) of the ``--arch`` smoke configuration
(``--full-width``: its published configuration), sharing one random
parameter set (seed 0), and serves ``--requests`` random
prompts of 8-47 tokens through the ``HeftFrontEnd``.  It runs on the card
unless ``--device cpu`` is given.

``--sharded`` backs the replicas with mesh slices instead
(``--mesh-shapes 1x1,2x1,2x2``: ``serve.mesh_backed_fleet``), one process
a device under ``torchrun`` over ``--backend`` (``gloo`` on the CPU,
``nccl`` on cards); without ``torchrun`` the world is this one process.
``--reshard-to 2x1`` then migrates replica 0 live onto a slice carved from
the ranks the fleet left over, and serves the requests again,
token-identically (exit 1 otherwise):

  PYTHONPATH=src torchrun --nproc-per-node 7 -m repro_torch.launch.serve \
      --device cpu --sharded --mesh-shapes 1x1,2x1,2x2 --paged --fused-scheduler

Every rank runs the front end; rank 0 logs and writes the trace.

A Mamba layer prefills only prompts of at most its scan chunk or a
multiple of it (``models/mamba.py``), so the random lengths fail for
falcon-mamba-7b and jamba-v0.1-52b here as in the reference.
``--prompt-lens 8,12,16`` takes the prompt lengths from the list instead,
in turn.

``--paged`` serves through the block-paged KV pool: requests are HEFT_RT-
mapped and admitted into the running batch at each decode tick
(``--max-batch`` slots, ``--page-size``-token pages; ``--num-pages`` below
full occupancy makes admission queue), with staggered arrivals, and request
0 is checked token-identical to the dense oracle (exit 1 otherwise).
``--fused-scheduler`` (with ``--paged``) makes the HEFT_RT decisions inside
the decode ticks, on a ``MappingFabric(backend="fused")``.  ``--slo-s``
reports how many requests finished within that many seconds of arriving.
``--chaos TRACE.json`` replays a schema-validated failure timeline
(``replica_loss`` / ``straggler`` / ``link_degrade`` / ``link_partition``;
``sched_integration.fleet.validate_failure_timeline``) against a simulator
twin of the fleet, reports goodput (requests served inside ``--slo-s``) as
a percentage of the failure-free run, and fails over live: the first lost
replica leaves the front end and the same requests are served again on
the survivors, token-identically (exit 1 otherwise).  Goodput below
``--min-goodput`` (default 90) exits non-zero.  A replica target in the
timeline may be a unique prefix of a replica's name.  The twin's
HEFT_RT policy runs on ``--device``: the ``cuda`` kernel on the card, the
float64 host path with ``--device cpu``.

``--trace OUT.json`` attaches a Tracer + MetricsRegistry to the front end,
the engines and an instrumented fabric, and exports a Chrome trace with
the metrics and the drained device counters.  Output verbosity is the
``REPRO_LOG`` environment variable.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import init_world
from repro_torch.models import init_params
from repro_torch.obs import MetricsRegistry, Tracer, get_logger
from repro_torch.obs.metrics import time_s
from repro_torch.sched_integration import (POLICIES, FailureEvent, Replica,
                                           goodput, load_failure_timeline,
                                           make_requests, simulate_serving,
                                           spine_topology)
from repro_torch.sched_integration.fabric import MappingFabric
from repro_torch.serve import (HeftFrontEnd, ReplicaHandle, ServeEngine,
                               mesh_backed_fleet)

log = get_logger("serve")


def main(argv=None) -> dict:
    """Run the launcher; returns the config's name, layers and parameter
    count, the outputs and, with ``--chaos``, the twin's numbers and the
    failover."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--full-width", action="store_true",
                    help="serve --arch at its published widths and depth "
                         "(random weights, seed 0) instead of its smoke "
                         "config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching through the block-paged KV "
                         "pool, verifying request 0 token-identical to the "
                         "dense oracle")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="with --paged: concurrent batch slots per replica "
                         "(also every engine's decode lane count)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="with --paged: KV page size in tokens (must divide "
                         "the engine max_len, 128)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="with --paged: pool pages per replica (default: "
                         "full occupancy; lower makes admission queue)")
    ap.add_argument("--fused-scheduler", action="store_true",
                    help="with --paged: make the HEFT_RT admission decision "
                         "inside the decode tick (MappingFabric "
                         "backend='fused')")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export a Chrome trace (Perfetto) of the run, with "
                         "the metrics snapshot and drained device counters")
    ap.add_argument("--slo-s", type=float, default=2.0,
                    help="per-request latency SLO in seconds: the paged "
                         "run's goodput line and the --chaos goodput")
    ap.add_argument("--chaos", default=None, metavar="TRACE.json",
                    help="replay a schema-validated failure timeline against "
                         "a simulator twin of the fleet and fail over live; "
                         "exits non-zero below --min-goodput")
    ap.add_argument("--min-goodput", type=float, default=90.0,
                    help="minimum chaos goodput as percent of the "
                         "failure-free run (default 90)")
    ap.add_argument("--prompt-lens", default=None, metavar="N,N,...",
                    help="prompt lengths, used in turn (default: drawn "
                         "from 8-47)")
    ap.add_argument("--sharded", action="store_true",
                    help="back replicas with mesh slices of the world's "
                         "ranks (one process a device, under torchrun)")
    ap.add_argument("--mesh-shapes", default="1x1",
                    help="comma-separated slice shapes for --sharded, "
                         "e.g. 1x1,2x1,2x2")
    ap.add_argument("--reshard-to", default=None, metavar="AxB",
                    help="with --sharded: after serving, migrate replica 0 "
                         "live onto a slice of this shape carved from the "
                         "leftover ranks, and re-verify outputs")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="with --sharded: the process-group backend "
                         "(default: gloo with --device cpu, else nccl)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu to run "
                         "the plain path on the CPU)")
    args = ap.parse_args(argv)
    if args.fused_scheduler and not args.paged:
        raise SystemExit("--fused-scheduler requires --paged")
    if args.reshard_to and not args.sharded:
        raise SystemExit("--reshard-to requires --sharded")

    rank = 0
    if args.sharded:
        rank, _ = init_world(args.backend or ("gloo" if args.device == "cpu"
                                              else "nccl"),
                             device=args.device)
    if rank:
        log.setLevel("WARNING")
    device = resolve_device(args.device)
    cfg = (get_config if args.full_width else get_smoke_config)(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    log.info(f"arch={cfg.name} params={cfg.param_count()/1e6:.2f}M "
             f"device={device}")

    tracer, metrics = (Tracer(), MetricsRegistry()) if args.trace else (None, None)
    spare = []
    if args.sharded:
        shapes = [tuple(int(d) for d in s.split("x"))
                  for s in args.mesh_shapes.split(",")]
        fleet, spare = mesh_backed_fleet(cfg, params, shapes, max_len=128,
                                         lanes=args.max_batch,
                                         return_spare=True, device=device)
        for r in fleet:
            r.engine.tracer = tracer
        log.info(f"mesh-backed fleet: {[r.mesh_shape for r in fleet]} "
                 f"slices ({len(spare)} spare ranks)")
    else:
        speeds = [1.0, 0.7, 1.4][: args.replicas] or [1.0]
        fleet = [ReplicaHandle(f"replica{i}(x{s})",
                               ServeEngine(cfg, params, max_len=128,
                                           lanes=args.max_batch,
                                           tracer=tracer),
                               speed=s)
                 for i, s in enumerate(speeds)]

    fabric = None
    if args.trace or args.fused_scheduler:
        # --trace: decision spans, the per-decision latency histogram and
        # device counters (numpy backend: decisions bitwise those of the
        # heft_rt_numpy path used untraced); --fused-scheduler: the fused
        # backend whose registers the paged decode tick consumes.
        backend = "fused" if args.fused_scheduler else "numpy"
        fabric = MappingFabric(len(fleet), backend=backend, device=device,
                               tracer=tracer, metrics=metrics,
                               device_counters=True)
        if args.fused_scheduler:
            log.info(f"fused scheduler: fabric backend={backend} "
                     f"(effective {fabric.backend_effective})")
    front = HeftFrontEnd(fleet, fabric=fabric, tracer=tracer, metrics=metrics)

    rng = np.random.default_rng(0)
    lens = ([int(n) for n in args.prompt_lens.split(",")]
            if args.prompt_lens else None)
    requests = [
        (rng.integers(0, cfg.vocab_size,
                      lens[i % len(lens)] if lens else rng.integers(8, 48)
                      ).astype(np.int32),
         args.new_tokens)
        for i in range(args.requests)
    ]
    tokens = sum(len(p) + nt for p, nt in requests)
    if args.paged:
        # Staggered arrivals, so later requests land while decode ticks are
        # in flight (tick-0 arrivals are cold start: the host path).
        arrivals = [min(i, 2 * args.new_tokens // 3)
                    for i in range(len(requests))]
        (seqs, stats), dt = time_s(
            front.run_continuous, requests, arrival_ticks=arrivals,
            max_batch=args.max_batch, page_size=args.page_size,
            num_pages=args.num_pages)
        outs = [s[None, :] for s in seqs]
        counts = stats["processed"]
        good = sum(lat <= args.slo_s for lat in stats["latency_s"])
        log.info(f"{len(outs)} requests in {dt:.2f}s paged "
                 f"({tokens / dt:.0f} tok/s, {stats['ticks']} ticks, "
                 f"{stats['allocated']} pages allocated == "
                 f"{stats['freed']} freed; {good}/{len(outs)} within the "
                 f"{args.slo_s} s SLO)")
        if args.fused_scheduler:
            log.info(f"scheduling decisions: {stats['fused_decisions']} "
                     f"fused in-tick, {stats['host_decisions']} host "
                     f"(cold-start/idle)")
        oracle = front.replicas[0].engine.generate(requests[0][0][None, :],
                                                   requests[0][1])
        if not np.array_equal(outs[0], oracle):
            raise SystemExit("paged output diverged from the dense oracle")
        log.info("request 0 verified token-identical to the dense oracle")
    else:
        (outs, counts), dt = time_s(front.run_batch, requests)
        log.info(f"{len(outs)} requests in {dt:.2f}s ({tokens / dt:.0f} tok/s)")
    log.info(f"request distribution (HEFT_RT): {counts}")
    log.info(f"sample output ids: {outs[0][0, -8:].tolist()}")

    if args.reshard_to:
        from repro_torch.launch.mesh import make_debug_mesh

        shape = tuple(int(d) for d in args.reshard_to.split("x"))
        need = int(np.prod(shape))
        if len(spare) < need:
            raise SystemExit(
                f"--reshard-to {args.reshard_to} needs {need} spare ranks, "
                f"the world has {len(spare)} left after the fleet slices")
        target = make_debug_mesh(shape, devices=spare[:need], device=device)
        old = fleet[0].mesh_shape
        fleet[0].engine.reshard(target)
        fleet[0].sync_mesh_identity()     # speed / rates follow the slice
        log.info(f"replica 0 resharded live: {old} -> "
                 f"{fleet[0].mesh_shape} (speed x{fleet[0].speed:.0f})")
        outs2, _ = front.run_batch(requests)
        same = all(np.array_equal(a, b) for a, b in zip(outs, outs2))
        log.info(f"post-reshard outputs "
                 f"{'token-identical' if same else 'MISMATCH'}")
        if not same:
            raise SystemExit(1)     # the verification must fail loudly

    summary = {"arch": cfg.name, "layers": cfg.num_layers,
               "params": cfg.param_count(), "outputs": outs}
    if args.chaos:
        summary["chaos"] = _run_chaos(args, front, requests, outs, device,
                                      tracer, metrics)

    if args.trace and rank == 0:
        for name, value in fabric.drain_counters().items():
            metrics.gauge("fabric.device", counter=name).set(value)
        tracer.export(args.trace, metrics=metrics)
        log.info(f"trace: {args.trace} ({len(tracer)} events, "
                 f"{len(metrics)} metrics)")
    return summary


def _resolve_targets(timeline, names):
    """Resolve replica-kind targets against the fleet, accepting unique name
    prefixes (a generic trace says ``replica1`` and matches
    ``replica1(x0.7)``).  Link targets pass through untouched."""
    out = []
    for e in timeline:
        if e.kind in ("replica_loss", "straggler"):
            hits = [n for n in names
                    if n == e.target or n.startswith(e.target)]
            if len(hits) != 1:
                raise SystemExit(
                    f"chaos target {e.target!r} matches "
                    f"{hits or 'no replicas'} in {names}")
            if hits[0] != e.target:
                e = FailureEvent(e.t, e.kind, hits[0], e.duration_s,
                                 e.factor, e.reason)
        out.append(e)
    return out


def chaos_twin(timeline, replicas, slo_s: float, *, policy=None,
               device=None, tracer=None, metrics=None) -> dict:
    """Goodput of the simulator twin of ``replicas`` (name + speed) under
    ``timeline``, against the failure-free run of the same load.

    The twin's constants are the reference launcher's: a speed-1.0 replica
    prefills at 25000 and decodes at 126000 tokens/s, the offered load is
    24 requests/s a unit of speed over 2 s (seed 0), the model has 7e9
    active parameters, and link events run on one pod a replica behind a
    shared spine (targets ``podI:spine``).  ``policy`` is a factory of the
    HEFT_RT policy (default ``POLICIES["heft_rt"]`` on ``device``)."""
    make = policy or (lambda: POLICIES["heft_rt"](device=device))
    twin = [Replica(r.name, 25000.0 * r.speed, 126000.0 * r.speed)
            for r in replicas]
    rate = 24.0 * sum(r.speed for r in replicas)
    topo = None
    if any(e.kind in ("link_degrade", "link_partition") for e in timeline):
        pod_of = {r.name: f"pod{i}" for i, r in enumerate(twin)}
        topo = spine_topology(["gw"] + sorted(set(pod_of.values())), 100.0,
                              pod_of=pod_of, gateway="gw")
    load = make_requests(rate, 2.0, seed=0)
    clean = simulate_serving(twin, load, make(), active_params=7e9)
    chaos = simulate_serving(twin, load, make(), active_params=7e9,
                             failure_events=timeline, topology=topo,
                             tracer=tracer, metrics=metrics)
    g_clean = goodput(clean, load, slo_s)
    g_chaos = goodput(chaos, load, slo_s)
    return {"failures": len(timeline), "goodput": g_chaos,
            "goodput_clean": g_clean,
            "pct": 100.0 * g_chaos / max(g_clean, 1),
            "requeued": int(chaos.requeued.sum()),
            "unserved": int((~chaos.served_mask).sum())}


def _run_chaos(args, front, requests, outs, device, tracer, metrics) -> dict:
    """The --chaos path: the simulator twin's goodput gate, then live
    failover on the real front end."""
    timeline = _resolve_targets(load_failure_timeline(args.chaos),
                                [r.name for r in front.replicas])
    res = chaos_twin(timeline, front.replicas, args.slo_s, device=device,
                     tracer=tracer, metrics=metrics)
    log.info(f"chaos: {res['failures']} failures, goodput {res['goodput']}/"
             f"{res['goodput_clean']} ({res['pct']:.1f}% of failure-free), "
             f"{res['requeued']} re-queued, {res['unserved']} unserved")

    # Live failover: the first lost replica leaves the front end and the
    # same requests are served again; token-identical outputs on the
    # survivors show that no request depends on the dead engine.
    losses = [e for e in timeline if e.kind == "replica_loss"]
    if losses and len(front.replicas) > 1:
        gone = front.remove_replica(losses[0].target)
        outs2, _ = front.run_batch(requests)
        same = all(np.array_equal(a, b) for a, b in zip(outs, outs2))
        log.info(f"failover: lost {gone.name}, re-served {len(outs2)} "
                 f"requests on {len(front.replicas)} survivors "
                 f"({'token-identical' if same else 'MISMATCH'})")
        if not same:
            raise SystemExit(1)
        res["failover"] = {"lost": gone.name,
                           "survivors": len(front.replicas),
                           "token_identical": same}
    if res["pct"] < args.min_goodput:
        raise SystemExit(
            f"chaos goodput {res['pct']:.1f}% below --min-goodput "
            f"{args.min_goodput}%")
    return res


if __name__ == "__main__":
    main()

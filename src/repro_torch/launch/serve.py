"""Serving launcher — batched-request demo with the HEFT_RT front end.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --paged --fused-scheduler
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged

Counterpart of ``repro.launch.serve`` without the mesh-backed paths
(``--sharded``, ``--mesh-shapes``, ``--reshard-to``, ``--chaos``,
``--min-goodput`` come with ``dist/``).  It builds a small heterogeneous
fleet of replicas (speeds 1.0 / 0.7 / 1.4) of the ``--arch`` smoke
configuration, sharing one random parameter set (seed 0), and serves
``--requests`` random prompts of 8-47 tokens through the ``HeftFrontEnd``.
It runs on the card unless ``--device cpu`` is given.

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
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.obs import MetricsRegistry, Tracer, get_logger
from repro_torch.obs.metrics import time_s
from repro_torch.sched_integration.fabric import MappingFabric
from repro_torch.serve import HeftFrontEnd, ReplicaHandle, ServeEngine

log = get_logger("serve")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
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
                    help="with --paged: per-request latency SLO (seconds "
                         "from arrival to retire) for the goodput line")
    ap.add_argument("--prompt-lens", default=None, metavar="N,N,...",
                    help="prompt lengths, used in turn (default: drawn "
                         "from 8-47)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu to run "
                         "the plain path on the CPU)")
    args = ap.parse_args(argv)
    if args.fused_scheduler and not args.paged:
        raise SystemExit("--fused-scheduler requires --paged")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    log.info(f"arch={cfg.name} params={cfg.param_count()/1e6:.2f}M "
             f"device={device}")

    tracer, metrics = (Tracer(), MetricsRegistry()) if args.trace else (None, None)
    speeds = [1.0, 0.7, 1.4][: args.replicas] or [1.0]
    fleet = [ReplicaHandle(f"replica{i}(x{s})",
                           ServeEngine(cfg, params, max_len=128,
                                       lanes=args.max_batch, tracer=tracer),
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

    if args.trace:
        for name, value in fabric.drain_counters().items():
            metrics.gauge("fabric.device", counter=name).set(value)
        tracer.export(args.trace, metrics=metrics)
        log.info(f"trace: {args.trace} ({len(tracer)} events, "
                 f"{len(metrics)} metrics)")


if __name__ == "__main__":
    main()

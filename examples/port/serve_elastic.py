"""Elastic serving on the port: a load spike grows the fleet, the drain
merges it back; then one live replica migrates between mesh slices.

  PYTHONPATH=src python examples/port/serve_elastic.py [--device cpu]

Part 1 (fleet-scale simulation): a scripted load spike hits a 2-replica
base fleet.  The closed-loop ``FleetController`` watches the committed
backlog horizon each mapping event, carves two extra (4, 4) replicas out of
the spare pool while the spike lasts, and merges them back once the backlog
drains — printing its decision trace.  Compare against the static base
fleet (tail latency blows up) and the always-max fleet (wasteful between
spikes).  The HEFT_RT policy runs on ``--device`` (the ``heft_fused``
kernel on the card, the float64 host path with ``--device cpu``).

Part 2 (live engines): one real ``ServeEngine`` replica migrates (1, 1)
→ (2, 2) → (2, 1) in memory via ``reshard`` — parameters move to the new
slice, and generation stays token-for-token identical.  It needs six
devices, one process each, spawned on this machine: six CUDA cards over
``nccl``, or with ``--device cpu`` six CPU processes over ``gloo``.  With
fewer cards it is skipped, as the reference skips it with fewer devices
(ranks sharing one card would need gloo, which does not run ``DTensor``'s
collectives on CUDA tensors).

Without ``--device`` it runs on the CUDA card.
"""

import argparse
import os
import socket

import numpy as np
import torch

from repro_torch.sched_integration import (
    FleetController,
    FleetControllerConfig,
    POLICIES,
    grown_replica_factory,
    make_spike_requests,
    mesh_fleet,
    simulate_serving,
)

ACTIVE = 7e9
RANKS = 6


def simulate(device) -> None:
    print("== elastic fleet vs static fleets under a load spike ==")
    base = mesh_fleet("deepseek-7b", ((4, 4), (4, 4)))
    always_max = mesh_fleet("deepseek-7b", ((4, 4),) * 4)
    reqs = make_spike_requests(2.0, 30.0, spike_start=1.0, spike_end=2.0,
                               duration_s=8.0, seed=1)
    print(f"{len(reqs)} requests; spike 30 rps in [1s, 2s), base 2 rps\n")

    ctl = FleetController(
        FleetControllerConfig(grow_backlog_s=1.0, shrink_backlog_s=0.3,
                              cooldown_s=0.5, max_grown=2),
        grown_replica_factory("deepseek-7b", (4, 4)))
    heft = POLICIES["heft_rt"]
    elastic = simulate_serving(base, reqs, heft(device=device),
                               active_params=ACTIVE, controller=ctl)
    static = simulate_serving(base, reqs, heft(device=device),
                              active_params=ACTIVE)
    best = simulate_serving(always_max, reqs, heft(device=device),
                            active_params=ACTIVE)

    print("controller decision trace:")
    for t, kind, why in ctl.trace:
        print(f"  t={t:6.2f}s  {kind:6s}  {why}")

    print(f"\n{'fleet':>16} {'p50':>8} {'p99':>8} {'served':>7} "
          f"{'devices':>14}")
    for name, r, devs in (("static base", static, "32 always"),
                          ("elastic", elastic, "32 + 32@spike"),
                          ("always max", best, "64 always")):
        print(f"{name:>16} {r.p50_latency*1e3:7.0f}ms "
              f"{r.p99_latency*1e3:7.0f}ms "
              f"{int(r.served_mask.sum()):6d}/{len(reqs)} {devs:>14}")


def reshard_rank(rank: int, port: int, device) -> None:
    """One rank of part 2 (every rank builds every mesh, in order)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(RANKS), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    torch.set_num_threads(1)      # the ranks share this machine's cores
    init_world("gloo" if device == "cpu" else "nccl", device=device)
    dev = (torch.device(device) if device == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    cfg = get_smoke_config("deepseek-7b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu").to(dev)    # the same weights on every rank
    eng = ServeEngine(cfg, params, max_len=64, lanes=1,
                      mesh=make_debug_mesh((1, 1), devices=[0],
                                           device=device))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 12).astype(np.int32)
    want = eng.generate(prompt[None, :], 8)
    ok = True
    for shape, ranks in (((2, 2), range(4)), ((2, 1), range(4, 6))):
        eng.reshard(make_debug_mesh(shape, devices=list(ranks),
                                    device=device))
        same = np.array_equal(eng.generate(prompt[None, :], 8), want)
        ok &= same
        if rank == 0:
            print(f"  resharded to {shape}: generation "
                  f"{'bit-identical' if same else 'MISMATCH'}", flush=True)
    if rank == 0:
        print(f"  tokens: {want[0, -8:].tolist()}", flush=True)
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    simulate(args.device)

    print("\n== live ServeEngine.reshard: (1,1) -> (2,2) -> (2,1) ==")
    if args.device != "cpu" and torch.cuda.device_count() < RANKS:
        print(f"(live reshard demo skipped: {torch.cuda.device_count()} "
              f"card(s); it needs {RANKS}, one process a card, or "
              f"--device cpu)")
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(reshard_rank, args=(port, args.device),
                                nprocs=RANKS, join=True)


if __name__ == "__main__":
    main()

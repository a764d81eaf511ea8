"""Serving with the HEFT_RT front end vs round-robin on a heterogeneous
fleet, on the port.

  PYTHONPATH=src python examples/port/serve_with_heft.py [--device cpu]

The fleet-scale simulation (roofline exec-time estimates) runs through the
fabric-batched mapping-event pipeline: the HEFT_RT policy is a
``MappingFabric`` front end (on the card the ``heft_fused`` CUDA kernel,
with ``--device cpu`` the float64 host path, which is the reference's
arithmetic), the exec matrix comes from the vectorized
``service_time_matrix``, and the simulator jumps between arrival event
horizons instead of spinning empty scheduler ticks.
``REPRO_TORCH_FABRIC_BACKEND=torch`` runs the kernel's float32 plain
version on the CPU instead, the card's arithmetic.

Without ``--device`` it runs on the CUDA card.
"""

import argparse

import numpy as np
import torch

from repro_torch.sched_integration import (
    CostCell,
    CostModelRegistry,
    MappingFabric,
    POLICIES,
    default_fleet,
    make_requests,
    mesh_fleet,
    scaled_cell,
    service_time_matrix,
    simulate_serving,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()


def policy(name):
    # the fabric-backed HEFT_RT policy takes the device; the baselines are
    # host code
    return (POLICIES[name](device=args.device) if name == "heft_rt"
            else POLICIES[name]())


print("fleet-scale simulation: 4 heterogeneous replicas, 7B-class model")
fleet = default_fleet()
reqs = make_requests(rate_rps=800, duration_s=3.0, seed=0)
print(f"{'policy':>14} {'mean lat':>9} {'p99 lat':>9} {'achieved':>9}")
for name in POLICIES:
    r = simulate_serving(fleet, reqs, policy(name), active_params=7e9)
    print(f"{name:>14} {r.mean_latency*1e3:8.0f}ms {r.p99_latency*1e3:8.0f}ms "
          f"{r.achieved_rps:8.0f}/s")
print("\nutilization under heft_rt:",
      np.round(simulate_serving(fleet, reqs, policy("heft_rt"),
                                active_params=7e9).replica_util, 2))

# The same mapping events batched through one fabric dispatch, T_avail
# resident across events: 64 events of 4-deep queues in one launch.
print("\nfabric-batched mapping events:")
fab = MappingFabric(len(fleet), device=args.device)
ex = service_time_matrix(reqs[:256], fleet, active_params=7e9).astype(np.float32)
B, P = 64, len(fleet)
batch_ex = ex[: B * 4].reshape(B, 4, P)                 # 64 events x 4-deep queues
batch_avg = batch_ex.mean(axis=2)
res = fab.map_batch(batch_avg, batch_ex, np.zeros((B, P), np.float32))
counts = np.bincount(torch.as_tensor(res.assignment).cpu().numpy().ravel(),
                     minlength=P)
print(f"  {B} events in one device dispatch; per-replica assignment counts: "
      f"{counts.tolist()}  (fabric events so far: {fab.events})")

# Mesh-backed fleet + dry-run cost models: replicas are mixed-size mesh
# slices of one chip generation, and Exec_TID columns come from measured
# (arch × shape × mesh) cost cells — here one measured cell projected onto
# the smaller slices (90% scaling efficiency) — with the analytic roofline
# as fallback for uncovered cells.
print("\nmesh-backed fleet with cost-model Exec_TID:")
sharded = mesh_fleet("deepseek-7b", ((16, 16), (16, 16), (4, 16), (4, 4)))
# "Measured" cells carry what the analytic 2·N·tokens roofline misses:
# the quadratic attention FLOPs in prefill (~+15% at 32k) and the KV-cache
# stream on top of weight bytes in decode (~+30%).
measured = [
    CostCell("deepseek-7b", "prefill", (16, 16), tokens_per_step=32 * 32768,
             flops_per_device=1.15 * 2.0 * 7e9 * 32 * 32768 / 256,
             bytes_per_device=6.1e10),
    CostCell("deepseek-7b", "decode", (16, 16), tokens_per_step=128,
             flops_per_device=2.0 * 7e9 * 128 / 256,
             bytes_per_device=1.30 * 2.0 * 7e9 * 128 / 256),
]
reg = CostModelRegistry(measured)
for cell in measured:
    for shape in ((4, 16), (4, 4)):
        reg.register(scaled_cell(cell, shape, efficiency=0.9))
print(f"  registry: {len(reg)} cells; "
      f"covered: {[reg.covers(r) for r in sharded]}")
r_cost = simulate_serving(sharded, reqs, policy("heft_rt"),
                          active_params=7e9, cost_registry=reg)
r_roof = simulate_serving(sharded, reqs, policy("heft_rt"),
                          active_params=7e9)
print(f"  cost-model Exec_TID: mean {r_cost.mean_latency*1e3:6.0f}ms  "
      f"p99 {r_cost.p99_latency*1e3:6.0f}ms  {r_cost.achieved_rps:5.0f}/s")
print(f"  roofline  Exec_TID: mean {r_roof.mean_latency*1e3:6.0f}ms  "
      f"p99 {r_roof.p99_latency*1e3:6.0f}ms  {r_roof.achieved_rps:5.0f}/s")

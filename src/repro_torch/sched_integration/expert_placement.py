"""HEFT_RT applied to MoE expert placement — the paper's scheduler as a
first-class feature of the training/serving framework.

Problem: expert-parallel MoE shards experts over devices in index order; with
skewed routing (real workloads are Zipfian) some devices carry far more token
load than others and the all-to-all + expert compute is bottlenecked by the
hottest device (the makespan).

Mapping to the paper's abstraction: *experts are the ready queue, devices are
the PEs*.  ``Avg_TID`` = expert load × mean device cost; ``Exec[e,p]`` =
load[e] / speed[p]; ``T_avail`` = load already committed to each device.  One
HEFT_RT mapping event (same code path as the FPGA overlay kernels) yields a
greedy-makespan placement; the permutation is applied to the stacked expert
weights AND the router columns, so the model function is exactly preserved
(tests assert output invariance).

PyTorch port of ``repro.sched_integration.expert_placement``: the planning is
numpy and unchanged; :func:`apply_placement` permutes torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.heft_rt import heft_rt_numpy


def plan_expert_placement(
    expert_load: np.ndarray,       # (E,) tokens routed to each expert
    device_speed: np.ndarray,      # (P,) relative throughput of each device
) -> np.ndarray:
    """Returns device assignment (E,) minimizing (greedily) the makespan."""
    expert_load = np.asarray(expert_load, dtype=np.float64)
    device_speed = np.asarray(device_speed, dtype=np.float64)
    E, P = expert_load.shape[0], device_speed.shape[0]
    exec_times = expert_load[:, None] / device_speed[None, :]      # (E, P)
    avg = exec_times.mean(axis=1)
    avail = np.zeros(P)
    order, assignment, _, _, _ = heft_rt_numpy(avg, exec_times, avail)
    out = np.empty(E, dtype=np.int64)
    out[order] = assignment
    return out


def balanced_capacity_assignment(assignment: np.ndarray, num_devices: int,
                                 experts_per_device: int) -> np.ndarray:
    """Enforce equal experts-per-device (EP sharding needs a rectangular
    layout): overflowing experts move to the least-loaded underfull device,
    preserving the HEFT ordering priority."""
    E = assignment.shape[0]
    assert E == num_devices * experts_per_device
    counts = np.zeros(num_devices, dtype=np.int64)
    out = np.empty(E, dtype=np.int64)
    # process experts in descending index of... keep original order
    overflow = []
    for e in range(E):
        d = assignment[e]
        if counts[d] < experts_per_device:
            out[e] = d
            counts[d] += 1
        else:
            overflow.append(e)
    for e in overflow:
        d = int(np.argmin(counts))
        out[e] = d
        counts[d] += 1
    return out


def placement_permutation(assignment: np.ndarray, num_devices: int,
                          experts_per_device: int) -> np.ndarray:
    """perm[new_slot] = old_expert_index.

    Slot layout: device d owns contiguous slots [d*epd, (d+1)*epd) — matching
    how the expert axis shards over the 'model' mesh axis."""
    assignment = balanced_capacity_assignment(assignment, num_devices,
                                              experts_per_device)
    slots: list[list[int]] = [[] for _ in range(num_devices)]
    for e, d in enumerate(assignment):
        slots[d].append(e)
    perm = np.concatenate([np.array(s, dtype=np.int64) for s in slots])
    return perm


def apply_placement(moe_params: dict, perm: np.ndarray) -> dict:
    """Permute stacked expert weights + router columns by ``perm``.

    ``moe_params`` holds torch tensors: ``router`` (d_model, E) and
    ``experts``, a dict of tensors with the expert axis first.  Returns new
    tensors on their own devices; the inputs are not modified.

    Output-preserving: router column j of the new layout is old column
    perm[j], and expert slot j holds old expert perm[j].
    """
    router = moe_params["router"]
    idx = torch.as_tensor(np.asarray(perm, dtype=np.int64),
                          device=router.device)
    out = dict(moe_params)
    out["router"] = router[:, idx]
    out["experts"] = {k: v[idx.to(v.device)]
                      for k, v in moe_params["experts"].items()}
    return out


def makespan(expert_load: np.ndarray, device_speed: np.ndarray,
             assignment: np.ndarray) -> float:
    load = np.zeros(device_speed.shape[0])
    for e, d in enumerate(assignment):
        load[d] += expert_load[e] / device_speed[d]
    return float(load.max())


def round_robin_assignment(num_experts: int, num_devices: int) -> np.ndarray:
    """The default EP layout: expert e on device e // (E/P)."""
    epd = num_experts // num_devices
    return np.repeat(np.arange(num_devices), epd)

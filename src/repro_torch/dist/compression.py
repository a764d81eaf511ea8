"""Pod-level gradient collectives: exact mean and int8 error-feedback mean.

Counterpart of ``repro.dist.compression``, over a ``torch.distributed``
process group in place of a named mesh axis.  Cross-pod links are the
slowest hop of a multi-pod mesh, and the cross-pod all-reduce of the whole
gradient is the only traffic that crosses them every step.
``compressed_psum_mean`` cuts its wire bytes 4x by reducing int8 instead
of f32:

  1. add the carried error-feedback residual to the local gradient;
  2. share one absmax scale per leaf across the pod group (``all_reduce``
     MAX), so every pod quantizes onto the same grid and the int8 payloads
     sum exactly as integers (int32 accumulation);
  3. keep the local quantization error as the new residual, applied again
     next step (error feedback: the noise averages out over steps instead
     of biasing the trajectory).

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives
gloo runs on CUDA tensors, which is how two ranks share one card.

Residual contract (the reference's): the residual is per-pod local state,
never reduced.  Its global form is the stacked tree of
:func:`init_residual`, every leaf ``(num_pods, *grad.shape)`` float32, pod
``p`` owning row ``p``; a rank holds its own row as ``(1, *shape)``.  On a
pod-count change :func:`reshard_residual` starts every new pod from the
mean of the old pods' residuals, which preserves ``Σ_p e_p / n``, the only
pod aggregate the compressed all-reduce folds into the trajectory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Logical cross-pod wire format of ``compressed_psum_mean``: one int8 an
# element plus one f32 absmax a leaf (the reference's constants).
WIRE_BYTES_PER_ELEM = 1
WIRE_SCALE_BYTES_PER_LEAF = 4
EXACT_BYTES_PER_ELEM = 4          # f32 all-reduce payload


def _group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def psum_mean(tree: dict, group=None) -> dict:
    """Exact mean of every leaf over the ranks of ``group``."""
    n = _group_size(group)
    out = {}
    for k, g in tree.items():
        t = g.clone()
        if n > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        out[k] = t / n
    return out


def compressed_psum_mean(tree: dict, group=None, err: dict | None = None,
                         scale_groups: dict | None = None,
                         amax_groups=()):
    """int8 + error-feedback mean over the ranks of ``group``.

    ``err``: the residual of the previous step (leaf-shaped f32, or None →
    zeros).  ``scale_groups``: leaf name → key; leaves with one key share
    one absmax scale (the reference's leaves stack a stage's layers, so one
    of its scales covers every layer of the stack; the trainer passes that
    grouping), each leaf its own without.  Returns ``(mean, new_err)``.
    The worst per-element error of the mean is half an int8 step of the
    group-wide absmax, and the residual carries it into the next step.
    One ``all_reduce`` (MAX) carries every scale, one (SUM) a leaf the
    int8 payloads.

    ``amax_groups``: process groups the leaves are sharded over within a
    pod (a tensor-parallel step passes each rank's local shards): the
    scales are max-reduced over them too, so each scale is the absmax of
    the whole leaf (of the leaves of its key), as the reference's, and
    the ranks holding one leaf's shards quantize onto one grid.  A
    replicated leaf has the same absmax on every rank there, so one MAX
    over the pod's ranks serves every leaf."""
    n = _group_size(group)
    names = list(tree)

    def total(k):
        # t = g + e, made once a pass and a leaf (two f32 copies of every
        # gradient at once would not fit beside a large model's state)
        t = tree[k].to(torch.float32)
        if err is not None and err.get(k) is not None:
            t = t + err[k].to(torch.float32)
        return t

    keys = [scale_groups.get(k, k) if scale_groups else k for k in names]
    slots = {key: i for i, key in enumerate(dict.fromkeys(keys))}
    dev = tree[names[0]].device if names else None
    amax = torch.zeros(len(slots), dtype=torch.float32, device=dev)
    for k, key in zip(names, keys):
        if tree[k].numel():
            i = slots[key]
            amax[i] = torch.maximum(amax[i], total(k).abs().max())
    for g in amax_groups:
        if _group_size(g) > 1 and names:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    if n > 1 and names:
        # one shared grid across the group: the integer sum is exact
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scales = torch.clamp_min(amax, 1e-30) / 127.0
    n_t = torch.tensor(float(n), dtype=torch.float32, device=dev)
    means, errs = {}, {}
    for k, key in zip(names, keys):
        t, scale = total(k), scales[slots[key]]
        # torch.round is half-to-even, as jnp.round
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        errs[k] = t - q.to(torch.float32) * scale
        del t
        summed = q.to(torch.int32)
        if n > 1:
            dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        means[k] = (summed.to(torch.float32) * (scale / n_t)).to(
            tree[k].dtype)
    return means, errs


def init_residual(grad_tree: dict, num_pods: int) -> dict:
    """Zero residual in the stacked global form: every leaf ``(num_pods,
    *leaf.shape)`` float32, on the leaf's device."""
    return {k: torch.zeros((num_pods, *g.shape), dtype=torch.float32,
                           device=g.device)
            for k, g in grad_tree.items()}


def reshard_residual(residual: dict, num_pods: int) -> dict:
    """A stacked residual at another pod count.  The same count comes back
    untouched (bitwise restarts); another count starts every new pod from
    the old pods' mean, which preserves ``Σ_p e_p / n``."""
    out = {}
    for k, e in residual.items():
        if e.shape[0] == num_pods:
            out[k] = e
            continue
        mean = e.to(torch.float32).mean(dim=0, keepdim=True)
        out[k] = mean.expand(num_pods, *e.shape[1:]).clone()
    return out

"""Per-device cost of one step, counted as it runs.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
compiles each dry-run cell and parses XLA's partitioned HLO: per-device
shapes, dot FLOPs weighted by loop trip counts, each collective's result
bytes.  The port compiles nothing, so there is no HLO to parse.  Instead
:class:`CostRecorder`, a ``TorchDispatchMode``, records every op the step
dispatches, *below* ``DTensor``: it gives a ``DTensor`` op back
(``NotImplemented``), ``DTensor`` applies its sharding rule and runs the
rank's local op, and that local op, like every ``_c10d_functional``
collective of a redistribution, reaches the recorder with this rank's
local shapes.  Eager execution runs every loop trip, so no trip weighting
is needed.  Per op it keeps:

* FLOPs, from ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention kernels; elementwise ops count 0, like the
  reference's dot FLOPs);
* bytes accessed: the bytes of its tensor inputs plus its outputs;
* for a collective, its result bytes.

The step may run on ``meta`` tensors (the dry run's stand-ins: shapes and
dtypes, no memory), on real tensors, or on ``DTensor`` s of either; the
records are the same ops with the same shapes.  Ops that run while a
``FakeTensorMode`` is on the mode stack are ``DTensor``'s shape
propagation (it runs each new op once on global-shaped stand-ins), not
work of the step, and are left out; so are ``prim`` queries
(``prim.device``).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

# Ring wire bytes per result byte, the reference's conventions
# (``hlo_analysis._WIRE_FACTOR``): an all-reduce moves its result twice.
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# torch's functional collectives → the reference's HLO op names.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = ("_c10d_functional", "c10d_functional")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op on this rank."""

    op: str             # "aten.mm.default", "_c10d_functional.all_reduce..."
    flops: float
    bytes: int          # tensor inputs + outputs
    out_bytes: int
    collective: str | None = None   # the reference's name, for collectives


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostRecorder(TorchDispatchMode):
    """Records :class:`OpRecord` s of every op dispatched inside it (see the
    module docstring); ``records`` holds them in order."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._fake_mode = FakeTensorMode
        self._flops = flop_registry
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # DTensor runs it and its local op
        out = func(*args, **kwargs)
        if func.namespace == "prim" or any(
                isinstance(m, self._fake_mode)
                for m in _get_current_dispatch_mode_stack()):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        formula = self._flops.get(func.overloadpacket)
        flops = (float(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0.0)
        out_bytes = sum(_nbytes(t) for t in outs)
        kind = (_COLLECTIVES.get(func.overloadpacket.__name__)
                if func.namespace in _C10D else None)
        self.records.append(OpRecord(
            str(func), flops, sum(_nbytes(t) for t in ins) + out_bytes,
            out_bytes, kind))
        return out


def collective_stats(records) -> dict:
    """Wire bytes and counts of the collectives in ``records``, with the
    reference's ring conventions and keys (``bytes_by_op``,
    ``count_by_op``, ``total_wire_bytes_per_device``)."""
    per_op: dict[str, float] = {}
    count: dict[str, int] = {}
    for r in records:
        if r.collective is None:
            continue
        per_op[r.collective] = (per_op.get(r.collective, 0.0)
                                + r.out_bytes * _WIRE_FACTOR.get(r.collective,
                                                                 1.0))
        count[r.collective] = count.get(r.collective, 0) + 1
    return {"bytes_by_op": per_op, "count_by_op": count,
            "total_wire_bytes_per_device": sum(per_op.values())}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def summarize_step(records, args=(), outputs=None) -> dict:
    """Cost summary of one recorded step, with the keys of the reference's
    ``summarize_compiled`` that ``CostCell.from_dryrun`` and the dry run's
    log read: ``flops_per_device``, ``bytes_accessed_per_device``,
    ``weighted`` (``dot_flops_per_device``, ``dot_bytes_per_device``,
    ``total_wire_bytes_per_device``),
    ``collectives`` and ``memory``.

    ``memory`` holds the bytes of rank 0's shards of the step's arguments
    and outputs, and of the outputs that are arguments updated in place
    (``alias_size_in_bytes``).  ``temp_size_in_bytes`` and
    ``generated_code_size_in_bytes`` are None: they come from a compiler's
    buffer assignment, which an eager step on fake tensors does not have
    (fake tensors hold no memory, so there is no peak to read either).
    ``ops`` / ``ops_by_name`` count the recorded ops."""
    records = list(records)
    coll = collective_stats(records)
    flops = float(sum(r.flops for r in records))
    arg_leaves = _leaves(list(args))
    out_leaves = _leaves(outputs)
    arg_ids = {id(t) for t in arg_leaves}
    return {
        "flops_per_device": flops,
        "bytes_accessed_per_device": float(sum(r.bytes for r in records)),
        # eager execution counts every loop trip: nothing to weight
        "weighted": {
            "dot_flops_per_device": flops,
            # the operands and results of the ops that count FLOPs (the
            # reference's dots)
            "dot_bytes_per_device": float(sum(r.bytes for r in records
                                              if r.flops)),
            "total_wire_bytes_per_device": coll["total_wire_bytes_per_device"],
        },
        "collectives": coll,
        "memory": {
            "temp_size_in_bytes": None,
            "argument_size_in_bytes": sum(_nbytes(_local(t))
                                          for t in arg_leaves),
            "output_size_in_bytes": sum(_nbytes(_local(t))
                                        for t in out_leaves),
            "alias_size_in_bytes": sum(_nbytes(_local(t)) for t in out_leaves
                                       if id(t) in arg_ids),
            "generated_code_size_in_bytes": None,
        },
        "ops": len(records),
        "ops_by_name": dict(Counter(r.op for r in records)),
    }

"""Exec_TID cost-model registry: dry-run cells → per-replica service times.

The paper's HEFT_RT quality hinges on the accuracy of the per-PE execution
time table (``Exec_TID``) fed to the EFT selector — HTS and DS3 both couple
the hardware scheduler to *measured* per-resource cost tables rather than
analytic guesses.  This module is the serving-layer analogue: the compiled
cost analyses of the reference's dry run (``repro.launch.dryrun.dryrun_cell``:
XLA FLOPs, bytes accessed, collective wire bytes per (arch × shape × mesh)
cell, saved as ``cell_path`` JSON artifacts) are materialized into :class:`CostCell` entries, and :class:`CostModelRegistry`
turns them into the (N, P) Exec_TID matrix the
:class:`~repro_torch.sched_integration.fabric.MappingFabric` consumes.

Per-request estimate for a replica whose (arch, mesh) is covered::

    prefill_s = prefill_tokens · cell_p.flops_per_token  / (compute_tflops·1e12)
    decode_s  = decode_tokens  · cell_d.bytes_per_token  / (hbm_gbps·1e9)
    wire_s    = Σ tokens · cell.wire_bytes_per_token     / (ici_gbps·1e9)

where ``*_per_token`` are the cell's *global* per-token costs (per-device
cost × mesh devices ÷ tokens the cell's step processes).  Replicas whose
(arch, kind, mesh_shape) cells are missing fall back to the analytic roofline
(:func:`~repro_torch.sched_integration.fabric.service_time_matrix`) — bitwise
identical to the registry-free path, so a partially-populated registry only
ever *refines* columns of the exec matrix.

PyTorch port of ``repro.sched_integration.cost_model`` (numpy, unchanged but
for its imports and the mesh descriptor it reads: a torch ``DeviceMesh``).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.sched_integration.fabric import service_time_matrix

_SERVE_KINDS = ("prefill", "decode")


def _mesh_shape_of(mesh) -> tuple[int, ...]:
    """Normalize a mesh descriptor to a tuple of ints.

    Accepts a tuple/list of ints, an ``AxBxC`` string (the dry-run artifact
    form), or a torch ``DeviceMesh`` (via the shape of its ``mesh`` tensor of
    ranks, as the reference reads a ``jax.sharding.Mesh``'s
    ``devices.shape``).
    """
    if mesh is None:
        raise ValueError("mesh shape is required")
    if isinstance(mesh, str):
        return tuple(int(d) for d in mesh.lower().split("x"))
    if hasattr(mesh, "mesh"):
        return tuple(int(d) for d in mesh.mesh.shape)
    return tuple(int(d) for d in mesh)


@dataclass(frozen=True)
class CostCell:
    """One (arch × kind × mesh) dry-run cost cell, per-token normalized.

    ``flops_per_device`` / ``bytes_per_device`` / ``wire_bytes_per_device``
    are one compiled step's per-device costs (the dry-run convention);
    ``tokens_per_step`` is how many *global* tokens that step processes
    (batch × seq for prefill, batch for a one-token decode step).
    """

    arch: str
    kind: str                       # 'prefill' | 'decode'
    mesh_shape: tuple[int, ...]
    tokens_per_step: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float = 0.0
    projected: bool = False         # scaled_cell output, not a measurement

    def __post_init__(self):
        if self.kind not in _SERVE_KINDS:
            raise ValueError(f"kind must be one of {_SERVE_KINDS}, "
                             f"got {self.kind!r}")
        if self.tokens_per_step <= 0:
            raise ValueError("tokens_per_step must be positive")
        object.__setattr__(self, "mesh_shape", _mesh_shape_of(self.mesh_shape))

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh_shape)

    # global cost per token of the workload this cell models
    @property
    def flops_per_token(self) -> float:
        return self.flops_per_device * self.num_devices / self.tokens_per_step

    @property
    def bytes_per_token(self) -> float:
        return self.bytes_per_device * self.num_devices / self.tokens_per_step

    @property
    def wire_bytes_per_token(self) -> float:
        return (self.wire_bytes_per_device * self.num_devices
                / self.tokens_per_step)

    @classmethod
    def from_dryrun(cls, cell: dict) -> "CostCell | None":
        """Build a cell from one ``dryrun_cell`` result dict (a ``cell_path``
        JSON artifact).  Returns None for cells the serving path cannot use
        (train shapes, failed compiles)."""
        if "error" in cell:
            return None
        from repro_torch.models.config import SHAPES  # lazy: keep import light

        shape = SHAPES.get(cell.get("shape"))
        if shape is None or shape.kind not in _SERVE_KINDS:
            return None
        tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                       else 1)
        coll = cell.get("collectives") or {}
        return cls(
            arch=cell["arch"],
            kind=shape.kind,
            mesh_shape=_mesh_shape_of(cell["mesh"]),
            tokens_per_step=tokens,
            flops_per_device=float(cell.get("flops_per_device", 0.0)),
            bytes_per_device=float(cell.get("bytes_accessed_per_device", 0.0)),
            wire_bytes_per_device=float(
                coll.get("total_wire_bytes_per_device", 0.0)),
        )


class CostModelRegistry:
    """(arch × kind × mesh_shape) → :class:`CostCell` lookup table.

    Populated from dry-run results (the reference's
    ``repro.launch.dryrun.dryrun_cell``), their ``cell_path`` JSON
    artifacts, or hand-built cells (tests /
    benchmarks).  Consumed by :func:`exec_tid_matrix` (fleet simulation) and
    :meth:`column_s` (live serve front-end).
    """

    def __init__(self, cells=()):
        self._cells: dict[tuple[str, str, tuple[int, ...]], CostCell] = {}
        for c in cells:
            self.register(c)

    def __len__(self) -> int:
        return len(self._cells)

    def register(self, cell: CostCell) -> CostCell:
        self._cells[(cell.arch, cell.kind, cell.mesh_shape)] = cell
        return cell

    def register_dryrun(self, cell_dict: dict) -> CostCell | None:
        cell = CostCell.from_dryrun(cell_dict)
        if cell is not None:
            self.register(cell)
        return cell

    def load_file(self, path: str) -> CostCell | None:
        """Ingest one ``cell_path`` JSON artifact."""
        with open(path) as f:
            return self.register_dryrun(json.load(f))

    def load_dir(self, artifact_dir: str) -> int:
        """Ingest every ``*.json`` cell artifact under ``artifact_dir``;
        returns how many serving-usable cells were registered."""
        n = 0
        if not os.path.isdir(artifact_dir):
            return 0
        for name in sorted(os.listdir(artifact_dir)):
            if name.endswith(".json"):
                if self.load_file(os.path.join(artifact_dir, name)) is not None:
                    n += 1
        return n

    def cell(self, arch, kind, mesh_shape) -> CostCell | None:
        if arch is None or mesh_shape is None:
            return None
        return self._cells.get((arch, kind, _mesh_shape_of(mesh_shape)))

    def covers(self, replica) -> bool:
        """Both serve cells present for this replica's (arch, mesh_shape)."""
        arch = getattr(replica, "arch", None)
        mesh_shape = getattr(replica, "mesh_shape", None)
        return all(self.cell(arch, k, mesh_shape) is not None
                   for k in _SERVE_KINDS)

    def ensure_coverage(self, replica, *, efficiency: float = 0.9) -> bool:
        """Cover a replica whose mesh shape was never dry-run by projection.

        Elastic resize events add replicas with shapes that may have no
        measured cells yet; rather than dropping those columns to the blank
        roofline, the arch's *largest* measured cell per kind is projected
        onto the new shape with :func:`scaled_cell` (the measured anchor
        plus the ``efficiency`` overhead gradient).  Cells that are
        themselves projections are never used as anchors — otherwise the
        discount would compound and the estimates would depend on join
        order.  Registration is atomic: either both serve kinds end up
        covered or nothing is registered.  Returns whether the replica is
        covered afterwards.
        """
        arch = getattr(replica, "arch", None)
        mesh_shape = getattr(replica, "mesh_shape", None)
        if arch is None or mesh_shape is None:
            return False
        target = _mesh_shape_of(mesh_shape)
        missing = [k for k in _SERVE_KINDS
                   if (arch, k, target) not in self._cells]
        if not missing:
            return True
        chosen = {}
        for kind in missing:
            srcs = [c for (a, k, _), c in self._cells.items()
                    if a == arch and k == kind and not c.projected]
            if not srcs:
                return False
            chosen[kind] = max(srcs, key=lambda c: (c.num_devices,
                                                    c.mesh_shape))
        for src in chosen.values():
            self.register(scaled_cell(src, target, efficiency=efficiency))
        return True

    # -- estimates -----------------------------------------------------------

    def column_s(self, replica, prefill_tokens, decode_tokens):
        """Exec_TID column for one replica, vectorized over requests.

        ``prefill_tokens`` / ``decode_tokens``: float64 arrays (N,).  Returns
        seconds (N,), or None when the replica's cells (or hardware rates)
        are missing — callers fall back to their analytic estimate.
        """
        arch = getattr(replica, "arch", None)
        mesh_shape = getattr(replica, "mesh_shape", None)
        compute = getattr(replica, "compute_tflops", None)
        hbm = getattr(replica, "hbm_gbps", None)
        cp = self.cell(arch, "prefill", mesh_shape)
        cd = self.cell(arch, "decode", mesh_shape)
        if cp is None or cd is None or not compute or not hbm:
            return None
        pf = np.asarray(prefill_tokens, dtype=np.float64)
        dc = np.asarray(decode_tokens, dtype=np.float64)
        t = (pf * cp.flops_per_token / (compute * 1e12)
             + dc * cd.bytes_per_token / (hbm * 1e9))
        ici = getattr(replica, "ici_gbps", 0.0) or 0.0
        if ici > 0:
            t = t + (pf * cp.wire_bytes_per_token
                     + dc * cd.wire_bytes_per_token) / (ici * 1e9)
        return t

    def exec_tid_matrix(self, requests, replicas, *,
                        active_params: float) -> np.ndarray:
        """Full (N, P) Exec_TID matrix: cost-model columns where covered,
        analytic roofline (bitwise ``service_time_matrix``) elsewhere."""
        ex = service_time_matrix(requests, replicas,
                                 active_params=active_params)
        pf = np.array([r.prefill_tokens for r in requests], dtype=np.float64)
        dc = np.array([r.decode_tokens for r in requests], dtype=np.float64)
        for j, rep in enumerate(replicas):
            col = self.column_s(rep, pf, dc)
            if col is not None:
                ex[:, j] = col
        return ex


def registry_from_dryrun_artifacts(artifact_dir: str | None = None
                                   ) -> CostModelRegistry:
    """Registry seeded from the dry-run artifact directory (default: the
    repo's ``experiments/artifacts/dryrun``), empty if none exist."""
    if artifact_dir is None:
        artifact_dir = os.path.join(
            os.path.dirname(__file__), "..", "..", "..",
            "experiments", "artifacts", "dryrun")
    reg = CostModelRegistry()
    reg.load_dir(artifact_dir)
    return reg


def scaled_cell(cell: CostCell, mesh_shape, *, efficiency: float = 1.0
                ) -> CostCell:
    """Project a measured cell onto another mesh shape of the same arch.

    Per-device compute/memory cost scales inversely with device count, with
    ``efficiency`` ≤ 1 modelling the overhead gradient across mesh sizes:
    scaling *up* inflates the projected per-token cost by 1/efficiency (the
    larger mesh pays more collective overhead than the measured point),
    scaling *down* deflates it by efficiency (the smaller mesh sheds
    overhead the measurement included).  Wire bytes per device are kept
    as-is — a conservative stand-in until the target cell is dry-run for
    real.  Used to seed heterogeneous-fleet registries from a single
    measured cell.
    """
    target = _mesh_shape_of(mesh_shape)
    n_target = math.prod(target)
    ratio = cell.num_devices / n_target
    if n_target > cell.num_devices:
        ratio /= efficiency
    elif n_target < cell.num_devices:
        ratio *= efficiency
    return replace(
        cell, mesh_shape=target,
        flops_per_device=cell.flops_per_device * ratio,
        bytes_per_device=cell.bytes_per_device * ratio,
        wire_bytes_per_device=cell.wire_bytes_per_device,
        projected=True,
    )

"""Process groups and meshes: the world, debug meshes and disjoint slices.

Counterpart of ``repro.launch.mesh``.  In the reference one controller
drives ``W`` devices; here a mesh over ``W`` devices is ``W`` processes
(SPMD), as ``torch.distributed`` requires, each naming its place by global
rank.  :func:`init_world` joins the world: ``RANK`` / ``WORLD_SIZE`` as
``torchrun`` sets them, or a world of one process without them.  The
backend is always the caller's: ``nccl`` on the card, ``gloo`` on the CPU
(and for several ranks that share one card, which NCCL refuses).

Creating a mesh creates its process groups, and ``new_group`` is
collective over the whole world: every rank builds every mesh, in the same
order, including the meshes it is not part of (it then holds no shards of
their tensors).

The production meshes (:func:`make_production_mesh`, 256 or 512 devices)
are for the dry run: they live on a process group of the ``fake``
backend (:func:`init_fake_world`), whose ranks exist only as numbers and
whose collectives return at once, with this process as rank 0.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.dist.sharding import MeshAxes


def init_world(backend: str, *, device=None) -> tuple[int, int]:
    """Join the process group once; returns ``(rank, world_size)``.

    Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` set) the
    group comes from the environment; without them it is a world of one
    process over an in-memory store.  With ``nccl`` the process takes the
    card ``LOCAL_RANK`` names (``device`` otherwise)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        dev = resolve_device(device)
        torch.cuda.set_device(
            int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
            else dev.index if dev.index is not None
            else torch.cuda.current_device())
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()


def init_fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``fake``-backend world of
    ``world_size`` ranks: collectives return at once and move nothing, so
    a step on fake tensors runs as rank 0 of a mesh of any size.  A fake
    world of another size is replaced (its meshes become stale); a real
    world raises, since the two cannot share a process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"this process is in a {dist.get_backend()!r} world; a fake "
                f"world needs a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``, on a
    fake world of 256 or 512 ranks (:func:`init_fake_world`).  The mesh is
    of CUDA devices, as a deployment's is (``DTensor`` picks its
    collectives by device type: on a CPU mesh an all-to-all becomes an
    all-gather); no card is needed, since nothing runs on one.  A function,
    not a module constant: importing this module joins no world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world(math.prod(shape))
    return make_debug_mesh(shape, axes, device="cuda")


def mesh_axes(*, multi_pod: bool = False) -> MeshAxes:
    return MeshAxes(pod="pod" if multi_pod else None)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), devices=None, *,
                    device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the global ranks
    ``devices`` (``range(prod(shape))`` by default), on ``device``'s type
    (the card unless told otherwise).  Collective over the world."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    ranks = list(range(n)) if devices is None else [int(r) for r in devices]
    if len(ranks) != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, got "
                         f"{len(ranks)}")
    return DeviceMesh(resolve_device(device).type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axes))


def slice_device_pool(shapes, axes=("data", "model"), devices=None, *,
                      allow_remainder: bool = True,
                      return_remainder: bool = False, device=None):
    """Partition the world's ranks into disjoint mesh slices, one a shape.

    ``shapes=[(1, 1), (2, 1), (2, 2)]`` carves 7 ranks into three replicas
    of mixed size.  A pool too small raises with the shortfall; ranks left
    over come back with ``return_remainder=True`` and raise with
    ``allow_remainder=False``.  ``devices`` is the pool of global ranks (the
    whole world by default).  Collective over the world."""
    if devices is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        pool = list(range(world))
    else:
        pool = list(devices)
    need = sum(math.prod(s) for s in shapes)
    if need > len(pool):
        raise ValueError(
            f"device pool oversubscribed: shapes {list(shapes)} need {need} "
            f"devices but the pool has only {len(pool)} ({need - len(pool)} "
            f"short) — drop a slice, shrink a shape, or grow the pool")
    meshes, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        meshes.append(make_debug_mesh(tuple(shape), axes, pool[off:off + n],
                                      device=device))
        off += n
    remainder = pool[off:]
    if remainder and not allow_remainder:
        raise ValueError(
            f"shapes {list(shapes)} use {off} of {len(pool)} devices, "
            f"leaving {len(remainder)} unused — pass allow_remainder=True "
            f"to keep the spares (return_remainder=True hands them back "
            f"for re-carving)")
    if return_remainder:
        return meshes, remainder
    return meshes

"""repro_torch.dist — the sharded execution substrate under the scheduler.

Counterpart of ``repro.dist`` on ``torch.distributed``: a mesh is a
``DeviceMesh`` over one process a device, a sharded tensor a ``DTensor``.
Three layers:

* :mod:`repro_torch.dist.sharding` — spec trees (:class:`P`) for params,
  optimizer moments, caches and batches, the activation hint policy, and
  ``named`` / ``reshard_tree`` to place trees on a mesh;
* :mod:`repro_torch.dist.hints` — the ``sharding_policy`` context and the
  ``shard_hint(x, name)`` sites inside the model blocks: exact identities
  without a policy or on plain tensors;
* :mod:`repro_torch.dist.compression` — ``psum_mean`` and the int8 +
  error-feedback ``compressed_psum_mean`` over a pod process group, with
  the residual helpers ``init_residual`` / ``reshard_residual``.

Axis conventions are the reference's: ``pod`` (outer data parallelism over
slow links; params replicate over it), ``data`` (data parallelism and the
FSDP axis of the weights), ``model`` (tensor parallelism: heads, FFN
hidden, Mamba d_inner, experts, vocab).
"""

from __future__ import annotations

from repro_torch.dist.compression import (
    compressed_psum_mean,
    init_residual,
    psum_mean,
    reshard_residual,
)
from repro_torch.dist.hints import current_policy, shard_hint, sharding_policy
from repro_torch.dist.sharding import (
    MeshAxes,
    P,
    activation_hint_policy,
    batch_pspec,
    cache_pspecs,
    named,
    opt_pspecs,
    param_pspecs,
    replica_pspecs,
    reshard_tree,
)

__all__ = [
    "MeshAxes", "P", "activation_hint_policy", "batch_pspec", "cache_pspecs",
    "compressed_psum_mean", "current_policy", "init_residual", "named",
    "opt_pspecs", "param_pspecs", "psum_mean", "replica_pspecs",
    "reshard_residual", "reshard_tree", "shard_hint", "sharding_policy",
]

"""repro_torch.analysis — the port's static design rules, machine-checked.

Counterpart of ``repro.analysis``, copied (it is ast-only) and pointed at
the port's tree: the conventions the port's hot paths depend on (no host
round-trips inside registered hot functions, the three mesh-axis names,
the ``shard_hint`` site inventory, event-schema / knob-doc coherence) are
enforced as AST-level lint rules instead of by review.

Entry point::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \
        --baseline tools/analysis_baseline_torch.json

Findings print as ``path:line:col: rule: message``; a non-baselined,
non-suppressed finding exits 1.  Per-line suppression is ``# repro:
noqa[rule-name]`` with a reason after the bracket, the same comment the
reference gate reads; grandfathered findings live in the baseline file
(matched on ``(rule, path, message)`` with counts).

Rules: ``host-sync-in-hot-path`` in torch terms (``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``float()`` / ``bool()`` / ``int()`` on a
possibly-device value, ``torch.cuda.synchronize()``, ``np.asarray`` of a
torch expression), ``sharding-axis``, ``hint-drift``,
``event-schema-drift`` and ``knob-doc-drift`` (over
``docs/knobs_torch.md``).

The reference's ``donation-after-use`` and ``retrace-hazard`` are not
here.  The first checks that a buffer passed in a ``jax.jit``
``donate_argnums`` position is not read again: XLA deletes a donated
buffer.  An eager PyTorch program donates nothing; the port updates state
in place (``out_avail=``, ``adamw_update``), and a stale read there is an
ordinary aliasing bug with no jit marker to key a rule on.  The second
checks for ``jax.jit`` of a callable made inside a loop and for bucket
sizes off the power-of-two grid, both of which make jax trace and compile
again; an eager program neither traces nor compiles, and the port's CUDA
kernels are built once per source (``kernels/_build.py``), whatever the
shapes.
"""

from repro_torch.analysis.findings import (Finding,  # noqa: F401
                                           apply_baseline, load_baseline,
                                           suppressed, write_baseline)
from repro_torch.analysis.registry import (AnalysisContext,  # noqa: F401
                                           Rule, all_rules, default_context,
                                           rule)
from repro_torch.analysis.runner import run_analysis  # noqa: F401

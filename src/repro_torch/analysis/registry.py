"""Rule registry + the analysis context rules read their configuration from.

Counterpart of ``repro.analysis.registry``.  Two rule scopes:

* ``file``  — ``fn(ctx, path, tree, lines) -> Iterable[Finding]``, called
  once per parsed source file.
* ``repo``  — ``fn(ctx) -> Iterable[Finding]``, called once per run; these
  rules cross files (site inventories, schema/validator pairs, docs).

Every repo-structure assumption lives on :class:`AnalysisContext` (hot
function registry, axis names, the paths of the hint inventory / event
module / launchers / knob docs), so the tests can point the same rules at
fixture trees.  :func:`default_context` points them at the port's tree
(``src/repro_torch/...``, ``docs/knobs_torch.md``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

# Functions registered *hot*: the steady-state serving inner loops.  Inside
# these, host round-trips are design-rule violations (rule
# host-sync-in-hot-path), not style nits.  The reference's names, then the
# port's own hot functions.  Extend per run with
# REPRO_TORCH_LINT_HOT=name1,name2.
DEFAULT_HOT_FUNCTIONS = frozenset({
    "decode_tick",      # serve/paging.py + serve/engine.py per-tick decode
    "decode_step",      # models/model.py decode
    "_decode",          # ServeEngine's decode closure
    "map_event",        # MappingFabric single-event dispatch
    "map_batch",        # MappingFabric batched dispatch
    "step",             # ServeEngine.step / scan steps
    "tick",             # the reference's paged tick body
    "schedule",         # HeftFrontEnd per-event mapping
    "tick_sched",           # the reference's fused tick
    "tick_sched_counted",   # ... with device counters
    "decision_ref",         # kernels/fused_decision plain decision body
    "tick_decision_inputs",  # fabric staging for the fused tick
    "commit_tick_decision",  # fabric adoption of fused-tick outputs
    # the port's own
    "_tick",            # serve/paging.py gather → decode_step → scatter
    "_lane_inputs",     # serve/paging.py the tick's lane upload
    "_upload_event",    # serve/paging.py the in-tick event's operands
    "decision_hw",      # kernels/ops.py the in-tick decision entry
    "fused_decision",   # kernels/fused_decision.py its wrapper
    "heft_fused",       # kernels/heft_fused.py its wrapper
    "launch_event",     # kernels/heft_fused.py the shared ctypes launch
    "_decide",          # MappingFabric's device decision
})

# The three logical mesh axes — the only names a ``P(...)`` literal outside
# dist/ may mention (rule sharding-axis).
DEFAULT_AXIS_NAMES = frozenset({"pod", "data", "model"})


@dataclass
class AnalysisContext:
    """Everything a rule needs to know about the tree under analysis."""

    root: Path                      # repo root (paths render relative to it)
    files: tuple[Path, ...]         # files file-scope rules run over
    hot_functions: frozenset = DEFAULT_HOT_FUNCTIONS
    axis_names: frozenset = DEFAULT_AXIS_NAMES
    # Path parts exempt from the sharding-axis rule (the distribution
    # substrate itself is where non-model axes are legitimately named).
    axis_exempt_parts: tuple = ("dist",)
    # Repo-scope rule anchors (None → that rule skips itself).
    hints_path: Path | None = None       # SITE_INVENTORY source
    models_dir: Path | None = None       # shard_hint call-site tree
    fleet_path: Path | None = None       # event dataclasses + validators
    launch_dir: Path | None = None       # argparse launchers
    knobs_md: Path | None = None         # docs/knobs_torch.md
    _sources: dict = field(default_factory=dict)

    def relpath(self, path) -> str:
        p = Path(path).resolve()
        try:
            return p.relative_to(self.root).as_posix()
        except ValueError:
            return p.as_posix()

    def source_lines(self, path) -> list[str]:
        """Cached physical lines of ``path`` (for noqa + repo-scope rules)."""
        p = Path(path).resolve()
        if p not in self._sources:
            self._sources[p] = p.read_text().splitlines()
        return self._sources[p]


def _iter_py(paths) -> list[Path]:
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


def default_context(root, paths=None, *,
                    hot_extra: Iterable[str] = ()) -> AnalysisContext:
    """The context for the port's layout (``src/repro_torch/...``).

    ``paths`` narrows which files the file-scope rules visit (default:
    ``<root>/src/repro_torch``); the repo-scope anchors always resolve
    against ``root`` and drop to None when absent, so the same function
    works on fixture trees.
    """
    root = Path(root).resolve()
    scan = [Path(p) for p in paths] if paths else [root / "src/repro_torch"]
    hot = set(DEFAULT_HOT_FUNCTIONS) | set(hot_extra)
    hot |= {h.strip() for h in
            os.environ.get("REPRO_TORCH_LINT_HOT", "").split(",")
            if h.strip()}

    def opt(p: Path):
        return p if p.exists() else None

    return AnalysisContext(
        root=root,
        files=tuple(_iter_py(scan)),
        hot_functions=frozenset(hot),
        hints_path=opt(root / "src/repro_torch/dist/hints.py"),
        models_dir=opt(root / "src/repro_torch/models"),
        fleet_path=opt(root / "src/repro_torch/sched_integration/fleet.py"),
        launch_dir=opt(root / "src/repro_torch/launch"),
        knobs_md=opt(root / "docs/knobs_torch.md"),
    )


@dataclass(frozen=True)
class Rule:
    name: str
    scope: str                      # "file" | "repo"
    doc: str
    fn: Callable


_RULES: dict[str, Rule] = {}


def rule(name: str, scope: str = "file"):
    """Register a rule under ``name`` (its docstring becomes the catalogue
    entry printed by ``--list-rules``)."""
    if scope not in ("file", "repo"):
        raise ValueError(f"rule scope must be file|repo, got {scope!r}")

    def deco(fn):
        if name in _RULES:
            raise ValueError(f"duplicate rule name {name!r}")
        _RULES[name] = Rule(name, scope, (fn.__doc__ or "").strip(), fn)
        return fn
    return deco


def all_rules() -> dict[str, Rule]:
    """The registry, with the built-in rule modules imported."""
    from repro_torch.analysis import rules_ast, rules_repo  # noqa: F401
    return dict(_RULES)

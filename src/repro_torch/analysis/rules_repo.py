"""Repo-scope rules: cross-file inventories and schema/validator pairs.

A copy of ``repro.analysis.rules_repo``; the anchors are the port's own
(``registry.default_context``).

These rules read their anchor paths from the :class:`AnalysisContext`
(``hints_path``/``models_dir``/``fleet_path``/``launch_dir``/``knobs_md``)
and skip silently when an anchor is absent — fixture trees exercise each
rule in isolation by populating only its anchors.
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule
from repro_torch.analysis.rules_ast import _dotted


def _parse(path: Path):
    return ast.parse(path.read_text(), filename=str(path))


def _module_files(root: Path):
    if root.is_file():
        return [root]
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


# ---------------------------------------------------------------------------
# hint-drift


def _find_assign(tree, name: str):
    """(value node, lineno) of a module-level ``NAME = ...`` assignment."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value, node.lineno
    return None, None


def _string_elts(node) -> list[str]:
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return []
    return [e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)]


@rule("hint-drift", scope="repo")
def hint_drift(ctx):
    """The ``shard_hint`` call sites across ``models/`` must biject with the
    ``SITE_INVENTORY`` tuple in ``dist/hints.py``: a site used but not
    inventoried is invisible to every sharding policy (silently identity —
    the layout constraint never applies); an inventoried site never used is
    dead policy surface that rots.  Non-literal site names defeat the
    inventory entirely."""
    if ctx.hints_path is None or ctx.models_dir is None:
        return
    hints_rel = ctx.relpath(ctx.hints_path)
    tree = _parse(ctx.hints_path)
    value, inv_line = _find_assign(tree, "SITE_INVENTORY")
    if value is None:
        yield Finding(hints_rel, 1, 0, "hint-drift",
                      "dist/hints.py defines no SITE_INVENTORY tuple — the "
                      "hint-site inventory the models must biject with")
        return
    inventory = set(_string_elts(value))
    used: dict[str, tuple[str, int, int]] = {}
    for path in _module_files(ctx.models_dir):
        rel = ctx.relpath(path)
        for node in ast.walk(_parse(path)):
            if not (isinstance(node, ast.Call) and _dotted(node.func)
                    and _dotted(node.func).split(".")[-1] == "shard_hint"):
                continue
            if len(node.args) < 2:
                continue
            site = node.args[1]
            if not (isinstance(site, ast.Constant)
                    and isinstance(site.value, str)):
                yield Finding(
                    rel, site.lineno, site.col_offset, "hint-drift",
                    "shard_hint site name is not a string literal — the "
                    "site inventory (and every policy dict keyed on it) "
                    "cannot see this site")
                continue
            used.setdefault(site.value, (rel, site.lineno, site.col_offset))
    for name in sorted(set(used) - inventory):
        rel, line, col = used[name]
        yield Finding(
            rel, line, col, "hint-drift",
            f"shard_hint site {name!r} is not in dist/hints.py "
            f"SITE_INVENTORY — no sharding policy will ever constrain it "
            f"(add it to the inventory + activation_hint_policy)")
    for name in sorted(inventory - set(used)):
        yield Finding(
            hints_rel, inv_line, 0, "hint-drift",
            f"SITE_INVENTORY names {name!r} but no shard_hint call in "
            f"models/ uses it — dead policy surface (remove it or wire the "
            f"site)")


# ---------------------------------------------------------------------------
# event-schema-drift


def _dataclass_fields(tree, cls_name: str):
    """(field names, lineno) of a dataclass's annotated fields."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            return fields, node.lineno
    return None, None


@rule("event-schema-drift", scope="repo")
def event_schema_drift(ctx):
    """The chaos/elastic event dataclasses in ``fleet.py`` and their JSON
    timeline validators must agree: ``FailureEvent``'s fields must equal
    ``_TIMELINE_FIELDS``'s keys exactly (a field the validator doesn't know
    rejects every timeline that sets it; a validator key the dataclass
    lacks crashes ``FailureEvent(**ev)``), ``_TIMELINE_REQUIRED`` must be a
    subset, and both event dataclasses must keep the shared unified-heap
    envelope (``t`` + ``reason``)."""
    if ctx.fleet_path is None:
        return
    rel = ctx.relpath(ctx.fleet_path)
    tree = _parse(ctx.fleet_path)

    fields, cls_line = _dataclass_fields(tree, "FailureEvent")
    schema, schema_line = _find_assign(tree, "_TIMELINE_FIELDS")
    required, req_line = _find_assign(tree, "_TIMELINE_REQUIRED")
    if fields is None or schema is None:
        yield Finding(rel, 1, 0, "event-schema-drift",
                      "fleet.py must define both the FailureEvent dataclass "
                      "and its _TIMELINE_FIELDS JSON validator schema")
        return
    keys = ([k.value for k in schema.keys
             if isinstance(k, ast.Constant) and isinstance(k.value, str)]
            if isinstance(schema, ast.Dict) else [])
    for name in sorted(set(fields) - set(keys)):
        yield Finding(
            rel, cls_line, 0, "event-schema-drift",
            f"FailureEvent field {name!r} is missing from _TIMELINE_FIELDS "
            f"— validate_failure_timeline rejects every JSON timeline that "
            f"sets it")
    for name in sorted(set(keys) - set(fields)):
        yield Finding(
            rel, schema_line, 0, "event-schema-drift",
            f"_TIMELINE_FIELDS key {name!r} is not a FailureEvent field — "
            f"FailureEvent(**ev) crashes on any timeline that uses it")
    if required is not None:
        for name in sorted(set(_string_elts(required)) - set(fields)):
            yield Finding(
                rel, req_line, 0, "event-schema-drift",
                f"_TIMELINE_REQUIRED names {name!r}, which FailureEvent "
                f"does not define")
    for cls in ("ResizeEvent", "FailureEvent"):
        cfields, cline = _dataclass_fields(tree, cls)
        if cfields is None:
            continue
        for envelope in ("t", "reason"):
            if envelope not in cfields:
                yield Finding(
                    rel, cline, 0, "event-schema-drift",
                    f"{cls} lost the shared timeline envelope field "
                    f"{envelope!r} — the unified simulate_serving event "
                    f"heap sorts/reports on it")


# ---------------------------------------------------------------------------
# knob-doc-drift (tools/check_docs.py folded into the framework)


def _launcher_flags(tree) -> list[tuple[str, int, int]]:
    """Every ``--flag`` string passed to an ``add_argument`` call."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            for arg in node.args:
                if (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)
                        and arg.value.startswith("--")):
                    out.append((arg.value, arg.lineno, arg.col_offset))
    return out


@rule("knob-doc-drift", scope="repo")
def knob_doc_drift(ctx):
    """Every launcher ``--flag`` (``add_argument`` calls under ``launch/``,
    parsed from the AST so commented-out flags don't count) must appear in
    the knob doc (``docs/knobs_torch.md`` for the port), so undocumented
    flags fail the gate.  The fix is always: document the flag in the same
    change that adds it."""
    if ctx.launch_dir is None or ctx.knobs_md is None:
        return
    knobs = ctx.knobs_md.read_text()
    checked = 0
    for path in _module_files(ctx.launch_dir):
        rel = ctx.relpath(path)
        for flag, line, col in _launcher_flags(_parse(path)):
            checked += 1
            if f"`{flag}`" not in knobs and flag not in knobs:
                yield Finding(
                    rel, line, col, "knob-doc-drift",
                    f"launcher flag {flag} is not documented in "
                    f"{ctx.relpath(ctx.knobs_md)}")
    if not checked:
        yield Finding(
            ctx.relpath(ctx.launch_dir), 1, 0, "knob-doc-drift",
            "found no launcher flags at all under launch/ — wrong tree?")

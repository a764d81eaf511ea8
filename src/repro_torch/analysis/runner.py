"""Drive the registered rules over an :class:`AnalysisContext`.

A copy of ``repro.analysis.runner``.

Separated from the CLI so tests (and the benchmark) call
:func:`run_analysis` directly on fixture contexts.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from repro_torch.analysis.findings import Finding, suppressed
from repro_torch.analysis.registry import AnalysisContext, all_rules


@dataclass
class AnalysisResult:
    findings: list[Finding] = field(default_factory=list)   # live, unsuppressed
    suppressed: list[Finding] = field(default_factory=list)  # noqa'd
    files: int = 0
    rules: tuple = ()


def run_analysis(ctx: AnalysisContext,
                 rule_names=None) -> AnalysisResult:
    """Run the selected rules (default: all) and fold in per-line noqa.

    A file that fails to parse yields one ``syntax-error`` finding — a
    design-rule checker that silently skips unparseable files would be a
    hole in the gate.
    """
    registry = all_rules()
    if rule_names:
        unknown = set(rule_names) - set(registry)
        if unknown:
            raise ValueError(
                f"unknown rule(s) {sorted(unknown)}; known: "
                f"{sorted(registry)}")
        selected = [registry[n] for n in rule_names]
    else:
        selected = list(registry.values())
    file_rules = [r for r in selected if r.scope == "file"]
    repo_rules = [r for r in selected if r.scope == "repo"]

    raw: list[Finding] = []
    # No file-scope rules selected → nothing needs parsing (repo-scope rules
    # read their anchors themselves); skip the per-file loop entirely.
    for path in (ctx.files if file_rules else ()):
        lines = ctx.source_lines(path)
        try:
            tree = ast.parse("\n".join(lines), filename=str(path))
        except SyntaxError as e:
            raw.append(Finding(ctx.relpath(path), e.lineno or 1, 0,
                               "syntax-error", f"file does not parse: "
                               f"{e.msg}"))
            continue
        for r in file_rules:
            raw.extend(r.fn(ctx, path, tree, lines))
    for r in repo_rules:
        raw.extend(r.fn(ctx))

    result = AnalysisResult(files=len(ctx.files),
                            rules=tuple(r.name for r in selected))
    for f in sorted(raw):
        try:
            lines = ctx.source_lines(ctx.root / f.path)
        except OSError:
            lines = []
        (result.suppressed if suppressed(f, lines)
         else result.findings).append(f)
    return result

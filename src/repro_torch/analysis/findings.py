"""Finding record, ``# repro: noqa[rule]`` suppression, baseline files.

A copy of ``repro.analysis.findings``: the suppression comment and the
baseline format are the reference gate's, so one ``noqa`` on a port line
answers both gates.

A finding's *baseline key* is ``(rule, path, message)`` — deliberately not
the line number, so grandfathered findings survive unrelated edits above
them, while a second instance of the same anti-pattern in the same file is
a new finding (counts are matched, not just membership).
"""

from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import asdict, dataclass

# `# repro: noqa[rule-a,rule-b]` with an optional free-form reason after the
# closing bracket (a reason is encouraged: the rule docs ask "why is this
# instance allowed?", and review reads it where the code lives).
NOQA_RE = re.compile(r"#\s*repro:\s*noqa\[([^\]]+)\]")

BASELINE_VERSION = 1


@dataclass(frozen=True, order=True)
class Finding:
    """One design-rule violation, anchored at a source location."""

    path: str       # repo-root-relative, posix separators
    line: int       # 1-indexed
    col: int        # 0-indexed (ast convention)
    rule: str
    message: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"

    def to_json(self) -> dict:
        return asdict(self)


def suppressed(finding: Finding, source_lines: list[str]) -> bool:
    """True when the finding's line carries ``# repro: noqa[<its rule>]``."""
    if not 1 <= finding.line <= len(source_lines):
        return False
    m = NOQA_RE.search(source_lines[finding.line - 1])
    if m is None:
        return False
    rules = {r.strip() for r in m.group(1).split(",")}
    return finding.rule in rules


def load_baseline(path) -> Counter:
    """Baseline file → Counter of finding keys (empty for a missing file,
    so a fresh checkout without the file just means 'no grandfathering')."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except FileNotFoundError:
        return Counter()
    if not isinstance(obj, dict) or "findings" not in obj:
        raise ValueError(f"baseline {path} is not a findings object")
    base: Counter = Counter()
    for entry in obj["findings"]:
        key = (entry["rule"], entry["path"], entry["message"])
        base[key] += int(entry.get("count", 1))
    return base


def apply_baseline(findings: list[Finding], baseline: Counter
                   ) -> tuple[list[Finding], int]:
    """Split findings into (new, grandfathered-count).

    Count-matched: a baseline entry with count 2 absorbs at most two live
    instances of that key — the third is new and gates.
    """
    budget = Counter(baseline)
    fresh = []
    absorbed = 0
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            absorbed += 1
        else:
            fresh.append(f)
    return fresh, absorbed


def write_baseline(path, findings: list[Finding]) -> None:
    """Serialize the current findings as the new grandfather baseline."""
    counts = Counter(f.key() for f in findings)
    entries = [{"rule": rule, "path": p, "message": msg, "count": n}
               for (rule, p, msg), n in sorted(counts.items())]
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION, "findings": entries}, f,
                  indent=1, sort_keys=False)
        f.write("\n")

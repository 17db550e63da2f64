"""Findings and reporters for the scenario lint (a copy of the
reference's ``repro.analysis.report``, whose schema disagglint shares).

A :class:`Finding` is one rule violation anchored at ``file:line``.  The
two reporters render a uniform result shape:

- :func:`render_text` — one ``file:line: severity: [rule] message`` line
  per finding plus a summary, the human-facing default.
- :func:`render_json` — a byte-stable JSON document (sorted findings,
  sorted keys) suitable for CI artifacts and machine diffing.

``repro_torch.serving.scenario``'s lint CLI reuses these for its
``--format json`` mode instead of growing a private serializer, so a CI
job consuming lint output parses one schema regardless of which linter
produced it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

SEVERITIES = ("error", "warning")


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at ``file:line``.

    ``file`` is the path relative to the lint root (posix separators),
    so reports are byte-stable regardless of where the tree is checked
    out.  The field order doubles as the sort order: findings group by
    file, then line, then rule.
    """
    file: str
    line: int
    rule: str
    message: str
    severity: str = "error"

    def to_dict(self) -> Dict[str, Any]:
        return {"file": self.file, "line": self.line, "rule": self.rule,
                "message": self.message, "severity": self.severity}

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.severity}: "
                f"[{self.rule}] {self.message}")


@dataclass
class LintResult:
    """The outcome of one lint run: surviving findings plus the
    bookkeeping a CI gate wants (files checked, suppression count)."""
    findings: List[Finding] = field(default_factory=list)
    files_checked: int = 0
    suppressed: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def exit_code(self) -> int:
        return 0 if self.ok else 1


def render_text(result: LintResult, tool: str = "disagglint") -> str:
    lines = [f.render() for f in sorted(result.findings)]
    n = len(result.findings)
    lines.append(
        f"[{tool}] {result.files_checked} file(s) checked: "
        f"{n} finding(s), {result.suppressed} suppressed"
        + (" — clean" if n == 0 else ""))
    return "\n".join(lines)


def render_json(result: LintResult, tool: str = "disagglint") -> str:
    doc = {
        "tool": tool,
        "files_checked": result.files_checked,
        "suppressed": result.suppressed,
        "findings": [f.to_dict() for f in sorted(result.findings)],
        "ok": result.ok,
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"

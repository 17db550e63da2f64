"""disagglint rule engine: project model, registry, suppressions, CLI
(the port's copy of ``repro.analysis.engine``, its rules scoped to
``src/repro_torch/``).

The engine parses every ``.py`` file under the given paths into a
:class:`Project` (one AST + source per :class:`Module`), runs every
registered :class:`Rule` over it, and filters the findings through
line-level suppressions.

**Rules** are project-scoped: each rule sees the whole :class:`Project`
and yields :class:`~repro_torch.analysis.report.Finding` objects, which lets
cross-module rules (event-registry sync, stats drift, CLI sync) relate
declarations in one file to their consumers in another.  Rules declare a
``scope`` of root-relative path prefixes; a module outside every prefix
is invisible to that rule, which is how e.g. the wall-clock ban applies
to ``src/`` but not to ``benchmarks/`` (whose whole point is wall-clock
timing).  Fixture tests exploit the same mechanism by laying out tiny
trees that mirror the scoped structure (``<tmp>/src/repro_torch/serving/…``).

**Suppressions** are per-line comments with a mandatory reason::

    risky_line()   # disagglint: disable=rule-id -- why this is safe

Multiple rules separate with commas.  A suppression without a reason is
itself a finding (``bad-suppression``) — the policy is that every
exception to an invariant carries its justification in the diff.
Comments are extracted with :mod:`tokenize`, so the directive inside a
string literal (docs, fixtures) is inert.

CLI::

    python -m repro_torch.analysis [paths...] [--format text|json] \
        [--root DIR]

Exit status is 0 iff no unsuppressed finding survived — the CI gate.
"""
from __future__ import annotations

import argparse
import ast
import io
import re
import sys
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.report import (Finding, LintResult, render_json,
                                   render_text)

SUPPRESS_RE = re.compile(
    r"#\s*disagglint:\s*disable=(?P<rules>[\w\-, ]+?)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$")


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: Optional[str]


@dataclass
class Module:
    """One parsed source file."""
    path: Path                  # absolute
    rel: str                    # posix path relative to the lint root
    source: str
    tree: ast.Module
    suppressions: List[Suppression] = field(default_factory=list)

    def suppression_at(self, line: int) -> Optional[Suppression]:
        for s in self.suppressions:
            if s.line == line:
                return s
        return None


@dataclass
class Project:
    """Everything one lint run can see: the root (for path scoping and
    sibling artifacts like ``docs/architecture.md``) plus the parsed
    modules."""
    root: Path
    modules: List[Module] = field(default_factory=list)

    def in_scope(self, module: Module, scope: Tuple[str, ...]) -> bool:
        if not scope:
            return True
        return any(module.rel.startswith(p) for p in scope)

    def scoped(self, scope: Tuple[str, ...]) -> List[Module]:
        return [m for m in self.modules if self.in_scope(m, scope)]

    def find_classes(self, name: str, scope: Tuple[str, ...] = ()
                     ) -> List[Tuple[Module, ast.ClassDef]]:
        """Every class definition with this name in ``scope`` (default:
        project-wide) — how the cross-module rules locate
        ``ScenarioEvent``/``ClusterStats``/``TimelineDispatcher``
        without hard-coding file paths (so fixture trees exercise them
        with toy look-alikes)."""
        out = []
        for m in self.scoped(scope):
            for node in ast.walk(m.tree):
                if isinstance(node, ast.ClassDef) and node.name == name:
                    out.append((m, node))
        return out


# ------------------------------------------------------------- registry
@dataclass(frozen=True)
class Rule:
    """One registered rule: id, one-line doc (the rule catalog), the
    root-relative path prefixes it applies to (empty = everywhere), and
    the check callable ``(project) -> iterable of findings``."""
    rule_id: str
    doc: str
    scope: Tuple[str, ...]
    check: Callable[[Project], Iterable[Finding]]


RULES: Dict[str, Rule] = {}


def register(rule_id: str, doc: str, scope: Tuple[str, ...] = ()):
    """Decorator: register ``fn(project) -> Iterable[Finding]`` under
    ``rule_id``.  Re-registration replaces (idempotent reloads)."""
    def deco(fn: Callable[[Project], Iterable[Finding]]):
        RULES[rule_id] = Rule(rule_id, doc, scope, fn)
        return fn
    return deco


def load_rules() -> Dict[str, Rule]:
    """Import every rule module (side effect: registration) and return
    the registry.  Deferred so ``engine`` <-> ``rules_*`` imports never
    cycle at module load."""
    from repro_torch.analysis import (  # noqa: F401
        rules_clock, rules_determinism, rules_frozen, rules_kernels,
        rules_registry)
    return RULES


# --------------------------------------------------------- suppressions
def parse_suppressions(source: str) -> Tuple[List[Suppression],
                                             List[Tuple[int, str]]]:
    """Extract ``# disagglint: disable=`` directives from COMMENT tokens
    only (a directive inside a string literal is inert).  Returns
    (suppressions, problems) where each problem is a (line, message)
    for a malformed/reasonless directive."""
    sups: List[Suppression] = []
    problems: List[Tuple[int, str]] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in toks
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return sups, problems
    for line, text in comments:
        if "disagglint" not in text:
            continue
        m = SUPPRESS_RE.search(text)
        if not m:
            problems.append(
                (line, "malformed disagglint directive (expected "
                       "'# disagglint: disable=<rule>[,<rule>] -- "
                       "<reason>')"))
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        reason = m.group("reason")
        if not reason:
            problems.append(
                (line, f"suppression of {', '.join(rules)} carries no "
                       f"reason — append ' -- <why this is safe>'"))
        sups.append(Suppression(line, rules, reason))
    return sups, problems


# -------------------------------------------------------------- loading
def _iter_py_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(q for q in p.rglob("*.py")
                                if "__pycache__" not in q.parts
                                and not any(part.startswith(".")
                                            for part in q.parts)))
        elif p.suffix == ".py" or p.is_file():
            files.append(p)
    # de-dup while preserving order (overlapping path args)
    seen = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def build_project(paths: Sequence[Path], root: Path
                  ) -> Tuple[Project, List[Finding]]:
    project = Project(root=root)
    findings: List[Finding] = []
    for f in _iter_py_files(paths):
        rel = _relpath(f, root)
        try:
            source = f.read_text()
        except OSError as e:
            findings.append(Finding(rel, 0, "parse-error",
                                    f"unreadable: {e}"))
            continue
        try:
            tree = ast.parse(source, filename=str(f))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 0, "parse-error",
                                    f"syntax error: {e.msg}"))
            continue
        sups, problems = parse_suppressions(source)
        for line, msg in problems:
            findings.append(Finding(rel, line, "bad-suppression", msg))
        project.modules.append(Module(f, rel, source, tree, sups))
    return project, findings


# ------------------------------------------------------------- the run
def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               only: Optional[Sequence[str]] = None) -> LintResult:
    """Run every registered rule over the ``.py`` files under ``paths``.

    ``root`` anchors rule scoping and relative paths in the report
    (default: the current working directory).  ``only`` restricts to a
    subset of rule ids (fixture tests isolate one rule at a time;
    ``bad-suppression``/``parse-error`` findings always survive)."""
    rules = load_rules()
    rootp = Path(root) if root is not None else Path.cwd()
    project, findings = build_project([Path(p) for p in paths], rootp)
    active = (rules.values() if only is None
              else [rules[r] for r in only])
    for rule in active:
        for f in rule.check(project):
            findings.append(f)
    # suppression filter: a finding on a line carrying a matching
    # disable directive is dropped (bad-suppression findings are not
    # themselves suppressible — the directive is the problem)
    by_rel = {m.rel: m for m in project.modules}
    kept: List[Finding] = []
    suppressed = 0
    for f in findings:
        mod = by_rel.get(f.file)
        sup = mod.suppression_at(f.line) if mod else None
        if (sup is not None and sup.reason
                and f.rule in sup.rules
                and f.rule not in ("bad-suppression", "parse-error")):
            suppressed += 1
            continue
        kept.append(f)
    return LintResult(findings=sorted(kept),
                      files_checked=len(project.modules),
                      suppressed=suppressed)


# ------------------------------------------------------------------ CLI
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="disagglint: determinism & clock-discipline linter")
    p.add_argument("paths", nargs="*", default=["src"],
                   help="files/directories to lint (default: src)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="report format (json is byte-stable: sorted "
                        "findings, sorted keys)")
    p.add_argument("--root", default=None,
                   help="scoping root for rule path prefixes and "
                        "report-relative paths (default: cwd)")
    p.add_argument("--only", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    args = p.parse_args(argv)
    if args.list_rules:
        for rid, rule in sorted(load_rules().items()):
            scope = ", ".join(rule.scope) if rule.scope else "everywhere"
            print(f"{rid:20s} [{scope}] {rule.doc}")
        return 0
    only = ([r.strip() for r in args.only.split(",") if r.strip()]
            if args.only else None)
    result = lint_paths(args.paths or ["src"], root=args.root, only=only)
    render = render_json if args.format == "json" else render_text
    sys.stdout.write(render(result)
                     if args.format == "json" else render(result) + "\n")
    return result.exit_code()

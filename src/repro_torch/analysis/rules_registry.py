"""Cross-module sync rules: event registry, stats drift, CLI drift.

Three places in this repo form implicit contracts between files that no
single-module check can see:

- ``registry-sync``: every ``ScenarioEvent`` subclass needs its serde
  tag (a ``kind`` ClassVar + membership in ``EVENT_TYPES``) *and* a
  dispatch arm (an ``isinstance`` check) inside ``TimelineDispatcher``.
  A subclass missing any leg round-trips through JSON but silently
  no-ops at dispatch, or vice versa.
- ``stats-drift``: every ``ClusterStats`` field must reach the
  serialization site (passed as a keyword at some ``ClusterStats(...)``
  call) and the docs table (``docs/architecture.md``).  A field that
  exists but is never populated reports a default forever.
- ``cli-sync``: every argparse flag in ``launch/`` must be consumed as
  ``args.<dest>``, and keywords passed to the spec constructors
  (``ScenarioSpec``/``Topology``/``Workload``/``ModelRef``/
  ``ClusterConfig``) must name real fields.

All anchors are located by NAME within the port's tree
(``src/repro_torch/``: the port's ``EVENT_TYPES``, ``ClusterStats`` and
``ModelStats``, even when the reference's sit in the same lint run),
never by file, so fixture trees with toy look-alikes exercise the rules
end to end.  Each check
degrades to silence when its anchors are absent from the lint set
(linting ``tests/`` alone should not fail for lack of ``scenario.py``).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.engine import Module, Project, register
from repro_torch.analysis.report import Finding

SPEC_CLASSES = ("ScenarioSpec", "Topology", "Workload", "ModelRef",
                "ClusterConfig")
#: where the cross-module rules look for their anchors and subjects
PORT = ("src/repro_torch/",)


def _class_field_names(project: Project, cls: ast.ClassDef,
                       mod: Module, depth: int = 0) -> Set[str]:
    """Annotated field names of a (data)class, walking name-resolvable
    base classes project-wide."""
    fields: Set[str] = set()
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name):
            fields.add(stmt.target.id)
    if depth < 4:
        for base in cls.bases:
            name = base.id if isinstance(base, ast.Name) else (
                base.attr if isinstance(base, ast.Attribute) else None)
            if not name:
                continue
            for bmod, bcls in project.find_classes(name, PORT):
                fields |= _class_field_names(project, bcls, bmod,
                                             depth + 1)
    return fields


def _subclasses_of(project: Project, base_name: str
                   ) -> List[Tuple[Module, ast.ClassDef]]:
    out = []
    for mod in project.scoped(PORT):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for b in node.bases:
                if (isinstance(b, ast.Name) and b.id == base_name) or (
                        isinstance(b, ast.Attribute)
                        and b.attr == base_name):
                    out.append((mod, node))
    return out


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _isinstance_targets(cls: ast.ClassDef) -> Set[str]:
    """Class names tested via isinstance(...) anywhere in the class
    body — the dispatch arms."""
    targets: Set[str] = set()
    for node in ast.walk(cls):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance"
                and len(node.args) == 2):
            targets |= _names_in(node.args[1])
    return targets


@register("registry-sync",
          "every ScenarioEvent subclass has a kind tag, an EVENT_TYPES "
          "entry, and a TimelineDispatcher arm", scope=PORT)
def check_registry_sync(project: Project) -> Iterable[Finding]:
    if not project.find_classes("ScenarioEvent", PORT):
        return
    subclasses = _subclasses_of(project, "ScenarioEvent")

    registry_names: Optional[Set[str]] = None
    for mod in project.scoped(PORT):
        for node in ast.walk(mod.tree):
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value:
                target, value = node.target, node.value
            else:
                continue
            if isinstance(target, ast.Name) and target.id == "EVENT_TYPES":
                registry_names = _names_in(value)

    dispatch_names: Optional[Set[str]] = None
    for _, cls in project.find_classes("TimelineDispatcher", PORT):
        dispatch_names = (dispatch_names or set()) | _isinstance_targets(cls)

    for mod, cls in subclasses:
        has_kind = any(
            (isinstance(s, ast.AnnAssign)
             and isinstance(s.target, ast.Name) and s.target.id == "kind")
            or (isinstance(s, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "kind"
                for t in s.targets))
            for s in cls.body)
        if not has_kind:
            yield Finding(
                mod.rel, cls.lineno, "registry-sync",
                f"ScenarioEvent subclass {cls.name} has no 'kind' "
                f"ClassVar — it cannot round-trip through "
                f"to_dict/from_dict")
        if registry_names is not None and cls.name not in registry_names:
            yield Finding(
                mod.rel, cls.lineno, "registry-sync",
                f"{cls.name} is missing from EVENT_TYPES — "
                f"from_dict cannot deserialize it")
        if dispatch_names is not None and cls.name not in dispatch_names:
            yield Finding(
                mod.rel, cls.lineno, "registry-sync",
                f"{cls.name} has no isinstance dispatch arm in "
                f"TimelineDispatcher — firing it would silently no-op")


STATS_CLASSES = ("ClusterStats", "ModelStats")


@register("stats-drift",
          "every ClusterStats/ModelStats field reaches serialization "
          "and the docs table", scope=PORT)
def check_stats_drift(project: Project) -> Iterable[Finding]:
    for stats_cls in STATS_CLASSES:
        hits = project.find_classes(stats_cls, PORT)
        if not hits:
            continue
        mod, cls = hits[0]
        fields = [s.target.id for s in cls.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]

        # serialization check: union of keywords over all
        # <StatsClass>(...) call sites (timeline.run populates every
        # field explicitly)
        kw_union: Set[str] = set()
        call_sites = 0
        for m in project.scoped(PORT):
            for node in ast.walk(m.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == stats_cls
                        and node.keywords):
                    call_sites += 1
                    kw_union |= {k.arg for k in node.keywords if k.arg}
        if call_sites:
            for f in fields:
                if f not in kw_union:
                    yield Finding(
                        mod.rel, cls.lineno, "stats-drift",
                        f"{stats_cls}.{f} is never passed at any "
                        f"{stats_cls}(...) call site — the field would "
                        f"report its default forever")

        docs = project.root / "docs" / "architecture.md"
        if docs.is_file():
            text = docs.read_text()
            for f in fields:
                if not re.search(rf"\b{re.escape(f)}\b", text):
                    yield Finding(
                        mod.rel, cls.lineno, "stats-drift",
                        f"{stats_cls}.{f} is missing from the "
                        f"docs/architecture.md field table")


def _add_argument_dests(mod: Module) -> List[Tuple[int, str]]:
    dests: List[Tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        dest = None
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = kw.value.value
        if dest is None:
            opts = [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)]
            longs = [o for o in opts if o.startswith("--")]
            if longs:
                dest = longs[0].lstrip("-").replace("-", "_")
            elif opts and not opts[0].startswith("-"):
                dest = opts[0]
        if dest and dest != "help":
            dests.append((node.lineno, dest))
    return dests


@register("cli-sync",
          "argparse flags in launch/ are consumed and spec-constructor "
          "keywords name real fields",
          scope=("src/repro_torch/launch/",))
def check_cli_sync(project: Project) -> Iterable[Finding]:
    spec_fields: Dict[str, Set[str]] = {}
    for name in SPEC_CLASSES:
        for cmod, cls in project.find_classes(name, PORT):
            spec_fields.setdefault(name, set()).update(
                _class_field_names(project, cls, cmod))

    for mod in project.scoped(("src/repro_torch/launch/",)):
        consumed = {node.attr for node in ast.walk(mod.tree)
                    if isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "args"}
        for lineno, dest in _add_argument_dests(mod):
            if dest not in consumed:
                yield Finding(
                    mod.rel, lineno, "cli-sync",
                    f"argparse flag with dest '{dest}' is never read as "
                    f"args.{dest} — dead flag or typo'd consumer")
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in spec_fields):
                continue
            fields = spec_fields[node.func.id]
            for kw in node.keywords:
                if kw.arg is not None and kw.arg not in fields:
                    yield Finding(
                        mod.rel, node.lineno, "cli-sync",
                        f"{node.func.id}(...) is passed unknown keyword "
                        f"'{kw.arg}' — not a declared field")

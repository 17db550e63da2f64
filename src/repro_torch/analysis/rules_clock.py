"""Clock discipline: no bare float ``==`` on ``*_s`` time values.

Simulated timestamps and durations are floats named with an ``_s``
suffix by repo convention.  Comparing them with ``==``/``!=`` outside an
``assert`` is almost always a latent epsilon bug — two causally-equal
times can differ in the last ulp once they flow through different
accumulation orders.  ``assert`` statements are exempt because the
repo's bitwise-parity claims are *intentionally* exact (depth-1 clock
parity, event-free baselines); an exact comparison inside an assert is
a declared invariant, not an accident.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import Project, register
from repro_torch.analysis.report import Finding

_SCOPE = ("src/repro_torch/",)


def _time_named(node: ast.AST) -> str:
    if isinstance(node, ast.Name) and node.id.endswith("_s"):
        return node.id
    if isinstance(node, ast.Attribute) and node.attr.endswith("_s"):
        return node.attr
    return ""


@register("clock-eq",
          "no bare float ==/!= on *_s time values outside assert",
          scope=_SCOPE)
def check_clock_eq(project: Project) -> Iterable[Finding]:
    for mod in project.scoped(_SCOPE):
        in_assert = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assert):
                for sub in ast.walk(node):
                    in_assert.add(id(sub))
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare) or id(node) in in_assert:
                continue
            if not any(isinstance(op, (ast.Eq, ast.NotEq))
                       for op in node.ops):
                continue
            sides = [node.left] + list(node.comparators)
            named = next((n for n in map(_time_named, sides) if n), "")
            if named:
                yield Finding(
                    mod.rel, node.lineno, "clock-eq",
                    f"exact ==/!= on time value '{named}': float "
                    f"equality on *_s values is epsilon-unsafe outside "
                    f"a declared-parity assert — compare with a "
                    f"tolerance or restructure")

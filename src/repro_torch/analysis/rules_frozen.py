"""Frozen-spec hygiene: ``object.__setattr__`` stays in ``__post_init__``.

The declarative layer (``ScenarioSpec``, events, ``UnitSpec``) is built
from frozen dataclasses precisely so a spec in flight cannot drift.  The
single sanctioned escape hatch is ``object.__setattr__`` inside
``__post_init__`` (dataclasses' own idiom for derived fields).  Anywhere
else it silently un-freezes an object that every downstream consumer
assumes immutable.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import Project, register
from repro_torch.analysis.report import Finding

_SCOPE = ("src/",)


@register("frozen-setattr",
          "object.__setattr__ only inside __post_init__",
          scope=_SCOPE)
def check_frozen_setattr(project: Project) -> Iterable[Finding]:
    for mod in project.scoped(_SCOPE):
        # lexical walk tracking the innermost enclosing function name
        def visit(node: ast.AST, fn_name: str):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn_name = node.name
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "__setattr__"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "object"
                    and fn_name != "__post_init__"):
                yield Finding(
                    mod.rel, node.lineno, "frozen-setattr",
                    "object.__setattr__ outside __post_init__ mutates a "
                    "frozen spec — construct a new instance "
                    "(dataclasses.replace) instead")
            for child in ast.iter_child_nodes(node):
                yield from visit(child, fn_name)

        yield from visit(mod.tree, "<module>")

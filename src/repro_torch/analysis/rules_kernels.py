"""Kernel hygiene: the discipline of the port's kernel wrappers.

The counterpart of the reference's ``rules_pallas`` (``pallas-hygiene``),
which holds every ``pallas_call`` to the CPU path (``interpret=``), no
Python branch on a Ref and static block shapes.  The port's kernels are
CUDA C++ behind the wrappers of ``kernels/ops.py``, whose docstring
states their discipline: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises, never falling back, the launch is
counted, and the CUDA branch refuses what a kernel cannot take (a
DTensor, an operand that requires grad).  This rule checks it,
content-gated on modules that define kernel wrappers (a module-level
``LAUNCHES``).  A wrapper is a function that dispatches on
``<tensor>.device.type == "cpu"``; its CUDA branch is every statement
outside that test's CPU body and outside the fake-operand path (an
``if`` on ``is_fake(...)``).  It flags a wrapper whose CUDA branch

- does not call ``refuse_dtensor`` and ``refuse_grad``;
- does not count ``LAUNCHES[...] += ...``;
- launches inside a ``try`` whose handler does not re-raise (the error
  swallowed: a silent fallback).
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.engine import Module, Project, register
from repro_torch.analysis.report import Finding

GUARDS = ("refuse_dtensor", "refuse_grad")


def _defines_launches(mod: Module) -> bool:
    for node in mod.tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "LAUNCHES"
               for t in targets):
            return True
    return False


def _is_cpu_test(test: ast.AST) -> bool:
    """``<x>.device.type == "cpu"``."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute)
            and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


def _is_fake_test(test: ast.AST) -> bool:
    return (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
            and test.func.id == "is_fake")


def _called(name: str, nodes: List[ast.AST]) -> bool:
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and (
                    (isinstance(node.func, ast.Name)
                     and node.func.id == name)
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr == name)):
                return True
    return False


def _counts_launch(nodes: List[ast.AST]) -> bool:
    for root in nodes:
        for node in ast.walk(root):
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Subscript)
                    and isinstance(node.target.value, ast.Name)
                    and node.target.value.id == "LAUNCHES"):
                return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _cuda_branch(fn: ast.FunctionDef) -> List[ast.AST]:
    """The wrapper's statements outside the CPU body and the fake path
    (empty when ``fn`` does not dispatch on the device)."""
    branch: List[ast.AST] = []
    dispatches = False
    for stmt in fn.body:
        if isinstance(stmt, ast.If) and _is_cpu_test(stmt.test):
            dispatches = True
            branch.extend(stmt.orelse)
        elif isinstance(stmt, ast.If) and _is_fake_test(stmt.test):
            branch.extend(stmt.orelse)
        else:
            branch.append(stmt)
    return branch if dispatches else []


@register("kernel-hygiene",
          "kernel wrappers: the CUDA branch refuses DTensors and "
          "grad-requiring operands, counts LAUNCHES, and never swallows "
          "a launch's error")
def check_kernels(project: Project) -> Iterable[Finding]:
    for mod in project.modules:
        if not _defines_launches(mod):
            continue
        for fn in mod.tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            branch = _cuda_branch(fn)
            if not branch:
                continue
            missing: Set[str] = {g for g in GUARDS if not _called(g, branch)}
            if missing:
                yield Finding(
                    mod.rel, fn.lineno, "kernel-hygiene",
                    f"{fn.name}: the CUDA branch does not call "
                    f"{', '.join(sorted(missing))} — a kernel must refuse "
                    f"a DTensor and a grad-requiring operand")
            if not _counts_launch(branch):
                yield Finding(
                    mod.rel, fn.lineno, "kernel-hygiene",
                    f"{fn.name}: the CUDA branch does not count its launch "
                    f"in LAUNCHES — a run could not show that its path "
                    f"went through the kernel")
            for root in branch:
                for node in ast.walk(root):
                    if isinstance(node, ast.Try) and not all(
                            _reraises(h) for h in node.handlers):
                        yield Finding(
                            mod.rel, node.lineno, "kernel-hygiene",
                            f"{fn.name}: a try in the CUDA branch swallows "
                            f"the launch's error — a kernel launches or "
                            f"raises, it never falls back")

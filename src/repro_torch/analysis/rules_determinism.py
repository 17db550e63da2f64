"""Determinism rules: wall-clock bans, seeded-RNG discipline, set-iteration.

The simulator's headline claims are bitwise: depth-1 pipelining equals
the sequential clock, event timelines equal their event-free baselines.
Anything that injects host entropy — wall-clock reads, process-global
RNG state, hash-randomized set ordering feeding the virtual clock —
breaks those claims non-locally.  Three rules police it:

- ``wallclock``  (src/): no ``time.time``/``perf_counter``/
  ``datetime.now`` & co. — simulated time comes from the virtual
  clocks, never the host.
- ``global-rng`` (src/): no module-level ``random.*`` or
  ``np.random.<fn>`` draws; randomness must flow through an explicitly
  seeded ``RandomState``/``default_rng``/``Random``/``PRNGKey``.
- ``set-iter``   (src/repro_torch/serving/): no bare iteration over sets in
  the serving stack, where iteration order feeds clocks or stats —
  wrap in ``sorted(...)``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from repro_torch.analysis.engine import Module, Project, register
from repro_torch.analysis.report import Finding

WALL_TIME_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
                 "perf_counter", "perf_counter_ns", "process_time"}
WALL_DATETIME_FNS = {"now", "utcnow", "today"}
# Seeded-generator constructors: allowed entry points into numpy
# randomness, provided they are handed an explicit seed.
NP_RANDOM_CTORS = {"RandomState", "default_rng", "Generator",
                   "SeedSequence", "PCG64", "Philox", "MT19937",
                   "BitGenerator"}


def _import_map(tree: ast.Module) -> Dict[str, str]:
    """Map local names to the dotted module they are bound to, for the
    imports this rule set cares about."""
    bound: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                bound[a.asname or a.name] = f"{node.module}.{a.name}"
    return bound


def _dotted(node: ast.AST) -> List[str]:
    """``np.random.rand`` -> ["np", "random", "rand"]; [] if not a pure
    name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _resolve(chain: List[str], imports: Dict[str, str]) -> str:
    """Rewrite the chain head through the import map and return the
    dotted path: ["np", "random", "rand"] -> "numpy.random.rand"."""
    if not chain:
        return ""
    head = imports.get(chain[0], chain[0])
    return ".".join([head] + chain[1:])


@register("wallclock",
          "no host wall-clock reads — simulated time only",
          scope=("src/", "examples/"))
def check_wallclock(project: Project) -> Iterable[Finding]:
    for mod in project.scoped(("src/", "examples/")):
        imports = _import_map(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in WALL_TIME_FNS:
                        yield Finding(
                            mod.rel, node.lineno, "wallclock",
                            f"import of time.{a.name}: wall-clock reads "
                            f"are banned in src/ — simulated time comes "
                            f"from the virtual clocks")
            if not isinstance(node, ast.Call):
                continue
            path = _resolve(_dotted(node.func), imports)
            if path.startswith("time.") and path.split(".")[1] in WALL_TIME_FNS:
                yield Finding(
                    mod.rel, node.lineno, "wallclock",
                    f"call to {path}: wall-clock reads are banned in "
                    f"src/ — simulated time comes from the virtual "
                    f"clocks")
            elif (path.startswith("datetime.")
                  and path.split(".")[-1] in WALL_DATETIME_FNS):
                yield Finding(
                    mod.rel, node.lineno, "wallclock",
                    f"call to {path}: wall-clock reads are banned in "
                    f"src/ — pass timestamps in explicitly")


@register("global-rng",
          "no process-global RNG draws — use a seeded generator",
          scope=("src/", "examples/"))
def check_global_rng(project: Project) -> Iterable[Finding]:
    for mod in project.scoped(("src/", "examples/")):
        imports = _import_map(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    for a in node.names:
                        if a.name != "Random":
                            yield Finding(
                                mod.rel, node.lineno, "global-rng",
                                f"import of random.{a.name}: draws from "
                                f"the process-global RNG — construct a "
                                f"seeded random.Random(seed) instead")
                elif node.module == "numpy.random":
                    for a in node.names:
                        if a.name not in NP_RANDOM_CTORS:
                            yield Finding(
                                mod.rel, node.lineno, "global-rng",
                                f"import of numpy.random.{a.name}: "
                                f"draws from the global numpy RNG — "
                                f"use a seeded RandomState/default_rng")
            if not isinstance(node, ast.Call):
                continue
            path = _resolve(_dotted(node.func), imports)
            parts = path.split(".")
            if parts[0] == "random" and len(parts) == 2:
                if parts[1] != "Random":
                    yield Finding(
                        mod.rel, node.lineno, "global-rng",
                        f"call to {path}: draws from the process-global "
                        f"RNG — construct a seeded random.Random(seed)")
                elif not node.args and not node.keywords:
                    yield Finding(
                        mod.rel, node.lineno, "global-rng",
                        "random.Random() without a seed is "
                        "entropy-seeded — pass an explicit seed")
            elif (len(parts) >= 3 and parts[0] == "numpy"
                  and parts[1] == "random"):
                fn = parts[2]
                if fn not in NP_RANDOM_CTORS:
                    yield Finding(
                        mod.rel, node.lineno, "global-rng",
                        f"call to {path}: draws from the global numpy "
                        f"RNG — route through a seeded "
                        f"RandomState/default_rng")
                elif (fn in ("RandomState", "default_rng")
                      and not node.args and not node.keywords):
                    yield Finding(
                        mod.rel, node.lineno, "global-rng",
                        f"{path}() without a seed is entropy-seeded — "
                        f"pass an explicit seed")


def _set_names(tree: ast.Module) -> Set[str]:
    """Names assigned a set literal / set() call / Set annotation — the
    cheap local type inference behind set-iter."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _is_set_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            ann = node.annotation
            base = ann.value if isinstance(ann, ast.Subscript) else ann
            if (isinstance(base, ast.Name)
                    and base.id in ("Set", "set", "FrozenSet",
                                    "frozenset")):
                names.add(node.target.id)
    return names


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


@register("set-iter",
          "no bare set iteration where order feeds clocks/stats — "
          "wrap in sorted()",
          scope=("src/repro_torch/serving/",))
def check_set_iter(project: Project) -> Iterable[Finding]:
    for mod in project.scoped(("src/repro_torch/serving/",)):
        set_names = _set_names(mod.tree)
        iters = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.For):
                iters.append((node.lineno, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    iters.append((node.lineno, gen.iter))
        for lineno, it in iters:
            offending = None
            if _is_set_expr(it):
                offending = "a set expression"
            elif isinstance(it, ast.Name) and it.id in set_names:
                offending = f"set-typed name '{it.id}'"
            if offending:
                yield Finding(
                    mod.rel, lineno, "set-iter",
                    f"iteration over {offending}: set order is "
                    f"hash-randomized and feeds the clock/stats path — "
                    f"iterate over sorted(...) instead")

"""Declarative parameter tables.

The counterpart of ``repro.models.params``.  A *table* is a nested dict
whose leaves are ``Spec(shape, names, init)``.  From one table the port
derives initialized tensors (optionally stacked on a leading layer axis,
as the reference stacks them for its scan over layers), logical sharding
specs (``table_specs``, which ``distributed.sharding`` resolves on a
mesh), shapes and analytic sizes.

Init draws the reference's distributions from one explicit
``torch.Generator`` on the target device, not the reference's numbers:
JAX's PRNG is its own.  Parity tests carry the reference's own weights
over with ``models.transformer.params_from_reference``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    names: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | const:<v> | normal:<scale>

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype without its storage (the counterpart of
    ``jax.ShapeDtypeStruct`` in ``param_shapes``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict, and to the matching
    leaves of ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def _init_leaf(spec: Spec, stack: int, gen: torch.Generator,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    shape = ((stack,) + spec.shape) if stack else spec.shape
    kind = spec.init
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind.startswith("const:"):
        return torch.full(shape, float(kind.split(":")[1]), dtype=dtype,
                          device=device)
    if kind.startswith("normal:"):
        scale = float(kind.split(":")[1])
    else:
        fan_in = (spec.shape[0] if len(spec.shape) > 1
                  else max(spec.shape[-1], 1))
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def init_table(gen: torch.Generator, table: Dict, dtype: torch.dtype,
               device: torch.device, stack: int = 0) -> Dict:
    """Initialize a (nested) table of Specs into tensors; with ``stack``,
    each leaf gets a leading axis of that many independent draws."""
    return tree_map(lambda s: _init_leaf(s, stack, gen, dtype, device), table)


def table_specs(table: Dict, prefix: Tuple[Optional[str], ...] = ()) -> Dict:
    """Logical-name tuples tree matching the table's tensor tree."""
    return tree_map(lambda s: tuple(prefix) + tuple(s.names), table)


def table_size(table: Dict, stack: int = 1) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(table)) * max(stack, 1)


def shape_tree(table: Dict, dtype: torch.dtype, stack: int = 0) -> Dict:
    """ShapeDtypes without allocation."""
    return tree_map(lambda s: ShapeDtype(
        ((stack,) + s.shape) if stack else s.shape, dtype), table)


def unstack(tree: Dict, n: int) -> list:
    """The ``n`` per-layer trees of a tree stacked on a leading ``(n,
    ...)`` axis, each leaf cut by one ``unbind``: the backward then
    stacks a leaf's layer gradients once, where ``a[i]`` per layer would
    add a zero tensor of the whole stack into its gradient per layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """A tensor's shape and dtype with no storage (``device="meta"``):
    the counterpart of ``jax.ShapeDtypeStruct`` in the models'
    ``input_specs`` and ``cache_specs``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def zeros_from(specs: Any, device: torch.device) -> Any:
    """Zeros on ``device`` of every meta leaf of ``specs``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)

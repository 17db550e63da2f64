"""Declarative parameter tables.

The counterpart of ``repro.models.params``.  A *table* is a nested dict
whose leaves are ``Spec(shape, names, init)``.  From one table the port
derives initialized tensors (optionally stacked on a leading layer axis,
as the reference stacks them for its scan over layers), shapes and
analytic sizes.  The logical names are kept so a table reads like the
reference's; the mesh that resolves them arrives with ROADMAP Queue 1
item 8.

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


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def table_size(table: Dict, stack: int = 1) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(table)) * max(stack, 1)


def shape_tree(table: Dict, dtype: torch.dtype, stack: int = 0) -> Dict:
    """ShapeDtypes without allocation."""
    return tree_map(lambda s: ShapeDtype(
        ((stack,) + s.shape) if stack else s.shape, dtype), table)

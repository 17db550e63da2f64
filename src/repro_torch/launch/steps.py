"""Step builders for serving on a mesh: prefill and decode programs.

The counterpart of ``repro.launch.steps.build_program``.  The reference
jits each step with the mesh's shardings; the port runs eagerly, so a
program is the model's step under ``use_mesh`` with the rules of its
mode, and its example arguments are the placed shapes the step expects:
DTensors with meta local tensors, the counterpart of the reference's
``ShapeDtypeStruct`` trees with their ``in_shardings``.  The caller
places real arguments the same way (``elastic.reshard_tree`` for the
parameters, ``sharding.place`` for the inputs) or passes plain whole
tensors, which the step blocks itself.

The train program (ZeRO-1 state, ``make_sharded_train_step``) waits for
the training half of the mesh (ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models.params import tree_map


def _placed_meta(pl, leaf) -> DTensor:
    """A DTensor of ``leaf``'s shape and dtype with placements ``pl`` on
    the active mesh, its local block a meta tensor (no storage)."""
    whole = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return DTensor.from_local(shd.block(whole, pl, shd.device_mesh()),
                              shd.device_mesh(), pl, shape=whole.shape,
                              stride=whole.stride())


def build_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  rule_overrides: Optional[Dict] = None,
                  cache_len: Optional[int] = None):
    """Returns (fn, example_args, rules) for a serving shape.

    prefill: fn(params, batch) -> (logits, cache); the cache holds
             ``cache_len`` slots (default ``shape.seq_len``, the
             reference's: a server that decodes after the prefill asks
             for more)
    decode : fn(params, cache, batch) -> (logits, cache), the cache
             written in place

    Each runs under ``torch.no_grad()`` and ``use_mesh(mesh, rules)``.
    ``example_args`` holds placed meta DTensors: (params, batch) or
    (params, cache, batch).
    """
    model = registry.build(cfg)
    mode = registry.mode_for_shape(shape)
    if mode == "train":
        raise NotImplementedError(
            "the train program on a mesh (ZeRO-1 state_specs, "
            "make_sharded_train_step) waits for ROADMAP Queue 1 item 8b")
    rules = registry.make_rules(cfg, mesh, mode, overrides=rule_overrides)

    with shd.use_mesh(mesh, rules):
        pshapes = model.param_shapes()
        params = tree_map(_placed_meta, shd.tree_shardings_for_shapes(
            model.param_specs(), pshapes), pshapes)
        in_specs = model.input_specs(shape)
        in_logical = model.input_logical(shape)
        batch = {k: _placed_meta(shd.make_sharding(
            in_logical.get(k) or (None,) * v.dim(), v.shape), v)
            for k, v in in_specs.items()}
        if mode == "decode":
            cshapes = model.cache_specs(shape)
            cache = tree_map(_placed_meta, shd.tree_shardings_for_shapes(
                model.cache_logical(shape), cshapes), cshapes)

    if mode == "prefill":
        slots = cache_len or shape.seq_len

        def prefill(params: Any, batch: Dict[str, Any]):
            with torch.no_grad(), shd.use_mesh(mesh, rules):
                return model.prefill(params, batch, cache_len=slots)

        return prefill, (params, batch), rules

    def decode(params: Any, cache: Dict[str, Any], batch: Dict[str, Any]):
        with torch.no_grad(), shd.use_mesh(mesh, rules):
            return model.decode_step(params, cache, batch)

    return decode, (params, cache, batch), rules

"""Step builders on a mesh: train, prefill and decode programs.

The counterpart of ``repro.launch.steps.build_program``.  The reference
jits each step with the mesh's shardings; the port runs eagerly, so a
program is the model's step under ``use_mesh`` with the rules of its
mode, and its example arguments are the placed shapes the step expects:
DTensors with meta local tensors, the counterpart of the reference's
``ShapeDtypeStruct`` trees with their ``in_shardings``.  The caller
places real arguments the same way (``elastic.reshard_tree`` for the
parameters, ``optimizer.init_state(cfg, params, state_specs)`` or
``reshard_tree`` for the ZeRO-1 state, ``sharding.place`` for the
inputs) or passes plain whole tensors, which the step blocks itself.
Every model family takes it: the decoder LMs (dense, MoE, VLM), whisper,
zamba2, rwkv6 and the DLRM; a prefill's cache comes out in the layout
the decode program's example cache has, so it feeds decode as it is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import make_sharded_train_step


def _placed_meta(pl, leaf) -> DTensor:
    """A DTensor of ``leaf``'s shape and dtype with placements ``pl`` on
    the active mesh, its local block a meta tensor (no storage)."""
    whole = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return DTensor.from_local(shd.block(whole, pl, shd.device_mesh()),
                              shd.device_mesh(), pl, shape=whole.shape,
                              stride=whole.stride())


def build_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  opt_cfg: Optional[OptConfig] = None,
                  rule_overrides: Optional[Dict] = None,
                  microbatches: int = 1, cache_len: Optional[int] = None):
    """Returns (fn, example_args, rules).

    train  : step(params, opt_state, batch) -> (params, opt_state,
             metrics): ``train_loop.make_sharded_train_step`` with
             ``opt_cfg`` (default ``OptConfig()``) and ``microbatches``,
             the parameters and the ZeRO-1 state written in place (the
             reference's ``donate_argnums``)
    prefill: fn(params, batch) -> (logits, cache); the cache holds
             ``cache_len`` slots (default ``shape.seq_len``, the
             reference's: a server that decodes after the prefill asks
             for more)
    decode : fn(params, cache, batch) -> (logits, cache), the cache
             written in place

    Each runs under ``use_mesh(mesh, rules)``, prefill and decode under
    ``torch.no_grad()``.  ``example_args`` holds placed meta DTensors:
    (params, opt_state, batch), (params, batch) or (params, cache,
    batch).
    """
    model = registry.build(cfg)
    mode = registry.mode_for_shape(shape)
    rules = registry.make_rules(cfg, mesh, mode, overrides=rule_overrides)
    opt_cfg = opt_cfg or OptConfig()

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
        if mode == "train":
            sspecs = opt_mod.state_specs(opt_cfg, model.param_specs(),
                                         pshapes)
            meta = tree_map(lambda s: torch.empty(
                s.shape, dtype=s.dtype, device="meta"), pshapes)
            oshapes = opt_mod.init_state(opt_cfg, meta)
            opt_state = tree_map(
                lambda names, s: None if s is None else _placed_meta(
                    shd.make_sharding(names, s.shape), s), sspecs, oshapes)

    if mode == "train":
        step = make_sharded_train_step(model, opt_cfg, mesh, rules, shape,
                                       microbatches)
        return step, (params, opt_state, batch), rules

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

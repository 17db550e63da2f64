"""Training step factory and the fault-tolerant outer loop: the
counterpart of ``repro.train.train_loop``, on one device and on a mesh.

Gradients come from ``torch.autograd.grad`` of the model's ``loss``,
which takes the reference's differentiable path (never a CUDA kernel:
those have no backward).  The parameter trees that ``init`` and
``params_from_reference`` give are plain tensors, as serving wants
them; a step marks every leaf ``requires_grad_()`` before it
differentiates, and ``optimizer.apply_updates`` then writes the leaves in
place under ``torch.no_grad()`` (the counterpart of ``donate_argnums``).

On a mesh (``make_sharded_train_step``, ``run_train_loop(mesh=,
rules=)``) the parameters are DTensors placed under the train rules and
the optimizer state DTensors placed under ``optimizer.state_specs``
(ZeRO-1).  Each rank runs the loss on its blocks; the collectives of
``distributed.sharding`` are differentiated by their linear transposes
(a psum's cotangent is psummed, an all-gather's reduce-scattered, a
block's zero-padded), every rank computes the same global loss, so each
rank differentiates ``loss / world``, and each leaf's gradient is then
summed over the mesh axes the leaf is replicated on (the DP
all-reduce).  The result is every leaf's global gradient in the leaf's
own placement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig


def value_and_grad(model, params, batch):
    """(the model's loss, detached, and every leaf's gradient as a tree
    like ``params``); marks the leaves ``requires_grad_()`` first.  A leaf
    the loss does not reach gets zeros, as JAX gives it.  Under an active
    DeviceMesh see :func:`value_and_grad_mesh`."""
    if shd.device_mesh() is not None:
        return value_and_grad_mesh(model, params, batch)
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _leaf_grad(p, g, mesh):
    """A leaf's gradient summed over the mesh dims the leaf is
    replicated on (in fp32 at least, rounded once to its dtype), in the
    leaf's placements (a plain leaf: replicated on every dim, and a
    plain gradient)."""
    _, rep = shd.placed_dims(p)
    wide = torch.promote_types(g.dtype, torch.float32)
    return shd.like(p, shd._psum_dims(g.to(wide), mesh, rep).to(g.dtype))


def value_and_grad_mesh(model, params, batch):
    """:func:`value_and_grad` on the active DeviceMesh: (the global loss,
    the same on every rank, and every leaf's global gradient in its
    placement).  Each rank differentiates ``loss / world`` with respect to
    its local blocks (a DTensor leaf is rebuilt around a grad-requiring
    view of its local tensor, so the parameters themselves are left as
    they are), then each gradient is psummed over the axes its leaf is
    replicated on."""
    mesh = shd.device_mesh()
    leaves = list(tree_leaves(params))
    locs = [shd.local_tensor(p).detach().requires_grad_(True)
            for p in leaves]
    it = iter(locs)
    loss = model.loss(tree_map(lambda p: shd.like(p, next(it)), params),
                      batch)
    grads = torch.autograd.grad(loss / mesh.size(), locs, allow_unused=True,
                                materialize_grads=True)
    with torch.no_grad():
        grads = iter([_leaf_grad(p, g, mesh)
                      for p, g in zip(leaves, grads)])
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1,
                    place: Optional[Callable] = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  Microbatching splits the batch on dim 0 (a DTensor leaf
    made whole first) and accumulates the loss and the gradients in
    fp32, in microbatch order, then divides by their count, as the
    reference's ``lax.scan`` does.  ``place`` maps each (micro)batch to
    what the loss takes (default: itself; on a mesh, this rank's blocks
    placed, :func:`make_sharded_train_step`)."""
    place = place or (lambda b: b)

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, place(batch))
        else:
            mbs = tree_map(lambda x: shd.full(x).reshape(
                (microbatches, x.shape[0] // microbatches) + x.shape[1:]),
                batch)
            loss = 0.0
            grads = tree_map(lambda p: shd.like(p, torch.zeros(
                shd.local_tensor(p).shape, dtype=torch.float32,
                device=p.device)), params)
            for i in range(microbatches):
                mb_loss, mb_grads = value_and_grad(
                    model, params, place(tree_map(lambda x: x[i], mbs)))
                loss = loss + mb_loss
                tree_map(lambda acc, g: shd.local_tensor(acc).add_(
                    shd.local_tensor(g)), grads, mb_grads)
            loss = loss / microbatches
            tree_map(lambda g: shd.local_tensor(g).div_(microbatches), grads)
        params, opt_state = opt_mod.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss.float(),
                   "grad_norm": opt_mod.global_norm(grads)}
        return params, opt_state, metrics

    return step


def make_sharded_train_step(model, opt_cfg: OptConfig, mesh, rules,
                            shape: ShapeConfig, microbatches: int = 1):
    """:func:`make_train_step` on ``mesh`` under ``rules``: step(params,
    opt_state, batch) -> (params, opt_state, metrics), with ``params``
    placed under the model's ``param_specs`` and ``opt_state`` under
    ``optimizer.state_specs`` (DTensors; the counterpart of the
    reference's ``in_shardings``), ``batch`` the global batch (plain
    tensors or DTensors), of which each rank takes its block of each
    microbatch under ``model.input_logical(shape)``.  The parameters and
    state are written in place (``donate_argnums``); ``metrics`` are the
    global loss and gradient norm, the same on every rank."""
    logical = model.input_logical(shape)

    def place(batch):
        return {k: shd.place(v, logical.get(k) or (None,) * v.dim())
                for k, v in batch.items()}

    inner = make_train_step(model, opt_cfg, microbatches, place)

    def step(params, opt_state, batch):
        with shd.use_mesh(mesh, rules):
            return inner(params, opt_state, batch)

    return step


def train_shape(batch) -> ShapeConfig:
    """The ``ShapeConfig`` of a training batch (its global batch and, for
    an LM, its sequence length)."""
    toks = batch.get("tokens")
    B = next(iter(batch.values())).shape[0]
    return ShapeConfig("train", 0 if toks is None else toks.shape[1], B,
                       "train")


def place_for_training(model, opt_cfg: OptConfig, params, mesh, rules,
                       opt_state=None):
    """``params`` (plain whole tensors, or DTensors on any mesh) placed
    on ``mesh`` under the model's ``param_specs``, and ``opt_state``
    under ``optimizer.state_specs`` (fresh zero state of this rank's
    blocks when None).  Every rank of ``mesh`` calls it."""
    from repro_torch.distributed.elastic import reshard_tree

    with shd.use_mesh(mesh, rules):
        pspecs = model.param_specs()
        sspecs = opt_mod.state_specs(opt_cfg, pspecs, model.param_shapes())
    params = reshard_tree(params, pspecs, mesh, rules)
    if opt_state is None:
        with shd.use_mesh(mesh, rules):
            opt_state = opt_mod.init_state(opt_cfg, params, sspecs)
    else:
        opt_state = reshard_tree(opt_state, sspecs, mesh, rules)
    return params, opt_state


@dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    max_failures: int = 3


def run_train_loop(model, opt_cfg: OptConfig, data_iter, cfg: TrainLoopConfig,
                   mesh=None, rules=None, params=None, opt_state=None,
                   fault_hook: Optional[Callable[[int], None]] = None,
                   log_fn=print, device: DeviceLike = None):
    """Fault-tolerant outer loop: periodic checkpoints; on a (simulated or
    real) step failure, restore the last checkpoint and continue, the
    CN-failure recovery path of §IV-A at training time.  As in the
    reference, the data iterator is not rewound after a restore.

    Runs on ``device`` (default: the CUDA card): ``model.init(0)`` there
    when ``params`` is None, and each batch goes there as it comes.
    With ``mesh`` (a DeviceMesh; ``rules`` the train rules) every rank
    of the mesh runs the loop on the same global batches: the params and
    state are placed there (``place_for_training``) and each step is
    ``make_sharded_train_step``'s; checkpoints gather every leaf whole
    and rank 0 writes them.  Returns (params, opt_state, [(step, loss)]
    every ``log_every``)."""
    dev = resolve_device(device)
    if params is None:
        params = model.init(0, device=dev)
    if mesh is not None:
        params, opt_state = place_for_training(model, opt_cfg, params, mesh,
                                               rules, opt_state)
    elif opt_state is None:
        opt_state = opt_mod.init_state(opt_cfg, params)

    step_fn = None if mesh is not None else make_train_step(model, opt_cfg)

    start = 0
    if cfg.checkpoint_dir:
        restored = ckpt.try_restore(cfg.checkpoint_dir, params, opt_state)
        if restored is not None:
            params, opt_state, start = restored
            log_fn(f"[ckpt] resumed at step {start}")

    failures = 0
    history = []
    it = iter(data_iter)
    step = start
    while step < cfg.steps:
        batch = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev),
                         next(it))
        if step_fn is None:
            step_fn = make_sharded_train_step(model, opt_cfg, mesh, rules,
                                              train_shape(batch))
        try:
            if fault_hook is not None:
                fault_hook(step)      # may raise to simulate a node loss
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        except RuntimeError as e:
            failures += 1
            if failures > cfg.max_failures or not cfg.checkpoint_dir:
                raise
            log_fn(f"[fault] step {step}: {e}; restoring checkpoint")
            params, opt_state, step = ckpt.try_restore(
                cfg.checkpoint_dir, params, opt_state)
            continue
        if step % cfg.log_every == 0:
            loss = float(metrics["loss"])
            history.append((step, loss))
            log_fn(f"step {step:5d} loss {loss:.4f}")
        step += 1
        if cfg.checkpoint_dir and step % cfg.checkpoint_every == 0:
            ckpt.save(cfg.checkpoint_dir, params, opt_state, step)
    if cfg.checkpoint_dir:
        ckpt.save(cfg.checkpoint_dir, params, opt_state, step)
    return params, opt_state, history

"""Training step factory and the fault-tolerant outer loop: the
counterpart of ``repro.train.train_loop`` on one device.

Gradients come from ``torch.autograd.grad`` of the model's ``loss``,
which takes the reference's differentiable path (never a CUDA kernel:
those have no backward).  The parameter trees that ``init`` and
``params_from_reference`` give are plain tensors, as serving wants
them; a step marks every leaf ``requires_grad_()`` before it
differentiates, and ``optimizer.apply_updates`` then writes the leaves in
place under ``torch.no_grad()`` (the counterpart of ``donate_argnums``).

``make_sharded_train_step`` (jit with the mesh's shardings) waits for
the training half of the mesh (ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig


def value_and_grad(model, params, batch):
    """(the model's loss, detached, and every leaf's gradient as a tree
    like ``params``); marks the leaves ``requires_grad_()`` first.  A leaf
    the loss does not reach gets zeros, as JAX gives it."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  Microbatching splits the batch on dim 0 and accumulates
    the loss and the gradients in fp32, in microbatch order, then divides
    by their count, as the reference's ``lax.scan`` does."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            mbs = tree_map(lambda x: x.reshape(
                (microbatches, x.shape[0] // microbatches) + x.shape[1:]),
                batch)
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mb_loss, mb_grads = value_and_grad(
                    model, params, tree_map(lambda x: x[i], mbs))
                loss = loss + mb_loss
                tree_map(lambda acc, g: acc.add_(g), grads, mb_grads)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        params, opt_state = opt_mod.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss.float(),
                   "grad_norm": opt_mod.global_norm(grads)}
        return params, opt_state, metrics

    return step


@dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    max_failures: int = 3


def run_train_loop(model, opt_cfg: OptConfig, data_iter, cfg: TrainLoopConfig,
                   params=None, opt_state=None,
                   fault_hook: Optional[Callable[[int], None]] = None,
                   log_fn=print, device: DeviceLike = None):
    """Fault-tolerant outer loop: periodic checkpoints; on a (simulated or
    real) step failure, restore the last checkpoint and continue, the
    CN-failure recovery path of §IV-A at training time.  As in the
    reference, the data iterator is not rewound after a restore.

    Runs on ``device`` (default: the CUDA card): ``model.init(0)`` there
    when ``params`` is None, and each batch goes there as it comes.
    Returns (params, opt_state, [(step, loss)] every ``log_every``)."""
    dev = resolve_device(device)
    if params is None:
        params = model.init(0, device=dev)
    if opt_state is None:
        opt_state = opt_mod.init_state(opt_cfg, params)

    step_fn = make_train_step(model, opt_cfg)

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

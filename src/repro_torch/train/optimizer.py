"""Functional-style optimizers with gradient compression: the
counterpart of ``repro.train.optimizer``.

Adam for dense parameters, Adagrad for embedding tables (the production
choice for DLRM sparse tables), SGD; a global-norm gradient clip, and
int8 compression with error feedback.  Every state tensor is fp32 and
every update is computed in fp32 and cast back to the parameter's
dtype, as the reference's ``upd`` does (a bf16 parameter's bf16
gradient is widened first).

Differences from the reference, each deliberate:

- ``apply_updates`` writes the parameters and the state IN PLACE, under
  ``torch.no_grad()``, and returns the same trees: the counterpart of
  the reference's ``donate_argnums``, which lets XLA reuse the buffers.
  A caller that wants the parameters before a step keeps a copy.
- ``global_norm`` sums the leaves in ``jax.tree.leaves`` order (dict
  keys sorted), where the port's trees keep insertion order, so that the
  clip factor is the reference's in fp32.

``state_specs`` (ZeRO-1 sharding of the state) waits for the training
half of the mesh (ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"            # adam | adagrad | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # int8 gradient compression (error feedback) for the DP all-reduce
    compress_grads: bool = False


def sorted_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, None
    an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k])
    elif tree is not None:
        yield tree


def init_state(cfg: OptConfig, params) -> dict:
    """Zero state, fp32, beside each parameter."""
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    if cfg.kind == "adam":
        return {"step": step, "m": tree_map(f32, params),
                "v": tree_map(f32, params),
                "err": tree_map(f32, params) if cfg.compress_grads else None}
    if cfg.kind == "adagrad":
        return {"step": step, "v": tree_map(f32, params), "err": None}
    return {"step": step, "err": None}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in sorted_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def compress_int8(g: torch.Tensor,
                  err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: returns (the dequantized int8
    payload, the new error).  The all-reduce then moves 1/4 the bytes;
    the residual is re-injected next step (Karimireddy et al. style)."""
    g32 = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g32 - deq


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state):
    """One step of ``cfg.kind`` on ``params`` with ``grads`` (a tree of
    the same structure), clipped to ``cfg.grad_clip`` in global norm;
    writes the parameters and the state in place and returns them."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    state["step"].add_(1)
    step = state["step"].float()

    if cfg.compress_grads:
        pairs = tree_map(compress_int8, grads, state["err"])
        grads = tree_map(lambda pr: pr[0], pairs)
        tree_map(lambda e, pr: e.copy_(pr[1]), state["err"], pairs)

    def write(p, new):
        p.copy_(new.to(p.dtype))

    if cfg.kind == "adam":
        bc1 = 1 - cfg.b1 ** step
        bc2 = 1 - cfg.b2 ** step

        def upd(p, g, m, v):
            g = g.float() * clip
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            delta = cfg.lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay:
                delta += cfg.lr * cfg.weight_decay * p.float()
            write(p, p.float() - delta)

        tree_map(upd, params, grads, state["m"], state["v"])
    elif cfg.kind == "adagrad":
        def upd(p, g, v):
            g = g.float() * clip
            v.copy_(v + g * g)
            write(p, p.float() - cfg.lr * g / (torch.sqrt(v) + cfg.eps))

        tree_map(upd, params, grads, state["v"])
    else:  # sgd
        tree_map(lambda p, g: write(p, p.float() - cfg.lr * g.float()
                                    * clip), params, grads)
    return params, state

"""Functional-style optimizers with ZeRO-1 sharded state and gradient
compression: the counterpart of ``repro.train.optimizer``.

Adam for dense parameters, Adagrad for embedding tables (the production
choice for DLRM sparse tables), SGD; a global-norm gradient clip, and
int8 compression with error feedback.  Every state tensor is fp32 and
every update is computed in fp32 and cast back to the parameter's
dtype, as the reference's ``upd`` does (a bf16 parameter's bf16
gradient is widened first).  The optimizer state carries its own
logical specs (``state_specs``): each moment takes its parameter's spec
with the ``opt_shard`` ZeRO axis on the first replicated dimension, so
state shards over ``data`` even where the weights are replicated.

On a mesh (``distributed.sharding.use_mesh`` with a DeviceMesh) the
parameters and gradients are DTensors in the parameters' placements
(the gradient of each leaf already summed over the ranks), the state
DTensors in ``state_specs``' placements.  ``apply_updates`` is then
ZeRO-1: each rank updates its block of the moments from the same block
of the gradient and the parameter, and all-gathers the new block over
``data`` back into the parameter's placement (what XLA does for the
reference's ``out_shardings``).  ``global_norm`` sums each leaf's local
squares over the mesh axes the leaf is sharded on, never over those it
is replicated on, and int8 compression takes the max of ``|g|`` over
the whole leaf by a pmax over the axes its state block is sharded on.

Differences from the reference, each deliberate:

- ``apply_updates`` writes the parameters and the state IN PLACE, under
  ``torch.no_grad()``, and returns the same trees: the counterpart of
  the reference's ``donate_argnums``, which lets XLA reuse the buffers.
  A caller that wants the parameters before a step keeps a copy.
- ``global_norm`` sums the leaves in ``jax.tree.leaves`` order (dict
  keys sorted), where the port's trees keep insertion order, so that the
  clip factor is the reference's in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Tuple

import torch

from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed import sharding as shd
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


def init_state(cfg: OptConfig, params, specs=None) -> dict:
    """Zero state, fp32, beside each parameter.  With ``specs`` (the tree
    :func:`state_specs` gives) under an active DeviceMesh every state
    leaf is a DTensor placed under its spec, made from zeros of this
    rank's block only."""
    dev = shd.local_tensor(next(tree_leaves(params))).device
    if specs is None:
        def f32(p, _=None):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        step = torch.zeros((), dtype=torch.int32, device=dev)
        specs = {}
    else:
        def f32(p, names):
            return shd.placed_zeros(p.shape, names, torch.float32, dev)

        step = shd.placed_zeros((), (), torch.int32, dev)

    def moments(key):
        names = specs.get(key)
        if names is None:
            return tree_map(f32, params)
        return tree_map(f32, params, names)

    if cfg.kind == "adam":
        return {"step": step, "m": moments("m"), "v": moments("v"),
                "err": moments("err") if cfg.compress_grads else None}
    if cfg.kind == "adagrad":
        return {"step": step, "v": moments("v"), "err": None}
    return {"step": step, "err": None}


def state_specs(cfg: OptConfig, param_specs, param_shapes=None):
    """Logical specs for the state tree: ZeRO-1 shards moment tensors over
    the data axis on the first dim that (a) resolves to no mesh axis under
    the active rules and (b) is divisible by the data-axis size."""
    data = shd.axis_size("data") * shd.axis_size("pod")

    opt_axes = shd.resolve(("opt_shard",))[0]
    opt_axes = (() if opt_axes is None else
                ((opt_axes,) if isinstance(opt_axes, str) else tuple(opt_axes)))

    def zero1(names, shape=None):
        names = tuple(names)
        out = list(names)
        # mesh axes already consumed by the parameter's own sharding
        used = set()
        for n in names:
            r = shd.resolve((n,))[0]
            if r is not None:
                used.update((r,) if isinstance(r, str) else tuple(r))
        if any(a in used for a in opt_axes):
            return names                      # param already spans ZeRO axes
        for i, n in enumerate(names):
            resolved = shd.resolve((n,))[0]
            if resolved is not None:
                continue
            if shape is not None and shape[i] % max(data, 1) != 0:
                continue
            out[i] = "opt_shard"
            break
        return tuple(out)

    if param_shapes is not None:
        moments = tree_map(lambda names, s: zero1(names, s.shape),
                           param_specs, param_shapes)
    else:
        moments = tree_map(zero1, param_specs)
    out = {"step": (), "err": None}
    if cfg.kind == "adam":
        out.update(m=moments, v=moments)
    elif cfg.kind == "adagrad":
        out.update(v=moments)
    if cfg.compress_grads:
        out["err"] = moments
    return out


def _leaf_sq(x) -> torch.Tensor:
    """A leaf's sum of squares: a DTensor's local sum psummed over the
    mesh dims it is sharded on (never over those it is replicated on)."""
    sq = torch.sum(torch.square(shd.local_tensor(x).float()))
    if isinstance(x, DTensor):
        sq = shd._psum_dims(sq, x.device_mesh, shd.placed_dims(x)[0])
    return sq


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, the leaves summed in
    ``jax.tree.leaves`` order."""
    leaves = [_leaf_sq(x) for x in sorted_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def compress_int8(g: torch.Tensor, err: torch.Tensor,
                  entry: shd.Entry = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: returns (the dequantized int8
    payload, the new error).  The all-reduce then moves 1/4 the bytes;
    the residual is re-injected next step (Karimireddy et al. style).
    ``g`` and ``err`` may be a rank's blocks of a leaf sharded over the
    mesh axes ``entry``: the scale's max then runs over the whole leaf
    (a pmax; the update runs under no_grad, so no gradient is lost)."""
    g32 = g.float() + err
    amax = torch.max(torch.abs(g32))
    if entry is not None:
        amax = shd.pmax(amax, entry)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g32 - deq


def _zero_dims(p, s) -> list:
    """(mesh dim, tensor dim) of each ZeRO shard: a mesh dim the state
    ``s`` is sharded on where the parameter ``p`` is replicated."""
    if not isinstance(s, DTensor):
        return []
    out = []
    for i, (a, b) in enumerate(zip(p.placements, s.placements)):
        if a != b:
            if isinstance(a, Shard) or not isinstance(b, Shard):
                raise ValueError(f"ZeRO-1: state placements {s.placements} "
                                 f"against the parameter's {p.placements}")
            out.append((i, b.dim))
    return out


class _Zero:
    """One leaf's ZeRO-1 view: the parameter's and the gradient's local
    blocks cut to the state's block, and the write of a new block back
    into the parameter (an all-gather over the ZeRO dims)."""

    def __init__(self, p, g, s):
        self.p = p
        self.dims = _zero_dims(p, s) if isinstance(p, DTensor) else []
        self.loc = shd.local_tensor(p)
        self.pb, self.gb = self.cut(self.loc), self.cut(shd.local_tensor(g))
        if isinstance(s, DTensor):
            sharded = shd.placed_dims(s)[0]
            self.entry = shd.dims_entry(s.device_mesh, sharded)
        else:
            self.entry = None

    def cut(self, t):
        if self.dims:
            coord = self.p.device_mesh.get_coordinate()
            for i, d in self.dims:
                n = t.shape[d] // self.p.device_mesh.size(i)
                t = t.narrow(d, coord[i] * n, n)
        return t

    def write(self, new):
        new = new.to(self.loc.dtype)
        for i, d in reversed(self.dims):
            new = shd._gather(new, self.p.device_mesh, i, d)
        self.loc.copy_(new)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state):
    """One step of ``cfg.kind`` on ``params`` with ``grads`` (a tree of
    the same structure), clipped to ``cfg.grad_clip`` in global norm;
    writes the parameters and the state in place and returns them.  On a
    mesh each rank updates its ZeRO-1 block (see the module docstring)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step_t = shd.local_tensor(state["step"])
    step_t.add_(1)
    step = step_t.float()
    # the state tree whose placements cut each leaf's block
    like = state.get("m", state.get("v"))
    if like is None:
        like = params
    views = tree_map(_Zero, params, grads, like)

    if cfg.compress_grads:
        def comp(z, e):
            deq, new_err = compress_int8(z.gb, shd.local_tensor(e), z.entry)
            shd.local_tensor(e).copy_(new_err)
            z.gb = deq
        tree_map(comp, views, state["err"])

    if cfg.kind == "adam":
        bc1 = 1 - cfg.b1 ** step
        bc2 = 1 - cfg.b2 ** step

        def upd(z, m, v):
            m, v = shd.local_tensor(m), shd.local_tensor(v)
            g = z.gb.float() * clip
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            delta = cfg.lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay:
                delta += cfg.lr * cfg.weight_decay * z.pb.float()
            z.write(z.pb.float() - delta)

        tree_map(upd, views, state["m"], state["v"])
    elif cfg.kind == "adagrad":
        def upd(z, v):
            v = shd.local_tensor(v)
            g = z.gb.float() * clip
            v.copy_(v + g * g)
            z.write(z.pb.float() - cfg.lr * g / (torch.sqrt(v) + cfg.eps))

        tree_map(upd, views, state["v"])
    else:  # sgd
        tree_map(lambda z: z.write(z.pb.float() - cfg.lr * z.gb.float()
                                   * clip), views)
    return params, state

"""DLRM-style recommendation model (the paper's RM1/RM2) in PyTorch.

Pipeline (paper Fig. 1a): preprocessing G_P (hashing, done in the data
layer) -> SparseNet G_S (embedding bags: gather + pooling) -> DenseNet G_D
(bottom MLP, pairwise interaction, top MLP).

The counterpart of ``repro.models.dlrm``: parameters are the same
nested dict (``embed``, ``proj``, ``bottom``/``top`` MLP weights) of
tensors, in the reference's layout, so :func:`params_from_reference`
carries the JAX parameters over as they are.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import embedding_bag_ref

# (shape, init) leaves; init is "normal:<scale>", "normal" (1/sqrt(fan_in)
# with fan_in = shape[0]) or "zeros", as in repro.models.params
Leaf = Tuple[Tuple[int, ...], str]


def _mlp_tables(dims) -> Dict[str, Leaf]:
    t: Dict[str, Leaf] = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        t[f"w{i}"] = ((a, b), "normal")
        t[f"b{i}"] = ((b,), "zeros")
    return t


def _mlp_apply(t, x, n):
    for i in range(n):
        x = x @ t[f"w{i}"] + t[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _init_leaf(leaf: Leaf, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    shape, kind = leaf
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if kind.startswith("normal:"):
        scale = float(kind.split(":")[1])
    else:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale)


def params_from_reference(tree: Any, device: DeviceLike = None) -> Any:
    """Convert a reference parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) into the port's tensors
    on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)


class DLRMModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        r = cfg.dlrm
        self.num_feats = r.interaction_proj + 1
        self.inter = self.num_feats * (self.num_feats - 1) // 2

    def _tables(self) -> Dict[str, Any]:
        r = self.cfg.dlrm
        bot = (r.num_dense_features,) + r.bottom_mlp
        top = (r.bottom_mlp[-1] + self.inter,) + r.top_mlp
        return {
            "embed": ((r.num_tables, r.rows_per_table, r.embed_dim),
                      "normal:0.01"),
            "proj": ((r.num_tables, r.interaction_proj), "normal:0.05"),
            "bottom": _mlp_tables(bot),
            "top": _mlp_tables(top),
        }

    def init(self, seed: int = 0, device: DeviceLike = None
             ) -> Dict[str, Any]:
        """Random fp32 parameters (DLRM tables are served fp32) drawn
        from one ``torch.Generator`` seeded with ``seed`` on ``device``
        (default: the CUDA card).  The draws follow the reference's
        distributions, not its numbers: JAX's PRNG is its own."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            return _init_leaf(t, gen, dev)
        return walk(self._tables())

    # ------------------------------------------------------------ forward
    def pool_embeddings(self, params, idx: torch.Tensor,
                        use_kernel: bool = False) -> torch.Tensor:
        """SparseNet G_S: gather+pool all tables -> (B, T, D).

        ``use_kernel=True`` runs the fused bag over the whole table stack
        (``kernels.ops.embedding_bag_fused``); otherwise the one-reduction
        reference ``embedding_bag_ref``."""
        if use_kernel:
            return ops.embedding_bag_fused(params["embed"], idx)
        return embedding_bag_ref(params["embed"], idx)

    def dense_forward(self, params, dense: torch.Tensor,
                      pooled: torch.Tensor) -> torch.Tensor:
        """DenseNet G_D on already-pooled embeddings (the CN-side half:
        what runs after the Fsum gather returns from the MN pool)."""
        r = self.cfg.dlrm
        bot = _mlp_apply(params["bottom"], dense, len(r.bottom_mlp))
        pooled = torch.einsum("btd,tk->bkd", pooled.to(bot.dtype),
                              params["proj"])
        z = torch.cat([bot[:, None, :], pooled], dim=1)         # (B,K+1,D)
        zz = torch.einsum("bfd,bgd->bfg", z, z)
        # row-major upper triangle, the order of jnp.triu_indices(F, k=1)
        iu = torch.triu_indices(self.num_feats, self.num_feats, 1,
                                device=z.device)
        inter = zz[:, iu[0], iu[1]]                             # (B, F(F-1)/2)
        x = torch.cat([bot, inter], dim=-1)
        return _mlp_apply(params["top"], x, len(r.top_mlp))[..., 0]

    def forward(self, params, batch, use_kernel: bool = False):
        pooled = self.pool_embeddings(params, batch["indices"],
                                      use_kernel=use_kernel)
        return self.dense_forward(params, batch["dense"], pooled)

    def loss(self, params, batch) -> torch.Tensor:
        logit = self.forward(params, batch)
        y = batch["labels"].to(torch.float32)
        z = logit.to(torch.float32)
        # stable BCE-with-logits, as the reference writes it
        return torch.mean(torch.clamp(z, min=0) - z * y
                          + torch.log1p(torch.exp(-torch.abs(z))))

    def serve_step(self, params, batch, use_kernel: bool = False):
        return torch.sigmoid(self.forward(params, batch,
                                          use_kernel=use_kernel))

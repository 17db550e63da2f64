"""DLRM-style recommendation model (the paper's RM1/RM2) in PyTorch.

Pipeline (paper Fig. 1a): preprocessing G_P (hashing, done in the data
layer) -> SparseNet G_S (embedding bags: gather + pooling) -> DenseNet G_D
(bottom MLP, pairwise interaction, top MLP).

The counterpart of ``repro.models.dlrm``: parameters are the same
nested dict (``embed``, ``proj``, ``bottom``/``top`` MLP weights) of
tensors, in the reference's layout, so :func:`params_from_reference`
carries the JAX parameters over as they are.

On a mesh (``distributed.sharding.use_mesh`` with a DeviceMesh and
``registry.make_rules``) the embedding bank shards over tables
(``table_shard``: the ``model`` axis, the MN pool) and rows
(``table_rows``: ``data``).  Each rank pools its block of the bank for
every bag of the batch (its rows serve the whole batch), through the
fused bag kernel with ``use_kernel``; a slot that lands in another
rank's block is padding here.  The partial sums cross the network, never
raw rows: one psum over the bank's axes gives the pooled (B, T, D) on
every rank (the Fsum), and each rank runs the dense tower on its batch
block.  A slot reads the row the single-device path reads: with the
kernel, flat row ``t * R + i`` of the bank clamped to its end (so a row
past table t's end reads table t + 1's); without it, row ``i`` of table
``t``, and a row past the end makes the bag NaN.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import embedding_bag_ref
from repro_torch.models import params as pm
from repro_torch.models.params import Spec, meta

EMBED_LOGICAL = ("table_shard", "table_rows", None)


def _mlp_tables(dims) -> Dict[str, Spec]:
    t: Dict[str, Spec] = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        t[f"w{i}"] = Spec((a, b), (None, None))
        t[f"b{i}"] = Spec((b,), (None,), "zeros")
    return t


def _mlp_apply(t, x, n):
    for i in range(n):
        x = x @ t[f"w{i}"] + t[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stable BCE-with-logits terms, as the reference writes them."""
    return torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))


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
            "embed": Spec((r.num_tables, r.rows_per_table, r.embed_dim),
                          EMBED_LOGICAL, "normal:0.01"),
            "proj": Spec((r.num_tables, r.interaction_proj), (None, None),
                         "normal:0.05"),
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
        return pm.init_table(gen, self._tables(), torch.float32, dev)

    def param_specs(self) -> Dict[str, Any]:
        return pm.table_specs(self._tables())

    def param_shapes(self, dtype: Optional[torch.dtype] = None) -> Dict:
        return pm.shape_tree(self._tables(), dtype or torch.float32)

    # ------------------------------------------------------------ forward
    def pool_embeddings(self, params, idx: torch.Tensor,
                        use_kernel: bool = False) -> torch.Tensor:
        """SparseNet G_S: gather+pool all tables -> (B, T, D).

        ``use_kernel=True`` runs the fused bag over the whole table stack
        (``kernels.ops.embedding_bag_fused``); otherwise the one-reduction
        reference ``embedding_bag_ref``.  On a mesh: this rank's block,
        then the Fsum (:meth:`_pool_mesh`)."""
        if shd.device_mesh() is not None:
            return self._pool_mesh(params["embed"], idx, use_kernel)
        if use_kernel:
            return ops.embedding_bag_fused(params["embed"], idx)
        return embedding_bag_ref(params["embed"], idx)

    def _pool_mesh(self, emb, idx, use_kernel: bool) -> torch.Tensor:
        """This rank's block of the bank pooled for every bag of the
        batch, then a psum over the bank's axes -> the whole (B, T, D)."""
        tspec, rspec, _ = shd.spec(emb, *EMBED_LOGICAL)
        blk = shd.local(emb, *EMBED_LOGICAL)              # (T_loc, R_loc, D)
        T, R, D = emb.shape
        T_loc, R_loc = blk.shape[:2]
        t0 = shd.entry_index(tspec)[0] * T_loc
        r0 = shd.entry_index(rspec)[0] * R_loc
        idx = shd.full(idx).to(torch.int64)               # every bag
        tix = torch.arange(T, device=idx.device)[None, :, None]
        if use_kernel:      # the fused kernel's flat row, clamped to the bank
            g = (tix * R + idx.clamp(min=0)).clamp(max=T * R - 1)
            t, r = g // R, g % R
        else:
            t, r = tix, idx.clamp(max=R - 1)
        mine = ((idx >= 0) & (t >= t0) & (t < t0 + T_loc)
                & (r >= r0) & (r < r0 + R_loc))
        flat = torch.where(mine, (t - t0) * R_loc + (r - r0), -1)
        table = blk.reshape(T_loc * R_loc, D)
        if use_kernel:
            part = ops.embedding_bag_fused_flat(
                table, torch.zeros(T, dtype=torch.int32, device=idx.device),
                flat.to(torch.int32))
        else:
            # another rank's slot reads a row of this block spread as its
            # own row is (its term is masked): gathering every such slot
            # from one row would serialise the backward's scatter-add
            spread = (t % T_loc) * R_loc + r % R_loc
            part = torch.where(mine[..., None],
                               table[torch.where(mine, flat, spread)],
                               0.0).sum(dim=2)
        pooled = shd.psum(shd.psum(part, tspec), rspec)
        if not use_kernel:
            pooled = pooled.masked_fill((idx >= R).any(dim=2, keepdim=True),
                                        float("nan"))
        return pooled.to(emb.dtype)

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
        """The logits; on a mesh placed ("batch",): this rank's block."""
        if shd.device_mesh() is not None:
            return self._placed(batch, self._forward_mesh(params, batch,
                                                          use_kernel))
        pooled = self.pool_embeddings(params, batch["indices"],
                                      use_kernel=use_kernel)
        return self.dense_forward(params, batch["dense"], pooled)

    def _forward_mesh(self, params, batch, use_kernel: bool) -> torch.Tensor:
        """This rank's batch block of the logits: the Fsum'd pooled
        vectors cut to the block (the reference's ``lsc(pooled, "batch",
        None, None)``), then the dense tower on the block."""
        pooled = self.pool_embeddings(params, batch["indices"],
                                      use_kernel=use_kernel)
        specs = self.param_specs()
        dp = {k: pm.tree_map(lambda t, n: shd.local(t, *n), params[k],
                             specs[k]) for k in ("proj", "bottom", "top")}
        return self.dense_forward(dp, shd.local(batch["dense"], "batch", None),
                                  shd.local(pooled, "batch", None, None))

    def _placed(self, batch, local: torch.Tensor):
        return shd.place_local(local, ("batch",), (batch["dense"].shape[0],))

    def loss(self, params, batch) -> torch.Tensor:
        """Mean BCE over the batch, the pooling on its plain path (the
        reference's loss pools with ``embedding_bag_ref``).  On a mesh
        each rank sums its batch block's terms and a psum over the batch
        axes gives every rank the global mean; the bank's block gets its
        gradient through the Fsum's psum."""
        if shd.device_mesh() is not None:
            B = batch["labels"].shape[0]
            z = self._forward_mesh(params, batch, False).to(torch.float32)
            y = shd.local(batch["labels"], "batch").to(torch.float32)
            be = shd.resolve_for_shape(("batch",), (B,))[0]
            return shd.psum(_bce(z, y).sum(), be) / B
        logit = self.forward(params, batch)
        y = batch["labels"].to(torch.float32)
        z = logit.to(torch.float32)
        return torch.mean(_bce(z, y))

    def serve_step(self, params, batch, use_kernel: bool = False):
        if shd.device_mesh() is not None:
            return self._placed(batch, torch.sigmoid(
                self._forward_mesh(params, batch, use_kernel)))
        return torch.sigmoid(self.forward(params, batch,
                                          use_kernel=use_kernel))

    # -------------------------------------------------------------- specs
    def input_specs(self, shape_or_batch) -> Dict[str, torch.Tensor]:
        """The batch of a ``ShapeConfig`` cell, or of a training batch of
        that many rows, as meta tensors."""
        r = self.cfg.dlrm
        if isinstance(shape_or_batch, ShapeConfig):
            B = shape_or_batch.global_batch
            kind = shape_or_batch.kind
        else:
            B, kind = shape_or_batch, "train"
        spec = {"dense": meta((B, r.num_dense_features), torch.float32),
                "indices": meta((B, r.num_tables, r.avg_pooling),
                                torch.int32)}
        if kind == "train":
            spec["labels"] = meta((B,), torch.int32)
        return spec

    def input_logical(self, shape=None) -> Dict[str, Tuple]:
        return {"dense": ("batch", None), "indices": ("batch", None, None),
                "labels": ("batch",)}

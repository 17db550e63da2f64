"""Operations and bytes of the DLRM layers, from a configuration's shapes.

These are the benchmark's own counts, the numerators of the rooflines
and of ``step_mfu``.  Each input byte counts as read once and each
output byte as written once, whatever a kernel reads again.
"""
from __future__ import annotations

from typing import List, Tuple

F32 = 4


def mlp_dims(cfg: dict) -> Tuple[List[int], List[int]]:
    """Layer widths of the bottom and top MLPs, inputs first."""
    feats = cfg["interaction_proj"] + 1
    bottom = [cfg["num_dense_features"], *cfg["bottom_mlp"]]
    top = [cfg["bottom_mlp"][-1] + feats * (feats - 1) // 2, *cfg["top_mlp"]]
    return bottom, top


def _pairs(dims: List[int]):
    return list(zip(dims[:-1], dims[1:]))


def tower_params(cfg: dict) -> int:
    """Parameters of the dense tower: both MLPs' weights and biases and
    the projection of the pooled tables to ``interaction_proj`` features."""
    bottom, top = mlp_dims(cfg)
    n = sum(a * b + b for a, b in _pairs(bottom) + _pairs(top))
    return n + cfg["num_tables"] * cfg["interaction_proj"]


def tower_flops_per_sample(cfg: dict) -> int:
    """Multiply-adds (x2) of one sample through the tower: the MLPs'
    products, the projection (T -> K features of D) and the pairwise
    interaction over K + 1 features (the whole F x F product)."""
    bottom, top = mlp_dims(cfg)
    f = sum(2 * a * b for a, b in _pairs(bottom) + _pairs(top))
    K, D, T = cfg["interaction_proj"], cfg["embed_dim"], cfg["num_tables"]
    f += 2 * T * K * D
    f += 2 * (K + 1) * (K + 1) * D
    return f


def tower_bytes(cfg: dict, batch: int) -> int:
    """Bytes one call of the tower must move: its parameters, the dense
    features and the pooled (B, T, D) read once, the logits written once."""
    T, D = cfg["num_tables"], cfg["embed_dim"]
    return F32 * (tower_params(cfg) + batch * cfg["num_dense_features"]
                  + batch * T * D + batch)


def bag_bytes(valid_slots: int, index_slots: int, bags: int, tables: int,
              dim: int) -> int:
    """Bytes of flat-bag launches: each valid slot's fp32 row read once,
    each int32 index slot read once, the fp32 pooled output (one row a
    bag) written once, and each launch's int32 table offsets."""
    return F32 * (valid_slots * dim + index_slots + bags * dim + tables)

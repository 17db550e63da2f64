"""Analytic DLRM counts: dense FLOPs, sparse bytes and table bytes per
sample, which the serving-unit stage model prices."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def dlrm_dense_flops(cfg: ModelConfig) -> int:
    """DenseNet FLOPs per sample (bottom MLP + proj + interaction + top)."""
    r = cfg.dlrm
    f = 0
    dims = (r.num_dense_features,) + r.bottom_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2 * a * b
    f += 2 * r.num_tables * r.interaction_proj * r.embed_dim
    nf = r.interaction_proj + 1
    f += 2 * nf * nf * r.embed_dim
    inter = nf * (nf - 1) // 2
    dims = (r.bottom_mlp[-1] + inter,) + r.top_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2 * a * b
    return f


def dlrm_sparse_bytes(cfg: ModelConfig) -> float:
    """SparseNet bytes touched per sample (sum over tables of pooling x row)."""
    r = cfg.dlrm
    return r.num_tables * r.avg_pooling * r.embed_dim * 4


def dlrm_size_bytes(cfg: ModelConfig) -> int:
    r = cfg.dlrm
    return r.num_tables * r.rows_per_table * r.embed_dim * 4


def dlrm_param_count(cfg: ModelConfig) -> int:
    r = cfg.dlrm
    n = r.num_tables * r.rows_per_table * r.embed_dim
    n += r.num_tables * r.interaction_proj        # interaction projection
    dims = (r.num_dense_features,) + r.bottom_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        n += a * b + b
    f = r.interaction_proj + 1
    inter = f * (f - 1) // 2
    dims = (r.bottom_mlp[-1] + inter,) + r.top_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        n += a * b + b
    return n

"""Public wrappers for the bag kernels: the counterparts of
``repro/kernels/ops.py``'s embedding-bag entries.

Dispatch is by where the tensors lie.  For CPU tensors a wrapper runs
the kernel's plain PyTorch version; for CUDA tensors it launches the
hand-written kernel or raises, never falling back.  ``LAUNCHES`` counts
each kernel's launches (and nothing else), so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import embedding_bag as _eb

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"embedding_bag_fused_flat": 0,
                            "embedding_bag_nmp_flat": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def embedding_bag_fused_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """CN-side pooling of a flat shard: (sum_t R_t, D), offsets (T,)
    int32, idx (B, T, P) int32 -1 padded -> pooled (B, T, D) fp32."""
    if flat_table.device.type == "cpu":
        return _eb.embedding_bag_flat_plain(flat_table, offsets, idx)
    out = _eb.embedding_bag_fused_flat(flat_table, offsets, idx)
    LAUNCHES["embedding_bag_fused_flat"] += 1
    return out


def embedding_bag_nmp_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """On-MN (near-memory) pooling: same contract and bits as
    :func:`embedding_bag_fused_flat`, table-major execution."""
    if flat_table.device.type == "cpu":
        return _eb.embedding_bag_flat_plain(flat_table, offsets, idx)
    out = _eb.embedding_bag_nmp_flat(flat_table, offsets, idx)
    LAUNCHES["embedding_bag_nmp_flat"] += 1
    return out


def _table_offsets(tables: torch.Tensor) -> torch.Tensor:
    T, R, _ = tables.shape
    if T * R > torch.iinfo(torch.int32).max:
        raise ValueError(f"{T} tables of {R} rows exceed the kernels' "
                         f"int32 row offsets")
    return torch.arange(T, dtype=torch.int32, device=tables.device) * R


def embedding_bag_fused(tables: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """tables (T, R, D); idx (B, T, P) -> pooled (B, T, D) in the
    tables' dtype, through the fused flat kernel."""
    T, R, D = tables.shape
    out = embedding_bag_fused_flat(tables.reshape(T * R, D),
                                   _table_offsets(tables), idx)
    return out.to(tables.dtype)


def embedding_bag_nmp(tables: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """tables (T, R, D); idx (B, T, P) -> pooled (B, T, D) in the
    tables' dtype, through the near-memory flat kernel."""
    T, R, D = tables.shape
    out = embedding_bag_nmp_flat(tables.reshape(T * R, D),
                                 _table_offsets(tables), idx)
    return out.to(tables.dtype)

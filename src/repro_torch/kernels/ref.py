"""Plain PyTorch oracles for the bag kernels (the counterparts of
``repro/kernels/ref.py``'s embedding-bag entries)."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import embedding_bag_flat_plain


def embedding_bag_ref(tables: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """tables (T, R, D); idx (B, T, P) int32, -1 padded -> (B, T, D) in
    the tables' dtype.  Sums each bag's slots in one reduction, like
    ``repro.models.dlrm.embedding_bag_ref``; that sum may reassociate, so
    it is close to, not bitwise equal to, the kernels."""
    T = tables.shape[0]
    valid = (idx >= 0).unsqueeze(-1)
    safe = idx.clamp(min=0).to(torch.int64)
    tix = torch.arange(T, device=tables.device)[None, :, None]
    rows = tables[tix, safe]                                  # (B,T,P,D)
    return torch.where(valid, rows, 0.0).sum(dim=2)


def embedding_bag_seq_ref(tables: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Order-exact oracle: slots added in ascending order into fp32, the
    order the kernels use, so fp32 results match them bitwise."""
    T, R, D = tables.shape
    offsets = torch.arange(T, dtype=torch.int64, device=tables.device) * R
    return embedding_bag_flat_plain(tables.reshape(T * R, D), offsets, idx)

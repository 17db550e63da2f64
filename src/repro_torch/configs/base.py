"""Model configs for the recommendation models this port serves.

Only the DLRM half of ``repro.configs.base`` is here: ``ModelConfig``
keeps the fields the RM1/RM2 modules set, and ``DLRMConfig`` is the
paper's model shape.  The LM sub-configs arrive with the LM zoo.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DLRMConfig:
    """Paper's own recommendation models (RM1/RM2, Fig. 1)."""
    num_tables: int = 64
    rows_per_table: int = 1_000_000      # mean; tables drawn heterogeneous
    embed_dim: int = 128
    avg_pooling: int = 80                # profiled average pooling factor
    num_dense_features: int = 256
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    # pooled features are projected to this many interaction channels
    # before the pairwise-dot interaction (DLRM-v2/DCN-style compression;
    # keeps DenseNet realistic at hundreds of tables)
    interaction_proj: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dlrm (the LM families arrive with the zoo)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    dlrm: Optional[DLRMConfig] = None
    notes: str = ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

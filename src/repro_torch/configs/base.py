"""Model configs for the models this port serves.

The counterpart of ``repro.configs.base``: ``ModelConfig`` keeps the
fields the RM1/RM2 modules and the dense decoder family (smollm-135m)
read, with the reference's defaults, and ``DLRMConfig`` is the paper's
model shape.  The MoE, SSM, encoder-decoder and VLM sub-configs arrive
with the rest of the LM zoo (ROADMAP Queue 1 item 6); until then
``moe`` is always None.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


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
    family: str               # dense | dlrm (the other families: zoo)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    attn_bias: bool = False           # qwen2.5: QKV projection bias
    # pad query heads to this count for head-TP divisibility (padded heads
    # are masked out of the output path: zero contribution + zero grads)
    pad_heads_to: Optional[int] = None
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    moe: Optional[Any] = None         # MoEConfig arrives with the zoo
    dlrm: Optional[DLRMConfig] = None
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        return self.pad_heads_to or self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

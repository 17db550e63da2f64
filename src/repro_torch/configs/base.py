"""Model configs for the models this port serves.

The counterpart of ``repro.configs.base``: ``ModelConfig`` with the
reference's fields and defaults, its sub-configs (``MoEConfig``,
``SSMConfig``, ``EncDecConfig``, ``VLMConfig``) and ``DLRMConfig``, the
paper's model shape, and ``ShapeConfig``, ``SHAPES`` and
``shape_applicable``, the (arch, shape) cells that ``input_specs`` and
``cache_specs`` size.  ``scan_layers`` and ``remat`` are kept so that a
config compares field for field with the reference's; the port loops
over layers in Python (``scan_layers`` is not read) and checkpoints
each layer as ``remat`` says when it trains.  ``MeshConfig``,
``SINGLE_POD`` and ``MULTI_POD`` are the production meshes that
``launch.mesh.make_production_mesh`` builds and ``launch.dryrun`` costs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    # expert-parallel padding: pad num_experts up to a multiple of the model
    # axis so EP divides evenly (qwen2-moe: 60 -> 64).
    ep_pad_to: Optional[int] = None
    router_aux_loss: float = 0.001
    capacity_factor: float = 1.25

    @property
    def padded_experts(self) -> int:
        return self.ep_pad_to or self.num_experts


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters (zamba2) or RWKV6 parameters."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256          # chunked-scan block length
    # zamba2 hybrid: one (shared) attention block every `attn_every` layers.
    attn_every: int = 0       # 0 = pure SSM stack
    shared_attn_params: bool = True


@dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 32
    encoder_seq: int = 1500   # whisper: 30s of audio -> 1500 frames (stub)


@dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 576    # anyres base tile, 24x24 patches (stub embeds)


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
    family: str               # dense | moe | hybrid | vlm | audio | ssm | dlrm
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    dlrm: Optional[DLRMConfig] = None
    # the reference's lowering strategy: its scan over layers (the port
    # loops in Python) and the remat policy of the training path
    scan_layers: bool = True
    remat: str = "full"               # none | dots | full
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        return self.pad_heads_to or self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter counts ----
    def param_count(self) -> int:
        from repro_torch.configs import counting
        return counting.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.configs import counting
        return counting.active_param_count(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(model: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("SKIP(full-attention): long_500k needs "
                       "sub-quadratic attention")
    return True, ""


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))

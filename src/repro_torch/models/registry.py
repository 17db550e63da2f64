"""Model registry + mode-dependent sharding rules.

The counterpart of ``repro.models.registry``.  ``build(cfg)`` returns
the model object for a config: the decoder LM (dense, MoE and VLM,
``models/transformer``), the recurrent families (``hybrid``: zamba2,
``models/mamba2``; ``ssm``: rwkv6, ``models/rwkv6``), the whisper
encoder-decoder and the paper's DLRM.  ``make_rules(cfg, mesh, mode)``
resolves the logical-axis rule set for a mesh (a ``DeviceMesh`` or a
shape dict) and program kind:

train/prefill:
  - head-TP (Megatron) when num_heads divides the model axis;
  - FSDP-over-data for attention-ish weights otherwise (qwen2.5 40H,
    whisper 20H, smollm 9H, rwkv6 40H do not divide 16) -- stored sharded
    on the contracting dim over ``data``, gathered at use;
decode:
  - attention weights shard on the contracting/output d_model dims over
    ``model`` (universal divisibility), heads replicated, KV cache
    sequence-sharded over ``model`` with shard-local partial softmax.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import DEFAULT_RULES, mesh_shape


def build(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.mamba2 import Zamba2Model
        return Zamba2Model(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import RWKV6Model
        return RWKV6Model(cfg)
    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(cfg)
    if cfg.family == "dlrm":
        from repro_torch.models.dlrm import DLRMModel
        return DLRMModel(cfg)
    raise ValueError(cfg.family)


def make_rules(cfg: ModelConfig, mesh, mode: str,
               overrides: Optional[Dict] = None) -> Dict:
    """Logical-axis rules for (arch, mesh, mode). mode: train|prefill|decode."""
    tp = mesh_shape(mesh).get("model", 1)
    rules = dict(DEFAULT_RULES)

    heads_div = tp > 1 and cfg.padded_heads % tp == 0
    kv_div = tp > 1 and cfg.num_kv_heads % tp == 0

    if mode == "decode":
        rules.update({
            "attn_din": ("model",), "attn_din_c": ("model",),
            "attn_dout": ("model",), "attn_dout_c": ("model",),
            "heads": None, "kv_heads": None,
            "kv_seq": ("model",), "seq_sp": None,
        })
    elif heads_div:
        rules.update({
            "attn_din": None, "attn_din_c": None,
            "attn_dout": None, "attn_dout_c": None,
            "heads": ("model",),
            "kv_heads": ("model",) if kv_div else None,
            "kv_seq": ("model",), "seq_sp": ("model",),
        })
    else:
        # FSDP: weights live sharded over data, gathered at use
        rules.update({
            "attn_din": ("data",), "attn_din_c": None,
            "attn_dout": None, "attn_dout_c": None,
            "heads": None, "kv_heads": None,
            "kv_seq": ("model",), "seq_sp": ("model",),
        })

    # large MoE: expert FFN dim additionally shards over data at rest
    # (ZeRO-3-style), gathered per layer at use.  Decode keeps weights
    # resident (per-token gathers would swamp the interconnect).
    if cfg.moe is not None and mode != "decode":
        if cfg.param_count() * 2 / 16 > 4e9:   # >4GB/device resident
            rules["expert_ffn"] = ("data",)

    # mamba heads (d_inner/head_dim) shard over model when divisible
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        nh = di // cfg.ssm.head_dim
        rules["mamba_heads"] = ("model",) if (tp > 1 and nh % tp == 0) else None

    # DLRM: TB-scale tables shard 2D (tables x rows)
    if cfg.family == "dlrm":
        rules["table_rows"] = ("data",)

    if overrides:
        rules.update(overrides)
    return rules


def mode_for_shape(shape) -> str:
    return {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]

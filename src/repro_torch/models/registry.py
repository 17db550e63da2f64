"""Model registry: ``build(cfg)`` returns the model object for a config.

The counterpart of ``repro.models.registry.build``: the decoder LM
(dense, MoE and VLM, ``models/transformer``), the recurrent families
(``hybrid``: zamba2, ``models/mamba2``; ``ssm``: rwkv6,
``models/rwkv6``), the whisper encoder-decoder and the paper's DLRM.
``make_rules`` and ``mode_for_shape`` wait for the mesh (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


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

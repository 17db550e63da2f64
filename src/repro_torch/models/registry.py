"""Model registry: ``build(cfg)`` returns the model object for a config.

The counterpart of ``repro.models.registry.build``: the decoder LM
(dense, MoE and VLM), the whisper encoder-decoder and the paper's DLRM.
The recurrent families (``hybrid``: zamba2, ``ssm``: rwkv6) raise until
ROADMAP Queue 1 item 6b brings them; ``make_rules`` and
``mode_for_shape`` wait for the mesh (item 8).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg)
    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(cfg)
    if cfg.family == "dlrm":
        from repro_torch.models.dlrm import DLRMModel
        return DLRMModel(cfg)
    if cfg.family in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 6b: mamba2/zamba2 and rwkv6)")
    raise ValueError(cfg.family)

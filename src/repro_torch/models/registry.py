"""Model registry: ``build(cfg)`` returns the model object for a config.

The counterpart of ``repro.models.registry.build`` for the families the
port serves: the dense decoder LM and the paper's DLRM.  The other LM
families raise until ROADMAP Queue 1 item 6 brings them; ``make_rules``
waits for the mesh (item 8).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build(cfg: ModelConfig):
    if cfg.family == "dense":
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg)
    if cfg.family == "dlrm":
        from repro_torch.models.dlrm import DLRMModel
        return DLRMModel(cfg)
    if cfg.family in ("moe", "vlm", "hybrid", "ssm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 6)")
    raise ValueError(cfg.family)

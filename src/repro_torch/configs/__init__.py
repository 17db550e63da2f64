"""Config registry: ``--arch <id>`` resolution for every architecture of
the reference: its LM zoo and the paper's own RM1/RM2 models.
``models.registry.build`` builds a model for every one of them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    MULTI_POD, SHAPES, SINGLE_POD, DLRMConfig, EncDecConfig, MeshConfig,
    ModelConfig, MoEConfig, ShapeConfig, SSMConfig, VLMConfig,
    shape_applicable,
)

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-4b": "qwen3_4b",
    "smollm-135m": "smollm_135m",
    "llama3-8b": "llama3_8b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "zamba2-7b": "zamba2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-3b": "rwkv6_3b",
    "rm1": "rm1",
    "rm2": "rm2",
}

ASSIGNED_ARCHS: List[str] = [a for a in _ARCH_MODULES if a not in ("rm1", "rm2")]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def get_generation(arch: str, v: int) -> ModelConfig:
    """RM1/RM2 evolution generations V0..V5 (paper Fig. 1)."""
    return _module(arch).generation(v)


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)

"""Config registry: ``--arch <id>`` resolution for the models the port
serves: the paper's recommendation models (RM1, RM2) and, of the LM
zoo, smollm-135m.  The other LM archs arrive with the rest of the zoo."""
from __future__ import annotations

from repro_torch.configs import rm1, rm2, smollm_135m
from repro_torch.configs.base import DLRMConfig, ModelConfig  # noqa: F401

_ARCHS = {"rm1": rm1, "rm2": rm2, "smollm-135m": smollm_135m}
# the reference's other archs, each waiting for its ROADMAP item
_LM_ZOO = ("qwen2.5-14b", "qwen3-4b", "llama3-8b", "phi3.5-moe-42b-a6.6b",
           "qwen2-moe-a2.7b", "zamba2-7b", "llava-next-mistral-7b",
           "whisper-large-v3", "rwkv6-3b")


def _module(arch: str):
    if arch not in _ARCHS:
        where = ("ROADMAP Queue 1 item 6 (the LM zoo)" if arch in _LM_ZOO
                 else "no ROADMAP item: the reference has no such arch")
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet ({where}); the port serves "
            f"{sorted(_ARCHS)}")
    return _ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED

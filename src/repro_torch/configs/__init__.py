"""Config registry: ``--arch <id>`` resolution for the recommendation
models the port serves (RM1, RM2).  The LM archs arrive with the zoo."""
from __future__ import annotations

from repro_torch.configs import rm1, rm2
from repro_torch.configs.base import DLRMConfig, ModelConfig  # noqa: F401

_ARCHS = {"rm1": rm1, "rm2": rm2}


def _module(arch: str):
    if arch not in _ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port serves "
            f"{sorted(_ARCHS)} (the LM zoo is a later ROADMAP item)")
    return _ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED

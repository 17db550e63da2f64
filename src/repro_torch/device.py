"""Where the port runs: the one rule every entry point goes through.

The port is written for a CUDA card.  An entry point called without a
``device`` runs there, and raises when the machine has none: it never
drops to the CPU on its own.  The CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do, and then every kernel
wrapper takes its plain PyTorch version.

On the card, float32 matrix products and convolutions run in full
float32 (TF32 off): the scores are held against the reference's float32
math, and TF32 keeps only about three decimal digits.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run its plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def require_on(t: torch.Tensor, device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device`` (an index-less ``cuda``
    matches any card): engines never move their parameters silently."""
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(
            f"parameters lie on {t.device}, the engine runs on {device}: "
            f"build them with init(seed, device=...) or "
            f"params_from_reference(..., device=...)")

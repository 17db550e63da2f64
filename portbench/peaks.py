"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA's H100 SXM data sheet, dense rates: 67 TFLOP/s in float32
outside the tensor cores (the DLRM tower runs float32 with TF32 off)
and 3.35 TB/s of HBM3, both at the card's full 700 W.  A card whose
power limit is lower reaches less; the harness reports the limit.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def for_device(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)

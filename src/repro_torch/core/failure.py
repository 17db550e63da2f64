"""Machine failure modeling (paper §IV-D, Fig. 9).

Four daily machine states: available all day, inaccessible all day,
recovers mid-day, fails mid-day. Backup machines absorb the fourth
category. Deterministic seeded generator (no wall-clock use).
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import hardware as hw


@dataclass(frozen=True)
class FailureEvent:
    node_id: int
    kind: str          # "cn" | "mn" | "mono"
    time_s: float      # within-day failure time


class FailureTrace:
    """Daily failure sampling for a fleet."""

    def __init__(self, n_nodes: int, kind: str, daily_rate: float, seed: int = 0):
        self.n = n_nodes
        self.kind = kind
        self.rate = daily_rate
        self.rng = _random.Random(seed ^ hash(kind) & 0xFFFF)

    def sample_day(self) -> List[FailureEvent]:
        out = []
        for i in range(self.n):
            if self.rng.random() < self.rate:
                out.append(FailureEvent(i, self.kind,
                                        self.rng.random() * 86400.0))
        return sorted(out, key=lambda e: e.time_s)


def unit_failure_rate(n_cn: int, m_mn: int,
                      f_cn: float = hw.FAIL_CN,
                      f_mn: float = hw.FAIL_MN) -> float:
    """Weighted per-node failure rate of a disaggregated unit (Eq. 2)."""
    return (f_cn * n_cn + f_mn * m_mn) / (n_cn + m_mn)


def expected_backups(n_units: int, n_cn: int, m_mn: int,
                     scheme: str = "disagg") -> float:
    """Mean backup nodes/day for a fleet of serving units."""
    if scheme == "disagg":
        return n_units * (n_cn * hw.FAIL_CN + m_mn * hw.FAIL_MN)
    return n_units * n_cn * hw.FAIL_GPU_SERVER


def recovery_cost_s(kind: str) -> float:
    """Time to restore service after a failure (migration / re-route).

    CN failure: migrate the primary task to a backup node (restore model
    replica + warm-up). MN failure with surviving replicas: rebuild the
    MemAccess routing table only (fast). Monolithic: full server migration.
    """
    return {"cn": 120.0, "mn": 5.0, "mono": 180.0}[kind]

"""Failure-aware resource allocation (paper §IV-D, Eq. 1-3).

    Minimize  N_peak * Capex_S + sum_t P(t) * Rate_E           (1)
    s.t.      N(t) >= (1+R%) * load(t)/QPS_{M,S}
                    + (F_CN%*n + F_MN%*m)/(n+m) * load_peak/QPS (2)
              P(t) >= Power_{M,S} * N(t)                        (3)

QPS_{M,S} and Power_{M,S} come from offline characterization
(core/serving_unit.py or measured). Loads are diurnal (Fig. 2b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.core import hardware as hw
from repro_torch.core.serving_unit import ServingUnitModel, UnitSpec


def diurnal_load(peak: float, steps: int = 96) -> List[float]:
    """24h load curve (Fig. 2b): trough ~40% of peak, peak at 6pm."""
    out = []
    for i in range(steps):
        t = i / steps * 24.0
        out.append(peak * (0.7 + 0.3 * math.sin(2 * math.pi * (t - 12.0) / 24.0)))
    return out


@dataclass
class AllocationPlan:
    unit: UnitSpec
    qps_per_unit: float
    n_units: List[int]            # N(t) per step
    n_peak: int
    capex: float
    opex: float                   # energy over the evaluation horizon
    tco: float
    failure_units: float          # over-provision attributable to failures
    idle_units: float             # mean (N_peak - N(t)) gap


def allocate(unit: UnitSpec, qps_per_unit: float, power_per_unit: float,
             peak_load: float, horizon_days: float = 365.0 * hw.LIFETIME_YEARS,
             r_margin: float = hw.LOAD_VARIANCE_R,
             f_cn: float = hw.FAIL_CN, f_mn: float = hw.FAIL_MN,
             steps: int = 96) -> AllocationPlan:
    if qps_per_unit <= 0:
        raise ValueError("unit cannot serve the model (QPS=0)")
    loads = diurnal_load(peak_load, steps)
    n, m = unit.n, (unit.m if unit.scheme == "disagg" else 0)
    if unit.scheme == "disagg":
        f_rate = (f_cn * n + f_mn * m) / (n + m)
    else:
        # a monolithic server is lost when EITHER its compute or its
        # memory fails — the margin must cover both part failure rates
        f_rate = f_cn + f_mn
    fail_extra = f_rate * peak_load / qps_per_unit

    n_units = [math.ceil((1 + r_margin) * L / qps_per_unit + fail_extra)
               for L in loads]
    n_peak = max(n_units)

    step_s = 24 * 3600.0 / steps
    day_energy = sum(power_per_unit * nu * step_s for nu in n_units)  # J/day
    opex = day_energy * horizon_days * hw.ELECTRICITY_RATE
    capex = n_peak * unit.capex()
    mean_n = sum(n_units) / len(n_units)
    return AllocationPlan(
        unit=unit, qps_per_unit=qps_per_unit, n_units=n_units,
        n_peak=n_peak, capex=capex, opex=opex, tco=capex + opex,
        failure_units=fail_extra, idle_units=n_peak - mean_n,
    )


def allocate_from_model(model, unit: UnitSpec, peak_load: float,
                        sla: float = 0.1, **kw) -> AllocationPlan:
    sm = ServingUnitModel(model, unit)
    if not sm.fits():
        raise ValueError(f"{unit} cannot hold {model.name}")
    qps, _ = sm.latency_bounded_qps(sla=sla)
    return allocate(unit, qps, unit.power(), peak_load, **kw)


def best_unit(model, candidates: Sequence[UnitSpec], peak_load: float,
              sla: float = 0.1) -> Tuple[AllocationPlan, List[AllocationPlan]]:
    """Paper's design-space exploration (Fig. 12): pick min-TCO unit."""
    plans = []
    for u in candidates:
        try:
            plans.append(allocate_from_model(model, u, peak_load, sla=sla))
        except ValueError:
            continue
    if not plans:
        raise ValueError("no feasible unit for model")
    best = min(plans, key=lambda p: p.tco)
    return best, plans

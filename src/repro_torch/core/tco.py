"""TCO accounting across model generations (paper §VI, Figs. 10-14)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core import hardware as hw
from repro_torch.core.allocator import (AllocationPlan, allocate_from_model,
                                        best_unit)
from repro_torch.core.serving_unit import ServingUnitModel, UnitSpec


def monolithic_candidates(max_servers: int = 16) -> List[UnitSpec]:
    out = []
    for n in range(1, max_servers + 1):
        for t in ("so1s_1g", "so1s_2g", "so1s_4g"):
            out.append(UnitSpec(n=n, cn_type=t, scheme="distributed"))
    out.append(UnitSpec(n=1, cn_type="su2s", scheme="su_numa"))
    out.append(UnitSpec(n=1, cn_type="su2s", scheme="su_naive"))
    return out


def monolithic_nmp_candidates(max_servers: int = 16) -> List[UnitSpec]:
    out = []
    for n in range(1, max_servers + 1):
        for t in ("so1s_1g_nmp", "so1s_4g_nmp"):
            out.append(UnitSpec(n=n, cn_type=t, scheme="distributed"))
    return out


def disagg_candidates(max_cn: int = 8, max_mn: int = 16,
                      mn_type: str = "ddr_mn") -> List[UnitSpec]:
    out = []
    for n in range(1, max_cn + 1):
        for m in range(1, max_mn + 1):
            for cn in ("cn_1g", "cn_4g"):
                out.append(UnitSpec(n=n, cn_type=cn, m=m, mn_type=mn_type,
                                    scheme="disagg"))
    return out


@dataclass
class GenerationResult:
    model_name: str
    plan: AllocationPlan
    tco: float


def evolution_study(generations: Sequence, candidates_fn, peak_load: float,
                    sla: float = 0.1) -> List[GenerationResult]:
    """Optimal unit per generation; returns per-generation TCO (Fig. 13/14)."""
    out = []
    for g in generations:
        plan, _ = best_unit(g, candidates_fn(), peak_load, sla=sla)
        out.append(GenerationResult(g.name, plan, plan.tco))
    return out


def idleness_breakdown(model, unit: UnitSpec, peak_load: float,
                       sla: float = 0.1) -> Dict[str, float]:
    """Paper Fig. 11: % of TCO wasted on (a) over-provisioned capacity for
    failures+diurnal gap, (b) unbalanced-pipeline idleness inside servers."""
    sm = ServingUnitModel(model, unit)
    qps, b = sm.latency_bounded_qps(sla=sla)
    plan = allocate_from_model(model, unit, peak_load, sla=sla)
    st = sm.stage_times(b or 256)
    bott = st.bottleneck()
    # fraction of each resource idle while pipeline is bottlenecked
    idle_pre = 1.0 - st.t_pre / bott
    idle_dense = 1.0 - st.t_dense / bott
    idle_sparse = 1.0 - st.t_sparse / bott
    # cost weights: CPU vs GPU vs memory share of the unit capex
    cn = unit.cn
    cpu_cost = sum(hw.DEVICE_PRICE[c] for c in cn.cpus) * unit.n
    gpu_cost = cn.gpus * hw.DEVICE_PRICE["a100"] * unit.n
    mem_cost = sum(nn * hw.DEVICE_PRICE[d] for d, nn in cn.dimms.items()) * unit.n
    if unit.scheme == "disagg":
        mn = unit.mn
        mem_cost += unit.m * mn.capex
    total_cost = unit.capex()
    idle_frac = (0.5 * cpu_cost * idle_pre + gpu_cost * idle_dense
                 + mem_cost * idle_sparse + 0.5 * cpu_cost * idle_sparse
                 ) / total_cost
    over_frac = plan.failure_units / max(plan.n_peak, 1)
    return {
        "pipeline_idle_tco_frac": idle_frac,
        "overprovision_tco_frac": over_frac,
        "batch": float(b),
        "qps": qps,
    }

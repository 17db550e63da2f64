"""Autoscaling for the elastic ClusterEngine: a schedule-driven diurnal
policy (paper §III, Fig. 2b/11) and a feedback-driven SLA controller.
The port's copy of ``repro.serving.autoscaler``: numpy and the analytic
models only, no device.

Two complementary controllers live here:

- :class:`Autoscaler` — *schedule-driven*: maps the diurnal load curve
  onto timed ``ResizeEvent``s ahead of time.  Right when demand is
  forecastable (the paper's provisioning argument), blind to surprises.
- :class:`SLAController` — *feedback-driven*: watches a sliding window
  of measured completion latencies against an SLA target on p99
  (``ScenarioSpec.sla_p99_s``) and emits ``Resize`` events through the
  live typed timeline the moment the measured tail leaves the band —
  scale up when p99 breaches the target, scale back down once it falls
  below ``band_low x`` target.  Right when demand is NOT forecastable
  (flash crowds, spikes compounded with failures — Gupta et al.'s
  bursty production traffic).

The paper's provisioning argument: a fixed-proportion deployment pins the
peak-hour {n CN, m MN} all day, and the diurnal trough (~40% of peak,
Fig. 2b) turns up to 30% of TCO into idle units (Fig. 11).
Disaggregation fixes the *shape* of the waste — compute can follow the
load curve independently, while the memory pool only ever shrinks to its
capacity floor (the replicated embedding tables must stay resident).  A
monolithic fleet cannot make that split: every server carries both parts,
so its floor is the number of servers needed to HOLD the model, no matter
how low the load falls.

`Autoscaler` turns that policy into timed `ResizeEvent`s that
``ClusterEngine.serve`` consumes alongside failure events, and into
per-step {n, m} series for the TCO accounting in
``benchmarks/bench_elastic.py``.  Per-node service rates come from the
same analytic `ServingUnitModel` capacities the allocator uses, so the
elastic plan and the failure-aware allocation (`core/allocator.py`,
Eq. 1-3) are cross-checkable: a fixed-peak plan's idle unit-hours equal
``AllocationPlan.idle_units`` x the horizon.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.configs import counting
from repro_torch.core import hardware as hw
from repro_torch.core.allocator import diurnal_load
from repro_torch.core.hardware import NODE_TYPES
from repro_torch.core.serving_unit import ServingUnitModel, UnitSpec
from repro_torch.serving.scenario import Resize, nearest_rank


class ResizeEvent(NamedTuple):
    """One timed resize; unpacks as the (time_s, n_cn, m_mn) tuple
    ``ClusterEngine.serve(resizes=...)`` expects."""
    time_s: float
    n_cn: int
    m_mn: int


@dataclass(frozen=True)
class AutoscalerConfig:
    qps_per_cn: float             # compute-side samples/s one CN sustains
    qps_per_mn: float             # scan-side samples/s one MN sustains
    min_cn: int = 1
    min_mn: int = 1               # capacity floor: replicas stay resident
    max_cn: Optional[int] = None
    max_mn: Optional[int] = None
    headroom: float = hw.LOAD_VARIANCE_R   # R% load-variance margin


def _clamp(v: int, lo: int, hi: Optional[int]) -> int:
    v = max(lo, v)
    return v if hi is None else min(v, hi)


class Autoscaler:
    """Demand-following sizing: n_cn tracks the load curve, m_mn tracks
    scan bandwidth demand but never drops below the capacity floor."""

    def __init__(self, cfg: AutoscalerConfig):
        if cfg.qps_per_cn <= 0 or cfg.qps_per_mn <= 0:
            raise ValueError("per-node service rates must be positive")
        self.cfg = cfg

    # ------------------------------------------------------ constructors
    @classmethod
    def for_model(cls, model_cfg, cn_type: str = "cn_1g",
                  mn_type: str = "ddr_mn", n_replicas: int = 2,
                  max_cn: Optional[int] = None,
                  max_mn: Optional[int] = None,
                  headroom: float = hw.LOAD_VARIANCE_R) -> "Autoscaler":
        """Derive per-node service rates from the analytic unit model of
        a {1 CN, 1 MN} cell — the same capacities() the allocator's
        QPS_{M,S} characterization uses."""
        um = ServingUnitModel(model_cfg, UnitSpec(1, cn_type, 1, mn_type))
        caps = um.capacities()
        qps_cn = min(caps["pre"], caps["dense"],
                     caps.get("comm", math.inf))
        qps_mn = caps["sparse"]
        size = counting.dlrm_size_bytes(model_cfg)
        mn_cap = NODE_TYPES[mn_type].mem_capacity
        min_mn = max(1, math.ceil(n_replicas * size / mn_cap))
        return cls(AutoscalerConfig(
            qps_per_cn=qps_cn, qps_per_mn=qps_mn, min_cn=1, min_mn=min_mn,
            max_cn=max_cn, max_mn=max_mn, headroom=headroom))

    @classmethod
    def monolithic(cls, model_cfg, server_type: str = "so1s_1g",
                   headroom: float = hw.LOAD_VARIANCE_R) -> "Autoscaler":
        """Elastic *monolithic* fleet: one node type carries compute AND
        memory, so the scale-down floor is the server count needed to
        hold the sharded model — the coupling the paper's Fig. 11
        charges for.  `units_for` reports (n_servers, 0)."""
        um = ServingUnitModel(model_cfg,
                              UnitSpec(1, server_type, scheme="distributed"))
        qps = min(um.capacities().values())
        size = counting.dlrm_size_bytes(model_cfg)
        floor = max(1, math.ceil(size / NODE_TYPES[server_type].mem_capacity))
        return cls(AutoscalerConfig(
            qps_per_cn=qps, qps_per_mn=math.inf, min_cn=floor, min_mn=0))

    # ------------------------------------------------------------ policy
    def units_for(self, load: float) -> Tuple[int, int]:
        c = self.cfg
        need = (1.0 + c.headroom) * max(load, 0.0)
        n = _clamp(math.ceil(need / c.qps_per_cn), c.min_cn, c.max_cn)
        if math.isinf(c.qps_per_mn):
            m = _clamp(0, c.min_mn, c.max_mn)
        else:
            m = _clamp(math.ceil(need / c.qps_per_mn), c.min_mn, c.max_mn)
        return n, m

    def series(self, peak_load: float, steps: int = 96
               ) -> List[Tuple[int, int]]:
        """Per-step {n_cn, m_mn} over one diurnal day (Fig. 2b)."""
        return [self.units_for(L) for L in diurnal_load(peak_load, steps)]

    def plan(self, peak_load: float, duration_s: float = 86400.0,
             steps: int = 96) -> List[ResizeEvent]:
        """Timed resize events over `duration_s` (the diurnal shape is
        mapped onto the horizon): one event per step where the required
        pool size changes, including the t=0 snap to the plan start."""
        out: List[ResizeEvent] = []
        prev: Optional[Tuple[int, int]] = None
        for i, (n, m) in enumerate(self.series(peak_load, steps)):
            if (n, m) != prev:
                out.append(ResizeEvent(i * duration_s / steps, n, m))
                prev = (n, m)
        return out


# ---------------------------------------------------- SLA feedback loop
@dataclass(frozen=True)
class SLAControllerConfig:
    """Feedback-control knobs.  The controller holds measured p99 inside
    ``[band_low * sla_p99_s, sla_p99_s]``: above the target it scales
    up by ``step``; below the lower band edge it scales back down —
    hysteresis that keeps a noisy tail from thrashing the pool.
    ``window`` completions form the sliding p99 estimate (nearest-rank,
    the serving layer's percentile convention) and ``cooldown``
    completions must pass between actions; the window is cleared on
    every emission, so each resize's effect is *measured* before the
    next decision (a stale window would re-trigger on the same breach).

    ``mode`` picks the scaling split — the paper's decoupled-scaling
    claim applied to feedback control:

    - ``coupled`` (default): a breach steps both pools in lockstep.
    - ``decoupled``: a breach is attributed to the *binding* pool via
      the dispatcher's per-node queueing pressure — scale CNs for a
      compute/gather-bound tail, MNs for a scan/bus-bound tail, and
      both only when the two pressures sit within a ``mix_band`` factor
      of each other (genuinely mixed).  Scale-down releases both pools
      toward their floors; every emitted ``Resize`` carries only the
      dims that actually change (partial events)."""
    sla_p99_s: float
    window: int = 32
    band_low: float = 0.5
    cooldown: int = 16
    step: int = 1
    max_scale: int = 4            # pool ceiling: max_scale x initial
    mode: str = "coupled"         # coupled | decoupled
    mix_band: float = 2.0         # decoupled: pressures within this
                                  # factor of each other scale both


class SLAController:
    """Measured-p99 feedback autoscaler.

    The dispatcher calls :meth:`observe` once per query completion with
    the virtual finish time and measured latency; the controller
    returns ``Resize`` events to enqueue into the live timeline (empty
    list almost always).  The initial topology is the scale-*down*
    floor — the replicated embedding tables were provisioned for that
    pool, so the controller only ever adds capacity on top and releases
    it again (the paper's capacity-floor argument, applied to feedback
    control).  Emission timestamps are clamped monotone so the audit
    trail stays time-ordered.
    """

    def __init__(self, cfg: SLAControllerConfig, n_cn: int, m_mn: int):
        if cfg.sla_p99_s <= 0:
            raise ValueError("sla_p99_s must be positive")
        if cfg.window < 1 or cfg.cooldown < 0 or cfg.step < 1:
            raise ValueError("window/cooldown/step out of range")
        if not 0.0 <= cfg.band_low < 1.0:
            raise ValueError("band_low must be in [0, 1)")
        if cfg.max_scale < 1:
            raise ValueError("max_scale must be >= 1")
        if cfg.mode not in ("coupled", "decoupled"):
            raise ValueError(f"unknown SLA controller mode {cfg.mode!r}")
        if cfg.mix_band < 1.0:
            raise ValueError("mix_band must be >= 1")
        self.cfg = cfg
        self.min_cn, self.min_mn = int(n_cn), int(m_mn)
        self.max_cn = self.min_cn * cfg.max_scale
        self.max_mn = self.min_mn * cfg.max_scale
        self.n_cn, self.m_mn = self.min_cn, self.min_mn
        self._lats: deque = deque(maxlen=cfg.window)
        self._since = 0             # completions since the last action
        self._last_emit = 0.0
        self.actions: List[Resize] = []     # every event ever emitted
        self.window_filled = False  # ever saw a full p99 window (a run
                                    # shorter than cfg.window can never
                                    # trigger an action — surfaced as
                                    # ClusterStats.sla_window_filled)

    def p99(self) -> float:
        """Current sliding-window p99 (nan until anything completed)."""
        return nearest_rank(list(self._lats), 99)

    def sync_pool(self, n_cn: int, m_mn: int) -> None:
        """Align the controller's internal pool view with the actual
        live pool, clamped to this controller's [min, max] bounds.

        A lone controller never needs this — its own emissions are the
        only pool movements, so the view tracks by construction.  Under
        fleet serving several controllers share one pool: the dispatcher
        calls this on every applied Resize so a controller whose peer
        (or a scheduled event) moved the pool steps relative to reality
        instead of its stale view."""
        self.n_cn = max(self.min_cn, min(int(n_cn), self.max_cn))
        self.m_mn = max(self.min_mn, min(int(m_mn), self.max_mn))

    def observe(self, t_done_s: float, latency_s: float,
                pressure: Optional[Tuple[float, float]] = None
                ) -> List[Resize]:
        """Feed one completion; returns the Resize events to enqueue.

        ``pressure`` is the dispatcher's per-node accumulated queueing
        seconds per pool ``(cn, mn)`` — the binding-pool attribution
        signal decoupled mode scales by (coupled mode ignores it)."""
        self._lats.append(float(latency_s))
        self._since += 1
        if len(self._lats) < self.cfg.window:
            return []
        self.window_filled = True
        if self._since < self.cfg.cooldown:
            return []
        p99 = self.p99()
        n, m = self.n_cn, self.m_mn
        if p99 > self.cfg.sla_p99_s:
            up_cn = up_mn = True
            if self.cfg.mode == "decoupled" and pressure is not None:
                cn_p, mn_p = pressure
                # binding-pool attribution: scale the pool whose
                # per-node queueing dominates; both only when the two
                # pressures sit within a mix_band factor (genuinely
                # mixed).  Equal (e.g. both-zero) pressure degenerates
                # to the coupled step.
                up_cn = cn_p * self.cfg.mix_band >= mn_p
                up_mn = mn_p * self.cfg.mix_band >= cn_p
            if up_cn:
                n = min(n + self.cfg.step, self.max_cn)
            if up_mn:
                m = min(m + self.cfg.step, self.max_mn)
        elif p99 < self.cfg.band_low * self.cfg.sla_p99_s:
            n = max(n - self.cfg.step, self.min_cn)
            m = max(m - self.cfg.step, self.min_mn)
        if (n, m) == (self.n_cn, self.m_mn):
            return []
        # partial event: only the dims that change ride on the Resize
        # (timeline accepts n_cn=None/m_mn=None as "keep")
        dn = n if n != self.n_cn else None
        dm = m if m != self.m_mn else None
        self.n_cn, self.m_mn = n, m
        self._since = 0
        # every completion in the window predates this action; measuring
        # them again would double-step the same breach before the
        # resize's effect shows (real whenever cooldown < window)
        self._lats.clear()
        self._last_emit = max(self._last_emit, float(t_done_s))
        ev = Resize(self._last_emit, n_cn=dn, m_mn=dm)
        self.actions.append(ev)
        return [ev]


# ------------------------------------------------------- TCO accounting
def node_hours(series: Sequence[Tuple[int, int]],
               duration_s: float = 86400.0) -> Tuple[float, float]:
    """(CN, MN) node-hours consumed by a per-step {n, m} series."""
    step_h = duration_s / 3600.0 / len(series)
    return (sum(n for n, _ in series) * step_h,
            sum(m for _, m in series) * step_h)


def idle_node_hours(series: Sequence[Tuple[int, int]],
                    duration_s: float = 86400.0) -> Tuple[float, float]:
    """Node-hours a fixed-peak deployment of the same series would idle:
    per step, (peak - demanded) for each pool."""
    n_pk = max(n for n, _ in series)
    m_pk = max(m for _, m in series)
    step_h = duration_s / 3600.0 / len(series)
    return (sum(n_pk - n for n, _ in series) * step_h,
            sum(m_pk - m for _, m in series) * step_h)


def energy_joules(series: Sequence[Tuple[int, int]], cn_type: str,
                  mn_type: str = "ddr_mn",
                  duration_s: float = 86400.0) -> float:
    """Energy of running the series for `duration_s` (constraint (3))."""
    p_cn = NODE_TYPES[cn_type].power
    p_mn = NODE_TYPES[mn_type].power if mn_type else 0.0
    step_s = duration_s / len(series)
    return sum((n * p_cn + m * p_mn) * step_s for n, m in series)

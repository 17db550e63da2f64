"""Declarative scenario API: typed event timelines, one front door.

The paper's core claims (§III-§V) are *scenario* claims — what happens
to latency, TCO, and reliability when MNs fail and recover, pools
resize diurnally, traffic skew drifts, and hardware generations mix.
This module makes a scenario a **value**: a frozen :class:`ScenarioSpec`
holding the cluster topology, the workload (with timed phase changes),
and a typed, time-ordered event timeline — with dict/JSON round-trip
serde so scenarios are files (``examples/scenarios/*.json``), not code.

Event types (all carry ``time_s``, the virtual-clock fire time):

========================  ==============================================
:class:`FailMN`           kill MN ``mn`` (replica re-route / reinit)
:class:`RecoverMN`        bring a failed MN back — *timed* recoveries
:class:`Resize`           elastic pool resize to {n_cn, m_mn}
:class:`ReloadParams`     DLRM weight reload (re-init from ``seed``)
:class:`ReplanPlacement`  re-place tables from *measured* hotness
:class:`SetWorkload`      mid-stream workload phase change (Zipf alpha,
                          arrival rate, query-size distribution;
                          ``model=`` scopes it to one fleet model)
:class:`ShiftTraffic`     move rate share from one fleet model to
                          another mid-stream (workload evolution)
========================  ==============================================

**Ordering guarantees.**  The timeline dispatcher
(``serving.timeline.TimelineDispatcher``) consumes one unified queue in
global time order; events at equal times fire in their listed order
(stable sort).  ``FailMN`` is the only event with intra-stage
semantics: a failure whose timestamp lands inside a batch's MN stage
hits packets in flight and re-issues that batch on the survivors; every
other event applies at the next batch boundary on the virtual clock.
``SetWorkload`` is consumed when the request stream is *built*
(:func:`plan_workload`) and is audit-only at dispatch time.

**Legacy parity.**  ``ClusterEngine.serve(failures=, resizes=)`` is now
a thin shim that converts the bare tuples into ``FailMN``/``Resize``
events (failures before resizes at equal times — the historical
tie-break), so legacy-kwarg runs score bitwise-identically to their
``ScenarioSpec`` equivalents (``tests/test_scenario.py`` pins a grid).

:func:`run_scenario` is the single entry point: build the model, build
the phased request stream, serve through the engine, and return a
:class:`ScenarioReport` with per-phase stats and the per-event audit
trail.  This is the PyTorch port of ``repro.serving.scenario``: the
events, the spec and its serde, the workload planner, the report, the
preset library and the lint CLI are copies, and the
``examples/scenarios/*.json`` files load here unchanged.
``python -m repro_torch.serving.scenario_cli *.json`` (note the
``_cli`` wrapper — running this module with ``-m`` executes it twice)
lints scenario files; ``--run`` executes them; ``--write-presets DIR``
re-emits the named preset library.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from dataclasses import dataclass, field
from typing import (Any, ClassVar, Dict, List, Optional, Sequence, Tuple,
                    Type)

import numpy as np

from repro_torch import configs
from repro_torch.core.hardware import NODE_TYPES
from repro_torch.data.queries import (ARRIVALS, ArrivalProcess, QueryDist,
                                      dlrm_batch, load_trace)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.dlrm import DLRMModel
from repro_torch.serving.cluster import (CN_ROUTERS, ClusterConfig,
                                         ClusterEngine, ClusterStats,
                                         _validate_mn_types)
from repro_torch.serving.engine import Request, Result


# ---------------------------------------------------------------- events
@dataclass(frozen=True)
class ScenarioEvent:
    """Base timeline event: fires at ``time_s`` on the virtual clock."""
    time_s: float
    kind: ClassVar[str] = "event"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": self.kind, "time_s": self.time_s}
        for f in dataclasses.fields(self):
            if f.name == "time_s":
                continue
            v = getattr(self, f.name)
            if v is not None:
                d[f.name] = v
        return d


@dataclass(frozen=True)
class FailMN(ScenarioEvent):
    """Kill MN ``mn``: replica re-route (fast path) or re-initialize."""
    mn: int = 0
    kind: ClassVar[str] = "fail_mn"


@dataclass(frozen=True)
class RecoverMN(ScenarioEvent):
    """Bring a failed MN back into the pool (routing rebuild only)."""
    mn: int = 0
    kind: ClassVar[str] = "recover_mn"


@dataclass(frozen=True)
class Resize(ScenarioEvent):
    """Elastic resize; ``None`` keeps that pool's current size.  Grows
    add MNs of ``mn_type`` (default: the topology's pool type)."""
    n_cn: Optional[int] = None
    m_mn: Optional[int] = None
    mn_type: Optional[str] = None
    kind: ClassVar[str] = "resize"


@dataclass(frozen=True)
class ReloadParams(ScenarioEvent):
    """DLRM weight reload: re-init params from ``seed`` (``None`` =
    warm reload of the current weights — shards re-materialize and every
    CN cache flushes, values unchanged)."""
    seed: Optional[int] = None
    kind: ClassVar[str] = "reload_params"


@dataclass(frozen=True)
class ReplanPlacement(ScenarioEvent):
    """Re-run node-type-aware placement with *measured* hotness."""
    kind: ClassVar[str] = "replan_placement"


@dataclass(frozen=True)
class SetWorkload(ScenarioEvent):
    """Mid-stream workload phase change: requests arriving at or after
    ``time_s`` use the overridden parameters (``None`` keeps the current
    value).  Consumed by :func:`plan_workload` when the stream is built;
    audit-only inside the dispatcher."""
    alpha: Optional[float] = None         # Zipf row-popularity skew
    gap_s: Optional[float] = None         # inter-arrival gap (rate)
    mean_size: Optional[float] = None     # query-size distribution
    sigma: Optional[float] = None
    max_size: Optional[int] = None
    # fleet scoping: None applies to every model; a model name scopes
    # the change to that model's stream.  A model-scoped event may not
    # set gap_s — per-model rate moves only through ShiftTraffic, so
    # the aggregate arrival rate stays a single knob.
    model: Optional[str] = None
    kind: ClassVar[str] = "set_workload"


@dataclass(frozen=True)
class DegradeMN(ScenarioEvent):
    """Slow MN ``mn``'s memory bus by ``factor`` (>= 1.0; 1.0 restores
    nominal speed) — the straggler-injection event behind the hedged
    re-issue story (FlexEMR's optimistic get).  A degraded MN scans its
    bytes at ``mem_bw / factor``; everything else (routing, scores,
    gather bytes) is untouched, so a run whose degrades all carry
    ``factor=1.0`` is bitwise-identical to one without them."""
    mn: int = 0
    factor: float = 1.0
    kind: ClassVar[str] = "degrade_mn"


@dataclass(frozen=True)
class ShiftTraffic(ScenarioEvent):
    """Move ``share`` points of normalized rate share from fleet model
    ``from_model`` to ``to_model`` at ``time_s`` — the paper's
    "fast-evolving workloads" story as a timeline event.  The aggregate
    arrival rate is conserved; only the per-model split moves.  Like
    ``SetWorkload`` it is consumed when the request stream is built
    (:func:`repro_torch.serving.fleet.plan_fleet_workload`) and
    audit-only at dispatch time.  Requires a multi-model spec."""
    from_model: str = ""
    to_model: str = ""
    share: float = 0.0
    kind: ClassVar[str] = "shift_traffic"


EVENT_TYPES: Dict[str, Type[ScenarioEvent]] = {
    c.kind: c for c in (FailMN, RecoverMN, Resize, ReloadParams,
                        ReplanPlacement, SetWorkload, DegradeMN,
                        ShiftTraffic)
}


def event_from_dict(d: Dict[str, Any]) -> ScenarioEvent:
    d = dict(d)
    kind = d.pop("type", None)
    cls = EVENT_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown scenario event type {kind!r} "
                         f"(known: {sorted(EVENT_TYPES)})")
    if "time_s" not in d:
        raise ValueError(f"{kind} event needs a time_s")
    return _build(cls, d, f"{kind} event")


def sort_events(events: Sequence[ScenarioEvent]) -> List[ScenarioEvent]:
    """The canonical dispatch order: stable sort by fire time — events
    at equal times fire in their listed order."""
    return sorted(events, key=lambda e: e.time_s)


def _is_int(v) -> bool:
    """JSON-sourced ids/counts must be true integers: a fractional MN id
    would land in the engine's dead set without ever matching a real
    node, and a bool is a typo, not a pool size."""
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_events(events: Sequence[ScenarioEvent], m_mn: int) -> None:
    """Schema + schedule-aware bounds validation.

    ``FailMN``/``RecoverMN`` ids are checked against the *schedule-aware
    maximum* pool — the largest ``m_mn`` the timeline provisions at or
    before the event's fire time — not the pool at serve start, so a
    failure scheduled after a timed grow is accepted (the target MN will
    exist when the event fires), while one scheduled *before* the only
    grow that would create its target is rejected (the schedule never
    reaches that pool state in time).  An id whose MN has shrunk away
    *by fire time* stays a runtime no-op (the machine isn't there to
    fail).
    """
    for ev in events:
        t = ev.time_s
        if not _is_num(t) or not math.isfinite(t) or t < 0:
            raise ValueError(f"{ev.kind} event has invalid time_s={t!r}")
        if isinstance(ev, Resize):
            if ev.n_cn is not None and (not _is_int(ev.n_cn)
                                        or ev.n_cn < 1):
                raise ValueError(f"resize event targets n_cn={ev.n_cn!r}")
            if ev.m_mn is not None and (not _is_int(ev.m_mn)
                                        or ev.m_mn < 1):
                raise ValueError(f"resize event targets m_mn={ev.m_mn!r}")
            if ev.mn_type is not None and (
                    ev.mn_type not in NODE_TYPES
                    or NODE_TYPES[ev.mn_type].kind != "mn"):
                raise ValueError(
                    f"resize event adds unknown memory-node type "
                    f"{ev.mn_type!r}")
        elif isinstance(ev, SetWorkload):
            for name, lo in (("alpha", 0.0), ("gap_s", 0.0),
                             ("mean_size", None), ("sigma", 0.0)):
                v = getattr(ev, name)
                if v is None:
                    continue
                if not _is_num(v):
                    raise ValueError(
                        f"set_workload {name} must be a number, "
                        f"got {v!r}")
                if lo is None and v <= 0:
                    raise ValueError(f"set_workload {name} must be > 0")
                if lo is not None and v < lo:
                    raise ValueError(
                        f"set_workload {name} must be >= {lo:g}")
            if ev.max_size is not None and (not _is_int(ev.max_size)
                                            or ev.max_size < 1):
                raise ValueError("set_workload max_size must be an "
                                 "integer >= 1")
            if ev.model is not None and (not isinstance(ev.model, str)
                                         or not ev.model):
                raise ValueError(
                    f"set_workload model must be a non-empty model "
                    f"name when set, got {ev.model!r}")
        elif isinstance(ev, ShiftTraffic):
            for name, v in (("from_model", ev.from_model),
                            ("to_model", ev.to_model)):
                if not isinstance(v, str) or not v:
                    raise ValueError(
                        f"shift_traffic {name} must be a non-empty "
                        f"model name, got {v!r}")
            if ev.from_model == ev.to_model:
                raise ValueError(
                    f"shift_traffic moves share from {ev.from_model!r} "
                    f"to itself")
            if (not _is_num(ev.share) or not math.isfinite(ev.share)
                    or not 0.0 < ev.share <= 1.0):
                raise ValueError(
                    f"shift_traffic share must be in (0, 1] (normalized "
                    f"rate-share points), got {ev.share!r}")
        elif isinstance(ev, ReloadParams):
            if ev.seed is not None and not _is_int(ev.seed):
                raise ValueError(
                    f"reload_params seed must be an integer, "
                    f"got {ev.seed!r}")
        elif isinstance(ev, DegradeMN):
            if (not _is_num(ev.factor) or not math.isfinite(ev.factor)
                    or ev.factor < 1.0):
                raise ValueError(
                    f"degrade_mn factor must be a finite number >= 1.0 "
                    f"(1.0 restores nominal speed), got {ev.factor!r}")
    # bounds pass in fire order: the maximum pool a fail/recover/degrade
    # id may reference is the largest m_mn provisioned AT OR BEFORE its
    # fire time — a grow scheduled after the event cannot justify it
    # (the event would silently no-op against the not-yet-grown pool)
    max_m = int(m_mn)
    for ev in sort_events(events):
        if isinstance(ev, Resize) and ev.m_mn is not None:
            max_m = max(max_m, int(ev.m_mn))
        elif isinstance(ev, (FailMN, RecoverMN, DegradeMN)):
            if not _is_int(ev.mn) or not 0 <= ev.mn < max_m:
                raise ValueError(
                    f"{ev.kind} event targets MN {ev.mn!r} outside the "
                    f"schedule-aware maximum pool of {max_m} at its "
                    f"fire time")


# ------------------------------------------------------------- the spec
@dataclass(frozen=True)
class ModelRef:
    """One DLRM the scenario serves (used when ``run_scenario`` is not
    handed a pre-built model).  Under a fleet spec (several ModelRefs),
    ``rate_share`` is the model's relative slice of the aggregate
    arrival rate (normalized across the fleet) and ``sla_p99_s`` an
    optional per-model SLA target overriding the spec-level one."""
    arch: str = "rm1"
    reduced: bool = True
    init_seed: int = 0
    rate_share: float = 1.0
    sla_p99_s: Optional[float] = None


@dataclass(frozen=True)
class Topology:
    """Cluster shape: the ``ClusterConfig`` fields that describe
    provisioning (the stream seed lives in :class:`Workload`)."""
    n_cn: int = 2
    m_mn: int = 4
    batch_size: int = 32
    max_wait_s: float = 0.002
    n_replicas: int = 2
    use_kernel: bool = True
    cn_type: str = "cn_1g"
    mn_type: str = "ddr_mn"
    mn_types: Optional[Tuple[str, ...]] = None
    cache_mb: float = 0.0
    cache_policy: str = "lru"
    # max batches concurrently inside the MN stage (1 = sequential
    # clock, bitwise-identical to the pre-pipeline model)
    inflight_depth: int = 1
    # batch -> CN placement policy (ClusterConfig.cn_router): cpu_free
    # (legacy, bitwise parity) | pipeline_free | least_outstanding
    cn_router: str = "cpu_free"
    # hedged re-issue of straggling MN scans: a scan whose projected
    # duration exceeds hedge_multiplier x its nominal (degradation-free)
    # duration is re-issued on the fastest live replica at the detection
    # instant — both issues are charged, the first finisher wins.
    # 0.0 disables hedging (the parity default).
    hedge_multiplier: float = 0.0
    # stall before a batch struck by a mid-stage MN failure re-issues
    # (ClusterConfig.mn_recovery_s).  None keeps the engine default
    # (failure-model recovery cost); scenarios running on compressed
    # virtual timescales set an on-scale value.
    mn_recovery_s: Optional[float] = None

    def cluster_config(self, seed: int = 0) -> ClusterConfig:
        extra = ({} if self.mn_recovery_s is None
                 else {"mn_recovery_s": self.mn_recovery_s})
        return ClusterConfig(
            n_cn=self.n_cn, m_mn=self.m_mn, batch_size=self.batch_size,
            max_wait_s=self.max_wait_s, n_replicas=self.n_replicas,
            use_kernel=self.use_kernel, cn_type=self.cn_type,
            mn_type=self.mn_type,
            mn_types=(list(self.mn_types) if self.mn_types is not None
                      else None),
            cache_mb=self.cache_mb, cache_policy=self.cache_policy,
            inflight_depth=self.inflight_depth,
            cn_router=self.cn_router,
            hedge_multiplier=self.hedge_multiplier,
            seed=seed, **extra)


@dataclass(frozen=True)
class Workload:
    """The base workload phase: a seeded heavy-tailed request stream
    (``data.queries.dlrm_request_stream`` convention).  ``SetWorkload``
    events override the distribution/rate parameters from their fire
    time onward; the arrival *process* (``arrival``) is stream-wide —
    phases re-shape its rate (``gap_s``), never its kind."""
    requests: int = 32
    mean_size: float = 8.0
    sigma: float = 1.0
    max_size: int = 64
    alpha: float = 0.0
    gap_s: float = 0.002
    seed: int = 0
    # arrival process: linear | poisson | bursty | trace
    # (data.queries.ArrivalProcess).  linear reproduces the historical
    # evenly-spaced stream byte-for-byte; the stochastic processes draw
    # from a separate derived RNG so payloads never move.
    arrival: str = "linear"
    burstiness: float = 4.0       # bursty: burst/lull rate swing factor
    trace_path: Optional[str] = None   # trace: JSON timestamp file


@dataclass(frozen=True)
class ScenarioSpec:
    """One serving scenario: topology + workload phases + event timeline.

    Frozen and serde-round-trippable: ``from_json(spec.to_json()) ==
    spec`` for every event type.

    ``models`` is the served fleet; the singular ``model`` is kept as a
    constructor/serde alias for single-model specs.  ``__post_init__``
    normalizes the two views (``model is models[0]`` always holds), so
    a one-model fleet spec and a legacy single-model spec are the same
    value and run the same bitwise-identical code path.
    """
    name: str
    description: str = ""
    model: Optional[ModelRef] = None
    models: Tuple[ModelRef, ...] = ()
    topology: Topology = Topology()
    workload: Workload = Workload()
    events: Tuple[ScenarioEvent, ...] = ()
    # SLA target on measured p99 latency (seconds).  When set,
    # run_scenario attaches a feedback SLAController
    # (serving.autoscaler) that watches a sliding window of completion
    # latencies and emits Resize events through the live timeline.
    # None (the default) keeps serving schedule-driven.
    sla_p99_s: Optional[float] = None
    # SLA controller scaling split (SLAControllerConfig.mode): coupled
    # (default — a breach steps both pools in lockstep) | decoupled
    # (binding-pool attribution via per-node queueing pressure emits
    # partial per-pool Resize events).  Only meaningful with sla_p99_s.
    sla_mode: str = "coupled"

    def __post_init__(self):
        models = tuple(self.models)
        if self.model is not None and models:
            if self.model != models[0]:
                if len(models) > 1:
                    raise ValueError(
                        "give either model (single-model alias) or "
                        "models (fleet), not conflicting values of both")
                models = (self.model,)     # dataclasses.replace override
        elif not models:
            models = (self.model if self.model is not None else ModelRef(),)
        object.__setattr__(self, "models", models)
        object.__setattr__(self, "model", models[0])

    # ---------------------------------------------------------- serde
    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "description": self.description,
            "models": [_model_ref_dict(m) for m in self.models],
            "topology": {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in dataclasses.asdict(
                             self.topology).items()},
            "workload": dataclasses.asdict(self.workload),
            "events": [e.to_dict() for e in self.events],
        }
        if self.sla_p99_s is not None:
            d["sla_p99_s"] = self.sla_p99_s
        if self.sla_mode != "coupled":
            d["sla_mode"] = self.sla_mode
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        d = dict(d)
        if "name" not in d:
            raise ValueError("scenario spec needs a name")
        known = {"name", "description", "model", "models", "topology",
                 "workload", "events", "sla_p99_s", "sla_mode"}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown scenario section(s): {', '.join(unknown)}")
        if "model" in d and "models" in d:
            raise ValueError("give either 'model' (single-model alias) "
                             "or 'models' (fleet), not both")
        models: Tuple[ModelRef, ...] = ()
        model = None
        if "models" in d:
            lst = d["models"]
            if not isinstance(lst, list) or not lst:
                raise ValueError("models must be a non-empty list of "
                                 "model refs")
            models = tuple(_build(ModelRef, m or {}, "models") for m in lst)
        elif "model" in d:
            model = _build(ModelRef, d["model"] or {}, "model")
        topo = dict(d.get("topology") or {})
        if topo.get("mn_types") is not None:
            topo["mn_types"] = tuple(topo["mn_types"])
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            model=model,
            models=models,
            topology=_build(Topology, topo, "topology"),
            workload=_build(Workload, d.get("workload") or {}, "workload"),
            events=tuple(event_from_dict(e) for e in d.get("events") or ()),
            sla_p99_s=d.get("sla_p99_s"),
            sla_mode=d.get("sla_mode", "coupled"),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # ----------------------------------------------------- validation
    def validate(self) -> None:
        t, w = self.topology, self.workload
        for section, name, v in (("topology", "n_cn", t.n_cn),
                                 ("topology", "m_mn", t.m_mn),
                                 ("topology", "batch_size", t.batch_size),
                                 ("topology", "n_replicas", t.n_replicas),
                                 ("topology", "inflight_depth",
                                  t.inflight_depth),
                                 ("workload", "requests", w.requests),
                                 ("workload", "max_size", w.max_size),
                                 ("workload", "seed", w.seed)):
            if not _is_int(v):
                raise ValueError(
                    f"{section} {name} must be an integer, got {v!r}")
        for section, name, v in (("topology", "max_wait_s", t.max_wait_s),
                                 ("topology", "cache_mb", t.cache_mb),
                                 ("topology", "hedge_multiplier",
                                  t.hedge_multiplier),
                                 ("workload", "mean_size", w.mean_size),
                                 ("workload", "sigma", w.sigma),
                                 ("workload", "alpha", w.alpha),
                                 ("workload", "burstiness", w.burstiness),
                                 ("workload", "gap_s", w.gap_s)):
            if not _is_num(v):
                raise ValueError(
                    f"{section} {name} must be a number, got {v!r}")
        if t.n_cn < 1 or t.m_mn < 1:
            raise ValueError(f"topology {{n_cn={t.n_cn}, m_mn={t.m_mn}}} "
                             f"must provision both pools")
        if t.batch_size < 1:
            raise ValueError("topology batch_size must be >= 1")
        if t.n_replicas < 1:
            raise ValueError("topology n_replicas must be >= 1")
        if t.inflight_depth < 1:
            raise ValueError("topology inflight_depth must be >= 1")
        if t.cache_policy not in ("lru", "lfu"):
            raise ValueError(f"unknown cache policy {t.cache_policy!r}")
        if t.cn_router not in CN_ROUTERS:
            raise ValueError(f"unknown cn_router {t.cn_router!r} "
                             f"(known: {CN_ROUTERS})")
        if t.cache_mb < 0:
            raise ValueError("topology cache_mb must be >= 0")
        if t.cn_type not in NODE_TYPES or NODE_TYPES[t.cn_type].kind != "cn":
            raise ValueError(f"unknown compute-node type {t.cn_type!r}")
        if (t.mn_type not in NODE_TYPES
                or NODE_TYPES[t.mn_type].kind != "mn"):
            raise ValueError(f"unknown memory-node type {t.mn_type!r}")
        if t.mn_types is not None:
            _validate_mn_types(t.mn_types, t.m_mn)
        if t.hedge_multiplier < 0:
            raise ValueError("topology hedge_multiplier must be >= 0 "
                             "(0 disables hedged re-issue)")
        if t.mn_recovery_s is not None and (
                not _is_num(t.mn_recovery_s) or t.mn_recovery_s < 0):
            raise ValueError(f"topology mn_recovery_s must be a "
                             f"non-negative number when set, got "
                             f"{t.mn_recovery_s!r}")
        if w.requests < 0:
            raise ValueError("workload requests must be >= 0")
        if w.mean_size <= 0 or w.max_size < 1:
            raise ValueError("workload query sizes must be positive")
        if w.sigma < 0 or w.alpha < 0 or w.gap_s < 0:
            raise ValueError("workload sigma/alpha/gap_s must be >= 0")
        if w.arrival not in ARRIVALS:
            raise ValueError(f"unknown workload arrival process "
                             f"{w.arrival!r} (known: {ARRIVALS})")
        if w.burstiness < 1.0:
            raise ValueError("workload burstiness must be >= 1.0")
        if (w.arrival == "trace") != (w.trace_path is not None):
            raise ValueError(
                "workload trace_path must be set exactly when "
                "arrival='trace' (a path on another process is a "
                "config bug, not a silent no-op)")
        if w.trace_path is not None and not isinstance(w.trace_path, str):
            raise ValueError("workload trace_path must be a string path")
        if self.sla_p99_s is not None and (
                not _is_num(self.sla_p99_s) or self.sla_p99_s <= 0):
            raise ValueError(f"sla_p99_s must be a positive number, "
                             f"got {self.sla_p99_s!r}")
        if self.sla_mode not in ("coupled", "decoupled"):
            raise ValueError(f"unknown sla_mode {self.sla_mode!r} "
                             f"(known: coupled, decoupled)")
        for m in self.models:
            if not isinstance(m.arch, str) or not m.arch:
                raise ValueError(f"model arch must be a non-empty "
                                 f"string, got {m.arch!r}")
            if not isinstance(m.reduced, bool):
                raise ValueError(f"model reduced must be a bool, "
                                 f"got {m.reduced!r}")
            if not _is_int(m.init_seed):
                raise ValueError(f"model init_seed must be an integer, "
                                 f"got {m.init_seed!r}")
            if (not _is_num(m.rate_share) or not math.isfinite(m.rate_share)
                    or m.rate_share <= 0):
                raise ValueError(
                    f"model {m.arch!r} rate_share must be a positive "
                    f"number, got {m.rate_share!r}")
            if m.sla_p99_s is not None and (not _is_num(m.sla_p99_s)
                                            or m.sla_p99_s <= 0):
                raise ValueError(
                    f"model {m.arch!r} sla_p99_s must be a positive "
                    f"number when set, got {m.sla_p99_s!r}")
        names = [m.arch for m in self.models]
        if len(set(names)) != len(names):
            raise ValueError(
                f"fleet models must have distinct arch names, got {names}")
        fleet = len(self.models) > 1
        if fleet and w.arrival == "trace":
            raise ValueError(
                "fleet specs derive one arrival process per model; a "
                "shared timestamp trace cannot be split by rate share "
                "(use linear/poisson/bursty)")
        for ev in self.events:
            if isinstance(ev, SetWorkload) and ev.model is not None:
                if ev.model not in names:
                    raise ValueError(
                        f"set_workload targets unknown model "
                        f"{ev.model!r} (fleet: {names})")
                if ev.gap_s is not None:
                    raise ValueError(
                        "a model-scoped set_workload may not set gap_s "
                        "— move per-model rate with shift_traffic")
            elif isinstance(ev, ShiftTraffic):
                if not fleet:
                    raise ValueError(
                        "shift_traffic needs a multi-model fleet spec")
                for nm in (ev.from_model, ev.to_model):
                    if nm not in names:
                        raise ValueError(
                            f"shift_traffic targets unknown model "
                            f"{nm!r} (fleet: {names})")
        if fleet:
            # simulate the shift chain: no model's share may go negative
            total = sum(m.rate_share for m in self.models)
            shares = {m.arch: m.rate_share / total for m in self.models}
            for ev in sort_events([e for e in self.events
                                   if isinstance(e, ShiftTraffic)]):
                shares[ev.from_model] -= ev.share
                shares[ev.to_model] += ev.share
                if shares[ev.from_model] < -1e-12:
                    raise ValueError(
                        f"shift_traffic @{ev.time_s:g}s moves "
                        f"{ev.share:g} share from {ev.from_model!r}, "
                        f"which only holds "
                        f"{shares[ev.from_model] + ev.share:g} there")
        validate_events(self.events, t.m_mn)


def _model_ref_dict(m: ModelRef) -> Dict[str, Any]:
    """Serde form of one fleet member: single-model defaults
    (rate_share 1.0, no per-model SLA) stay out of the JSON so legacy
    single-model files keep their historical shape."""
    d: Dict[str, Any] = {"arch": m.arch, "reduced": m.reduced,
                         "init_seed": m.init_seed}
    if m.rate_share != 1.0:
        d["rate_share"] = m.rate_share
    if m.sla_p99_s is not None:
        d["sla_p99_s"] = m.sla_p99_s
    return d


def _build(cls, d: Dict[str, Any], section: str):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown {section} field(s): {', '.join(unknown)}")
    return cls(**d)


# --------------------------------------------------- workload planning
@dataclass
class PhasePlan:
    """One resolved workload phase: the distribution in force over a
    contiguous rid range of the generated stream."""
    index: int
    t_start: float
    mean_size: float
    sigma: float
    max_size: int
    alpha: float
    gap_s: float
    rid_start: int = 0
    rid_end: int = 0

    @property
    def requests(self) -> int:
        return self.rid_end - self.rid_start


def plan_workload(spec: ScenarioSpec, model_cfg
                  ) -> Tuple[List[Request], List[PhasePlan]]:
    """Build the scenario's request stream, honoring ``SetWorkload``
    phase changes.

    Arrivals come from the workload's :class:`~repro_torch.data.queries.
    ArrivalProcess` (``linear`` | ``poisson`` | ``bursty`` | ``trace``),
    realigned to each phase's declared start: when a ``SetWorkload``
    fires at ``time_s``, the process restarts from exactly ``time_s``
    under the new ``gap_s`` — for ``linear`` the first post-event
    arrival lands *on* the phase start and subsequent arrivals are
    spaced at the new gap.  (Historical bug, fixed here: the old
    planner re-based on the stale-gap-extrapolated candidate arrival
    instead of the event's ``time_s``, so every later arrival drifted
    by the extrapolation overshoot and the first post-event arrival
    still used the old phase's gap.  No bitwise-compat shim is needed:
    the legacy-parity grid never crosses a phase boundary, and
    single-phase streams are unaffected.)  A request's phase is the one
    whose ``SetWorkload`` fired at or before its arrival.

    One ``np.random.RandomState(workload.seed)`` drives sizes and
    payloads, with sizes sampled per phase chunk, and the arrival
    process draws from a *separate* derived RNG — a single-phase
    ``linear`` scenario therefore reproduces
    ``data.queries.dlrm_request_stream(cfg, n, seed, dist, gap_s)``
    byte-for-byte (payloads AND timestamps), which is what keeps
    legacy-kwarg runs bitwise-equal to their spec equivalents; the
    stochastic processes move only the timestamps.
    """
    w = spec.workload
    sw = sort_events([e for e in spec.events if isinstance(e, SetWorkload)])
    cur = {"mean_size": w.mean_size, "sigma": w.sigma,
           "max_size": w.max_size, "alpha": w.alpha, "gap_s": w.gap_s}
    phases = [PhasePlan(index=0, t_start=0.0, **cur)]
    arrivals: List[float] = []
    pids: List[int] = []
    proc = ArrivalProcess(
        w.arrival, w.gap_s, seed=w.seed, burstiness=w.burstiness,
        trace=(load_trace(w.trace_path) if w.arrival == "trace" else None))
    k = 0
    for i in range(w.requests):
        t = proc.next()
        # a phase change at or before the candidate arrival realigns the
        # process to the event's declared start — the candidate was
        # generated under the stale phase and is discarded
        while k < len(sw) and sw[k].time_s <= t:
            ev = sw[k]
            k += 1
            for name in ("mean_size", "sigma", "max_size", "alpha",
                         "gap_s"):
                v = getattr(ev, name)
                if v is not None:
                    cur[name] = v
            proc.realign(ev.time_s, cur["gap_s"])
            phases.append(PhasePlan(index=len(phases), t_start=ev.time_s,
                                    rid_start=i, rid_end=i, **cur))
            t = proc.next()
        arrivals.append(t)
        pids.append(len(phases) - 1)

    rng = np.random.RandomState(w.seed)
    reqs: List[Request] = []
    i = 0
    n = w.requests
    while i < n:
        j = i
        while j < n and pids[j] == pids[i]:
            j += 1
        ph = phases[pids[i]]
        qd = QueryDist(mean_size=ph.mean_size, sigma=ph.sigma,
                       max_size=ph.max_size, alpha=ph.alpha)
        sizes = qd.sample(rng, j - i)
        for s, a in zip(sizes, arrivals[i:j]):
            b = dlrm_batch(model_cfg, int(s), rng, alpha=ph.alpha)
            reqs.append(Request(len(reqs),
                                {"dense": b["dense"],
                                 "indices": b["indices"]},
                                int(s), a))
        ph.rid_end = j
        i = j
    return reqs, phases


# --------------------------------------------------------- the report
@dataclass
class PhaseStats:
    """Per-workload-phase serving stats (latencies over the phase's
    contiguous rid range)."""
    index: int
    t_start: float
    alpha: float
    gap_s: float
    mean_size: float
    requests: int
    completed: int
    mean_latency: float
    p50: float
    p95: float
    p99: float


@dataclass
class ScenarioReport:
    """Structured result of :func:`run_scenario`: cluster-wide stats,
    per-phase stats, and the dispatcher's per-event audit trail
    (``stats.events``: event, fire time, resulting pool shape)."""
    name: str
    completed: int
    total: int
    final_n_cn: int
    final_m_mn: int
    mn_types: Tuple[str, ...]
    stats: ClusterStats
    phases: List[PhaseStats]
    latency_model: Dict[str, float]
    results: List[Result] = field(repr=False, default_factory=list)
    engine: Any = field(repr=False, compare=False, default=None)

    def bitwise_equal(self, other: "ScenarioReport") -> bool:
        """Score parity between two runs of the same workload: both
        complete, and every query's outputs bitwise-identical.  The
        single comparison the benches and examples assert when claiming
        an event timeline never changes values."""
        if not (self.completed == self.total
                and other.completed == other.total
                and self.total == other.total):
            return False
        want = {r.rid: r.outputs for r in other.results}
        return all(r.rid in want and np.array_equal(r.outputs, want[r.rid])
                   for r in self.results)

    def to_dict(self) -> Dict[str, Any]:
        st = dataclasses.asdict(self.stats)
        st.pop("events")
        # keep each event's type discriminator (dataclasses.asdict drops
        # the ClassVar `kind`, leaving a FailMN and a RecoverMN on the
        # same MN indistinguishable)
        events = [{"event": r.event.to_dict(), "time_s": r.time_s,
                   "n_cn": r.n_cn, "m_mn": r.m_mn, "dead": list(r.dead),
                   "applied": r.applied} for r in self.stats.events]
        return {
            "name": self.name,
            "completed": self.completed,
            "total": self.total,
            "final_pool": {"n_cn": self.final_n_cn,
                           "m_mn": self.final_m_mn,
                           "mn_types": list(self.mn_types)},
            "phases": [dataclasses.asdict(p) for p in self.phases],
            "events": events,
            "stats": st,
            "latency_model": dict(self.latency_model),
        }

    def summary(self) -> List[str]:
        st = self.stats
        lines = [
            f"[scenario] {self.name}: {self.completed}/{self.total} "
            f"queries completed; final pool {{{self.final_n_cn} CN, "
            f"{self.final_m_mn} MN [{','.join(self.mn_types)}]}}",
            f"[scenario] p50 {st.p50 * 1e3:.3f}ms "
            f"p95 {st.p95 * 1e3:.3f}ms p99 {st.p99 * 1e3:.3f}ms  "
            f"MN imbalance {st.imbalance:.3f}  "
            f"failures={st.failures} recoveries={st.recoveries} "
            f"resizes={st.resizes} reroutes={st.reroutes} "
            f"reinits={st.reinits} reissues={st.reissues}",
            f"[scenario] queueing delay (arrival -> admission): "
            f"mean {st.queue_wait_mean * 1e3:.3f}ms "
            f"p99 {st.queue_wait_p99 * 1e3:.3f}ms",
        ]
        if len(st.per_model) > 1:
            for name, ms in st.per_model.items():
                lines.append(
                    f"[scenario] model {name}: {ms.completed}/"
                    f"{ms.queries} completed, p99 {ms.p99 * 1e3:.3f}ms, "
                    f"queue-wait p99 {ms.queue_wait_p99 * 1e3:.3f}ms, "
                    f"{ms.cache_hits} cache hits "
                    f"({ms.cache_bytes_saved / 1e6:.2f}MB saved), "
                    f"{ms.sla_actions} SLA action(s)")
        if st.hedges or st.degrades:
            lines.append(
                f"[scenario] straggler mitigation: {st.degrades} "
                f"degrade events, {st.hedges} hedged scans "
                f"({st.hedge_wins} won by the hedge)")
        if st.sla_actions:
            lines.append(
                f"[scenario] SLA feedback: controller emitted "
                f"{st.sla_actions} resize action(s) "
                f"({st.sla_actions_cn} CN-dim, {st.sla_actions_mn} "
                f"MN-dim)")
        if not st.sla_window_filled:
            lines.append(
                "[scenario] SLA feedback: warning — the p99 window "
                "never filled (run shorter than the controller window; "
                "no action could fire)")
        mem = sum(st.mn_access_bytes) + st.retired_access_bytes
        gat = sum(st.mn_gather_bytes) + st.retired_gather_bytes
        if any("nmp" in t for t in self.mn_types) and mem:
            lines.append(
                f"[scenario] NMP near-memory pooling: scanned "
                f"{mem / 1e6:.2f}MB on-node, shipped {gat / 1e6:.2f}MB "
                f"over the fabric ({100 * (1 - gat / mem):.1f}% gather "
                f"bytes saved vs raw rows)")
        for ph in self.phases:
            lines.append(
                f"[scenario] phase {ph.index} @{ph.t_start * 1e3:.0f}ms "
                f"(alpha={ph.alpha:g}, gap={ph.gap_s * 1e3:g}ms, "
                f"mean_size={ph.mean_size:g}): "
                f"{ph.completed}/{ph.requests} completed, "
                f"p95 {ph.p95 * 1e3:.3f}ms")
        for rec in st.events:
            ev = rec.event
            extra = {k: v for k, v in ev.to_dict().items()
                     if k not in ("type", "time_s")}
            note = "" if rec.applied else " (no-op)"
            lines.append(
                f"[scenario] event @{rec.time_s * 1e3:.1f}ms "
                f"{ev.kind}{extra or ''}{note} -> pool "
                f"{{{rec.n_cn} CN, {rec.m_mn} MN}}, dead={list(rec.dead)}")
        if st.cache_hits + st.cache_misses:
            hr = st.cache_hits / (st.cache_hits + st.cache_misses)
            lines.append(
                f"[scenario] hot-row cache: {100 * hr:.1f}% hit rate, "
                f"{st.cache_bytes_saved / 1e6:.2f}MB gather bytes saved, "
                f"{st.cache_invalidations} coherence invalidations")
        if st.migration_bytes:
            lines.append(
                f"[scenario] shard migration: "
                f"{st.migration_bytes / 1e6:.3f}MB drained/topped-up "
                f"across {st.resizes} resizes")
        v = self.latency_model
        lines.append(
            f"[scenario] latency model cross-check: engine/analytic = "
            f"{v['ratio']:.2f} (MN stage {v['mn_stage_ratio']:.2f})")
        return lines


def nearest_rank(values, q: float) -> float:
    """Documented nearest-rank percentile: the ``ceil(q/100 * n)``-th
    smallest observation (1-indexed) — always an *actual* sample.

    ``np.percentile``'s default linear interpolation made p95/p99
    depend on the sample count in surprising ways at smoke scale (a
    32-sample p99 was an invented point 99% of the way between the two
    largest observations); nearest-rank is the standard tail-SLA
    convention (a measured latency some query actually saw) and is what
    every serving-layer percentile in this repo now means.  Empty input
    returns nan, matching the ``mean_latency`` contract."""
    a = np.sort(np.asarray(values, dtype=float))
    n = a.size
    if n == 0:
        return float("nan")
    k = max(int(math.ceil(q / 100.0 * n)), 1) - 1
    return float(a[min(k, n - 1)])


def _lat_stats(lats: List[float]) -> Tuple[float, float, float, float]:
    if not lats:
        nan = float("nan")
        return nan, nan, nan, nan
    a = np.sort(np.asarray(lats, dtype=float))
    return (float(a.mean()), nearest_rank(a, 50),
            nearest_rank(a, 95), nearest_rank(a, 99))


def run_scenario(spec: ScenarioSpec, model=None, params=None, stream=None,
                 device: DeviceLike = None) -> ScenarioReport:
    """The serving stack's single front door: validate the spec, build
    the model (unless one is handed in), plan the phased request stream,
    serve it through ``ClusterEngine`` with the spec's event timeline,
    and fold the outcome into a :class:`ScenarioReport`.

    ``stream`` is an optional pre-planned ``(requests, phases)`` pair
    from :func:`plan_workload`, so a caller serving the *same* workload
    under several topologies builds the seeded stream once.  The caller
    owns the invariant that it was planned from an identical workload +
    ``SetWorkload`` timeline.

    ``device`` is where the engine runs (default: the CUDA card; see
    ``repro_torch.device``); handed-in ``params`` must lie there.

    Fleet specs (more than one entry in ``spec.models``) are delegated
    to :func:`repro_torch.serving.fleet.run_fleet`; a one-model fleet IS
    a single-model spec (``__post_init__`` normalization) and takes this
    path unchanged."""
    spec.validate()
    if len(spec.models) > 1:
        if model is not None or params is not None or stream is not None:
            raise ValueError(
                "fleet specs build their own models and streams; the "
                "model/params/stream caching hooks are single-model only")
        from repro_torch.serving.fleet import run_fleet
        return run_fleet(spec, device=device)
    dev = resolve_device(device)
    if model is None:
        cfg = (configs.get_reduced(spec.model.arch) if spec.model.reduced
               else configs.get_config(spec.model.arch))
        model = DLRMModel(cfg)
    if params is None:
        params = model.init(spec.model.init_seed, device=dev)
    reqs, phases = (plan_workload(spec, model.cfg) if stream is None
                    else stream)
    engine = ClusterEngine(
        model, params, spec.topology.cluster_config(seed=spec.workload.seed),
        device=dev)
    controller = None
    if spec.sla_p99_s is not None:
        from repro_torch.serving.autoscaler import (SLAController,
                                                    SLAControllerConfig)
        controller = SLAController(
            SLAControllerConfig(sla_p99_s=spec.sla_p99_s,
                                mode=spec.sla_mode),
            n_cn=spec.topology.n_cn, m_mn=spec.topology.m_mn)
    results, stats = engine.serve(reqs, events=spec.events,
                                  controller=controller)
    by_rid = {r.rid: r for r in results}
    phase_stats = []
    for ph in phases:
        lats = [by_rid[r].latency for r in range(ph.rid_start, ph.rid_end)
                if r in by_rid]
        mean, p50, p95, p99 = _lat_stats(lats)
        phase_stats.append(PhaseStats(
            index=ph.index, t_start=ph.t_start, alpha=ph.alpha,
            gap_s=ph.gap_s, mean_size=ph.mean_size, requests=ph.requests,
            completed=len(lats), mean_latency=mean, p50=p50, p95=p95,
            p99=p99))
    return ScenarioReport(
        name=spec.name, completed=stats.completed, total=len(reqs),
        final_n_cn=engine.n_cn, final_m_mn=engine.m_mn,
        mn_types=tuple(engine.mn_types), stats=stats, phases=phase_stats,
        latency_model=engine.validate_latency_model(), results=results,
        engine=engine)


# ------------------------------------------------------------- presets
def smoke_topology(**overrides) -> Topology:
    """The canonical smoke cluster every bench/example topology derives
    from: :class:`Topology`'s defaults ARE the smoke shape ({2 CN,
    4 MN, batch 32, 2x replicas} — one source of truth), and this
    helper names the intent at the 7+ call sites that used to
    hand-roll ``ClusterConfig(...)`` across ``benchmarks/`` and
    ``examples/``."""
    return Topology(**overrides)


def _preset_failover_storm() -> ScenarioSpec:
    return ScenarioSpec(
        name="failover_storm",
        description=(
            "Two failure/recovery cycles sweep the MN pool mid-stream: "
            "each death re-routes to surviving replicas (fast path), each "
            "timed recovery rebuilds routing over the healed pool — "
            "scores stay bitwise-identical to a failure-free run "
            "(paper §IV-A/§IV-D, Fig. 9)."),
        topology=smoke_topology(),
        workload=Workload(requests=32, seed=1),
        events=(
            FailMN(0.012, mn=1),
            RecoverMN(0.024, mn=1),
            FailMN(0.036, mn=3),
            RecoverMN(0.048, mn=3),
        ),
    )


def _preset_diurnal_elastic() -> ScenarioSpec:
    from repro_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
    span = 32 * 0.002
    toy = Autoscaler(AutoscalerConfig(
        qps_per_cn=1.0, qps_per_mn=0.5, min_cn=1, min_mn=2,
        max_cn=3, max_mn=6))
    events = tuple(Resize(e.time_s, n_cn=e.n_cn, m_mn=e.m_mn)
                   for e in toy.plan(peak_load=3.0, duration_s=span,
                                     steps=8))
    return ScenarioSpec(
        name="diurnal_elastic",
        description=(
            "One diurnal day mapped onto the stream: both pools follow "
            "the load curve down to the trough and back via timed "
            "resizes, shard migration draining to survivors — scores "
            "bitwise-identical to the fixed {3 CN, 6 MN} peak pool "
            "(paper §III, Fig. 2b/11)."),
        topology=smoke_topology(n_cn=3, m_mn=6),
        workload=Workload(requests=32, seed=0),
        events=events,
    )


def _preset_skew_drift() -> ScenarioSpec:
    return ScenarioSpec(
        name="skew_drift",
        description=(
            "Row-popularity skew drifts across the stream — uniform, "
            "then Zipf alpha=1.05, then 1.2 — while a small per-CN "
            "hot-row cache adapts and a final replan re-places tables "
            "from measured hotness (Gupta et al. skew; FlexEMR-style "
            "caching).  No legacy kwarg can express this."),
        topology=smoke_topology(cache_mb=0.05),
        workload=Workload(requests=36, seed=7),
        events=(
            SetWorkload(0.024, alpha=1.05),
            SetWorkload(0.048, alpha=1.2, gap_s=0.001),
            ReplanPlacement(0.06),
        ),
    )


def _preset_mixed_ddr_nmp() -> ScenarioSpec:
    return ScenarioSpec(
        name="mixed_ddr_nmp",
        description=(
            "Heterogeneous memory pool (2 DDR + 2 NMP): a DDR node dies "
            "and its tables ride their NMP replicas, it recovers, and "
            "the pool then grows with two more NMP nodes — bitwise-"
            "identical scores throughout, strictly fewer gather bytes "
            "than all-DDR (paper §NMP, Fig. 14)."),
        topology=smoke_topology(
            mn_types=("ddr_mn", "ddr_mn", "nmp_mn", "nmp_mn")),
        workload=Workload(requests=32, seed=3),
        events=(
            FailMN(0.016, mn=0),
            RecoverMN(0.032, mn=0),
            Resize(0.048, m_mn=6, mn_type="nmp_mn"),
        ),
    )


def _preset_pipeline_burst() -> ScenarioSpec:
    return ScenarioSpec(
        name="pipeline_burst",
        description=(
            "A backlogged burst (every request at t=0) served with four "
            "batches in flight: MN scans of batch k+1 hide behind the "
            "gather/dense of batch k, so throughput tracks the "
            "bottleneck resource instead of the stage sum (DisaggRec "
            "§IV; FlexEMR overlapped gets).  Scores are bitwise-"
            "identical to the same spec at inflight_depth=1 — only the "
            "clock changes, never the math."),
        topology=smoke_topology(inflight_depth=4, max_wait_s=2e-5),
        workload=Workload(requests=64, gap_s=0.0, seed=5),
    )


def _preset_flash_crowd() -> ScenarioSpec:
    return ScenarioSpec(
        name="flash_crowd",
        description=(
            "Poisson traffic spikes 10x mid-stream and recedes: queueing "
            "delay (arrival -> admission) piles into the tail while the "
            "SLA feedback controller watches the measured p99 against "
            "sla_p99_s and emits Resize scale-ups through the live "
            "timeline, then the pool returns to steady state (Gupta et "
            "al. bursty production traffic; paper Fig. 2b).  Runs on a "
            "compressed virtual timescale (per-batch service is ~7us at "
            "smoke scale): the pool starts at its {1 CN, 2 MN} floor, "
            "the crowd overloads it ~3x, and the controller rides "
            "measured p99 up to 4x capacity and back down to the floor."),
        topology=smoke_topology(n_cn=1, m_mn=2, inflight_depth=4,
                                max_wait_s=2e-5),
        workload=Workload(requests=960, gap_s=4e-6, arrival="poisson",
                          seed=11),
        sla_p99_s=6e-5,
        events=(
            SetWorkload(1e-4, gap_s=7e-7),
            SetWorkload(5e-4, gap_s=4e-6),
        ),
    )


def _preset_spike_plus_failure() -> ScenarioSpec:
    return ScenarioSpec(
        name="spike_plus_failure",
        description=(
            "Bursty arrivals, then a traffic spike with an MN failure "
            "landing mid-spike: re-route rides the surviving replicas "
            "while the SLA controller scales the pool against the "
            "compound tail, the MN heals, and traffic recedes — the "
            "paper's reliability story under its worst-case load "
            "(§IV-A/§IV-D + Fig. 2b, via the typed timeline).  Same "
            "compressed virtual timescale as flash_crowd, with an "
            "on-scale mn_recovery_s so the mid-stage re-issue stall "
            "stays commensurate with the traffic."),
        topology=smoke_topology(n_cn=1, m_mn=2, inflight_depth=4,
                                max_wait_s=2e-5, mn_recovery_s=2e-5),
        workload=Workload(requests=1024, gap_s=2e-6, arrival="bursty",
                          burstiness=4.0, seed=13),
        sla_p99_s=6e-5,
        events=(
            SetWorkload(1e-4, gap_s=3.5e-7),
            FailMN(1.5e-4, mn=1),
            RecoverMN(2.5e-4, mn=1),
            SetWorkload(4e-4, gap_s=2e-6),
        ),
    )


def _preset_fleet_shift() -> ScenarioSpec:
    return ScenarioSpec(
        name="fleet_shift",
        description=(
            "RM1 and RM2 share one disaggregated pool: each model keeps "
            "its own ingress batcher and SLA accounting while their "
            "embedding tables are co-placed on the single MN pool "
            "(per-model hotness attribution, per-model cache budget "
            "partitions).  Mid-stream a shift_traffic event moves 30% "
            "of the aggregate rate from RM1 to RM2 — the paper's "
            "fast-evolving-workloads story (Fig. 1/14 fleet view) as a "
            "timeline event; a model-scoped set_workload then skews "
            "RM2's rows without touching RM1's stream."),
        models=(ModelRef(arch="rm1", rate_share=0.5),
                ModelRef(arch="rm2", rate_share=0.5)),
        topology=smoke_topology(cache_mb=0.05),
        workload=Workload(requests=48, seed=9),
        events=(
            ShiftTraffic(0.032, from_model="rm1", to_model="rm2",
                         share=0.3),
            SetWorkload(0.056, alpha=1.05, model="rm2"),
        ),
    )


PRESETS = {
    "failover_storm": _preset_failover_storm,
    "diurnal_elastic": _preset_diurnal_elastic,
    "skew_drift": _preset_skew_drift,
    "mixed_ddr_nmp": _preset_mixed_ddr_nmp,
    "pipeline_burst": _preset_pipeline_burst,
    "flash_crowd": _preset_flash_crowd,
    "spike_plus_failure": _preset_spike_plus_failure,
    "fleet_shift": _preset_fleet_shift,
}


def preset(name: str) -> ScenarioSpec:
    """Build a named scenario preset (the source of truth behind
    ``examples/scenarios/<name>.json``)."""
    if name not in PRESETS:
        raise KeyError(f"unknown scenario preset {name!r} "
                       f"(known: {sorted(PRESETS)})")
    return PRESETS[name]()


# ----------------------------------------------------------- lint CLI
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Lint (and optionally run) scenario spec files.")
    p.add_argument("paths", nargs="*", help="scenario .json files")
    p.add_argument("--run", action="store_true",
                   help="execute each linted scenario via run_scenario")
    p.add_argument("--write-presets", metavar="DIR", default=None,
                   help="re-emit the named preset library into DIR")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="lint report format: text (default; defects "
                        "raise, preserving the historical CLI contract) "
                        "or json (defects become findings in the shared "
                        "lint report schema; exit 1 if any)")
    p.add_argument("--device", default=None,
                   help="torch device --run serves on (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch path)")
    args = p.parse_args(argv)
    if args.write_presets:
        import os
        os.makedirs(args.write_presets, exist_ok=True)
        for name in sorted(PRESETS):
            path = os.path.join(args.write_presets, f"{name}.json")
            preset(name).save(path)
            print(f"[scenario] wrote {path}")
        return 0
    if not args.paths:
        p.error("no scenario files given")
    if args.format == "json":
        # one lint-report schema across the repo: the scenario lint
        # emits the static linter's findings shape, so CI parses one
        # schema regardless of which linter produced it
        if args.run:
            p.error("--format json is lint-only (drop --run)")
        from repro_torch.analysis.report import (Finding, LintResult,
                                                 render_json)
        result = LintResult()
        for path in args.paths:
            result.files_checked += 1
            try:
                spec = ScenarioSpec.load(path)
                spec.validate()
                rt = ScenarioSpec.from_json(spec.to_json())
                if rt != spec:
                    raise AssertionError(
                        "serde round-trip changed the spec")
            except Exception as e:
                result.findings.append(Finding(
                    file=path, line=0, rule="scenario-lint",
                    message=f"{type(e).__name__}: {e}"))
        sys.stdout.write(render_json(result, tool="scenario-lint"))
        return result.exit_code()
    dev = resolve_device(args.device) if args.run else None
    models = {}     # (arch, reduced, init_seed) -> (model, params):
    for path in args.paths:  # presets share one reduced rm1 — build once
        spec = ScenarioSpec.load(path)
        spec.validate()
        rt = ScenarioSpec.from_json(spec.to_json())
        if rt != spec:
            raise AssertionError(f"{path}: serde round-trip changed the spec")
        print(f"[scenario-lint] ok {path}: {spec.name!r} "
              f"({len(spec.events)} events, {spec.workload.requests} "
              f"requests on {{{spec.topology.n_cn} CN, "
              f"{spec.topology.m_mn} MN}})")
        if args.run:
            if len(spec.models) > 1:
                # fleet specs build their own model set (run_fleet);
                # the single-model cache below doesn't apply
                rep = run_scenario(spec, device=dev)
                for line in rep.summary():
                    print(line)
                if rep.completed != rep.total:
                    raise AssertionError(
                        f"{path}: {rep.completed}/{rep.total} completed")
                continue
            key = (spec.model.arch, spec.model.reduced,
                   spec.model.init_seed)
            if key not in models:
                mcfg = (configs.get_reduced(spec.model.arch)
                        if spec.model.reduced
                        else configs.get_config(spec.model.arch))
                model = DLRMModel(mcfg)
                models[key] = (model, model.init(spec.model.init_seed,
                                                 device=dev))
            model, params = models[key]
            rep = run_scenario(spec, model=model, params=params,
                               device=dev)
            for line in rep.summary():
                print(line)
            if rep.completed != rep.total:
                raise AssertionError(
                    f"{path}: {rep.completed}/{rep.total} completed")
    return 0


if __name__ == "__main__":
    # `python -m repro_torch.serving.scenario` executes this file as
    # ``__main__`` while the serving package imports it again under its
    # canonical name — two parallel class hierarchies whose isinstance
    # checks never match.  Delegate to the canonical module so every
    # event the CLI builds is the class the dispatcher tests against.
    from repro_torch.serving.scenario import main as _canonical_main
    sys.exit(_canonical_main())

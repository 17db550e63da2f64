"""Multi-model fleet serving on one shared disaggregated pool.

A *fleet* spec (``ScenarioSpec.models`` with more than one
:class:`~repro_torch.serving.scenario.ModelRef`) serves several DLRMs
concurrently over a single {n CN, m MN} pool instead of one isolated
pool per model.  This module owns the fleet-specific front half:

- :func:`build_fleet` materializes each member (config -> model ->
  seeded params);
- :func:`plan_fleet_workload` builds the merged request stream — one
  seeded :class:`~repro_torch.data.queries.ArrivalProcess` per model, rates
  split by ``ModelRef.rate_share``, re-split mid-run by
  :class:`~repro_torch.serving.scenario.ShiftTraffic` events (aggregate rate
  conserved), with per-model ``SetWorkload`` phases re-shaping only the
  scoped model's query distribution;
- :func:`run_fleet` drives :class:`~repro_torch.serving.cluster.ClusterEngine`
  in fleet mode — model-tagged routing through the shared CN pool,
  owner-scoped placement/hotness on the shared MN pool, per-model cache
  budget partitions — with one ``SLAController`` per model sharing the
  pool (``ModelRef.sla_p99_s`` overriding the spec-level target).

``run_scenario`` delegates here for fleet specs; a one-model fleet
normalizes to the single-model spec in ``ScenarioSpec.__post_init__``
and never reaches this module — that is what pins single-model runs
bitwise-identical to the single-model path.

The port's copy of ``repro.serving.fleet``: the stream planner is the
reference's numpy code unchanged, and ``build_fleet`` / ``run_fleet``
take the ``device`` the members' parameters and the engine live on
(default: the CUDA card; see ``repro_torch.device``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.queries import ArrivalProcess, QueryDist, dlrm_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Request
from repro_torch.serving.scenario import (PhasePlan, PhaseStats,
                                          ScenarioReport, ScenarioSpec,
                                          SetWorkload, ShiftTraffic,
                                          _lat_stats, sort_events)


@dataclass
class FleetModel:
    """One materialized fleet member: the spec's ModelRef resolved to a
    built model and its seeded parameters."""
    name: str
    ref: object                  # the spec's ModelRef
    model: object
    params: object


def build_fleet(spec: ScenarioSpec, device: DeviceLike = None
                ) -> List[FleetModel]:
    """Materialize every ``spec.models`` entry (reduced or full config,
    seeded init on ``device``), in fleet order — member k of the
    returned list is model index k everywhere downstream (requests,
    batches, stats)."""
    from repro_torch import configs
    from repro_torch.models import registry
    dev = resolve_device(device)
    out: List[FleetModel] = []
    for mref in spec.models:
        cfg = (configs.get_reduced(mref.arch) if mref.reduced
               else configs.get_config(mref.arch))
        model = registry.build(cfg)
        out.append(FleetModel(name=mref.arch, ref=mref, model=model,
                              params=model.init(mref.init_seed,
                                                device=dev)))
    return out


def _fleet_seed(seed: int, k: int) -> int:
    """Derived per-model seed: member 0 keeps the workload seed, later
    members decorrelate through a large odd stride (stable across runs,
    never a bitwise contract — fleets have no legacy stream to match)."""
    return (seed + 1000003 * k) % (2 ** 31)


def plan_fleet_workload(spec: ScenarioSpec, fleet: Sequence[FleetModel]
                        ) -> Tuple[List[Request], List[PhasePlan]]:
    """Build the fleet's merged request stream.

    Each model runs its own seeded ``ArrivalProcess`` at rate
    ``share_k / gap_s`` (shares = normalized ``rate_share``); the merged
    stream takes the earliest pending candidate (ties break to the
    lowest model index).  Events are consumed in time order at stream
    build, exactly like single-model ``plan_workload``:

    - unscoped ``SetWorkload``: re-shapes every model's distribution;
      a ``gap_s`` change moves the *aggregate* rate, realigning every
      arrival process at the event time.
    - model-scoped ``SetWorkload`` (``model=...``): re-shapes only that
      model's query distribution (per-model phases).  Scoped rate
      changes are expressed through ``ShiftTraffic``, never ``gap_s`` —
      validation enforces this.
    - ``ShiftTraffic``: moves ``share`` points of rate share from one
      model to the other, conserving the aggregate rate; both affected
      processes realign at the event time (a share hitting zero silences
      that model until a later shift restores it).

    Every event starts a new :class:`PhasePlan` over a contiguous rid
    range of the merged stream (arrivals are accepted in global time
    order, so ranges stay contiguous even though models interleave).
    Scoped-event phases are labeled with the target model's resolved
    distribution; the recorded ``gap_s`` is always the aggregate gap.

    Sizes and payloads draw from per-model derived RNGs, sampled at
    acceptance under the owning model's phase distribution — one
    model's traffic never moves another's query contents.
    """
    w = spec.workload
    n_models = len(spec.models)
    events = sort_events([e for e in spec.events
                          if isinstance(e, (SetWorkload, ShiftTraffic))])
    name_to_k = {m.arch: k for k, m in enumerate(spec.models)}

    total_share = sum(m.rate_share for m in spec.models)
    shares = [m.rate_share / total_share for m in spec.models]
    agg_gap = w.gap_s
    # per-model query-distribution state (SetWorkload re-shapes it)
    cur = [{"mean_size": w.mean_size, "sigma": w.sigma,
            "max_size": w.max_size, "alpha": w.alpha}
           for _ in range(n_models)]

    def model_gap(k: int) -> float:
        return agg_gap / shares[k] if shares[k] > 0 else math.inf

    # validation guarantees every initial rate_share is positive, so
    # every process starts live; a ShiftTraffic draining a model to
    # zero share parks its candidate at +inf until a later shift
    # restores it
    procs = [ArrivalProcess(w.arrival, model_gap(k),
                            seed=_fleet_seed(w.seed, k),
                            burstiness=w.burstiness)
             for k in range(n_models)]
    cand = [procs[k].next() for k in range(n_models)]

    phases = [PhasePlan(index=0, t_start=0.0, gap_s=agg_gap, **cur[0])]
    # (arrival time, model, phase id, distribution snapshot) per
    # accepted request, in global time order — snapshotting at
    # acceptance keeps per-model phase distributions exact without a
    # second event replay
    accepted: List[Tuple[float, int, int, Dict[str, float]]] = []
    ev_i = 0
    for i in range(w.requests):
        t = min(cand)
        while ev_i < len(events) and events[ev_i].time_s <= t:
            ev = events[ev_i]
            ev_i += 1
            label_k = 0
            if isinstance(ev, SetWorkload):
                targets = ([name_to_k[ev.model]] if ev.model is not None
                           else list(range(n_models)))
                label_k = targets[0]
                for k in targets:
                    for name in ("mean_size", "sigma", "max_size",
                                 "alpha"):
                        v = getattr(ev, name)
                        if v is not None:
                            cur[k][name] = v
                if ev.gap_s is not None:        # unscoped by validation
                    agg_gap = ev.gap_s
                    for k in range(n_models):
                        if shares[k] > 0:
                            procs[k].realign(ev.time_s, model_gap(k))
                            cand[k] = procs[k].next()
            else:                               # ShiftTraffic
                kf = name_to_k[ev.from_model]
                kt = name_to_k[ev.to_model]
                shares[kf] = max(0.0, shares[kf] - ev.share)
                shares[kt] += ev.share
                for k in (kf, kt):
                    if shares[k] > 0:
                        procs[k].realign(ev.time_s, model_gap(k))
                        cand[k] = procs[k].next()
                    else:
                        cand[k] = math.inf
            phases.append(PhasePlan(
                index=len(phases), t_start=ev.time_s, gap_s=agg_gap,
                rid_start=i, rid_end=i, **cur[label_k]))
            t = min(cand)
        k = min(range(n_models), key=lambda m: (cand[m], m))
        accepted.append((cand[k], k, len(phases) - 1, dict(cur[k])))
        cand[k] = procs[k].next()

    rngs = [np.random.RandomState(_fleet_seed(w.seed, k))
            for k in range(n_models)]
    reqs: List[Request] = []
    for rid, (t, k, pid, c) in enumerate(accepted):
        qd = QueryDist(mean_size=c["mean_size"], sigma=c["sigma"],
                       max_size=c["max_size"], alpha=c["alpha"])
        size = int(qd.sample(rngs[k], 1)[0])
        b = dlrm_batch(fleet[k].model.cfg, size, rngs[k],
                       alpha=c["alpha"])
        reqs.append(Request(rid, {"dense": b["dense"],
                                  "indices": b["indices"]},
                            size, t, model=k))
        phases[pid].rid_end = rid + 1
    return reqs, phases


def run_fleet(spec: ScenarioSpec,
              fleet: Optional[Sequence[FleetModel]] = None,
              device: DeviceLike = None) -> ScenarioReport:
    """Serve a fleet spec end to end: build (or accept) the fleet,
    plan the merged stream, run the shared-pool engine with one SLA
    controller per model, and fold the outcome into the standard
    :class:`ScenarioReport` (with ``stats.per_model`` populated).

    ``fleet`` is an injection hook for callers that serve hand-built
    models; the caller owns the invariant that it matches
    ``spec.models`` in order and count, and that its parameters lie on
    ``device``."""
    spec.validate()
    if len(spec.models) < 2:
        raise ValueError("run_fleet needs a multi-model spec; "
                         "single-model specs take run_scenario")
    dev = resolve_device(device)
    members = (list(fleet) if fleet is not None
               else build_fleet(spec, device=dev))
    if len(members) != len(spec.models):
        raise ValueError(
            f"fleet has {len(members)} member(s) for "
            f"{len(spec.models)} spec model(s)")
    reqs, phases = plan_fleet_workload(spec, members)
    engine = ClusterEngine(
        members[0].model, members[0].params,
        spec.topology.cluster_config(seed=spec.workload.seed),
        fleet=[(f.name, f.model, f.params) for f in members], device=dev)
    controllers: Dict[int, object] = {}
    for k, mref in enumerate(spec.models):
        target = (mref.sla_p99_s if mref.sla_p99_s is not None
                  else spec.sla_p99_s)
        if target is not None:
            from repro_torch.serving.autoscaler import (
                SLAController, SLAControllerConfig)
            controllers[k] = SLAController(
                SLAControllerConfig(sla_p99_s=target, mode=spec.sla_mode),
                n_cn=spec.topology.n_cn, m_mn=spec.topology.m_mn)
    results, stats = engine.serve(reqs, events=spec.events,
                                  controllers=controllers or None)
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

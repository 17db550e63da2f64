"""Event-timeline dispatcher: `ClusterEngine.serve`'s execution core.

This module is the un-nesting of what used to be a ~270-line closure
stack inside ``ClusterEngine.serve``: one :class:`TimelineDispatcher`
owns a serve call's transient state (the ingress batcher, per-CN clock
arrays, per-request assembly buffers) and consumes a **unified, typed
event queue** (``serving.scenario`` events) in global time order.

Dispatch semantics (the ordering guarantees the scenario API documents):

- Events are stable-sorted by ``time_s``; equal times fire in listed
  order.  The legacy ``failures=``/``resizes=`` kwargs are converted by
  :func:`legacy_events` with failures listed before resizes, preserving
  the historical tie-break — legacy runs are bitwise-identical to their
  ``ScenarioSpec`` equivalents by construction.
- All events apply at batch boundaries on the virtual clock (before the
  next batch whose MN stage starts at or after their fire time), except
  ``FailMN``: a failure landing *inside* a batch's MN stage hits packets
  in flight — the batch's wasted first pass is charged, routing rebuilds
  over the survivors, and the batch re-issues (``reissues`` counter).
  A failure queued *behind* an earlier-timed pool-state event
  (``RecoverMN``/``ReloadParams``/``ReplanPlacement``) defers to the
  boundary so state changes on the same resource apply in true time
  order (see ``_next_fail``).
- A ``FailMN``/``RecoverMN`` aimed at an MN that has shrunk out of the
  pool by fire time is a recorded no-op (the machine isn't there), and a
  ``RecoverMN`` for a live MN likewise.  One asymmetry is deliberate
  (and pinned by legacy bitwise parity): a shrink stamped earlier
  *inside the same MN stage* has not taken effect yet when a failure
  strikes packets in flight — the MN is still live mid-stage, so the
  failure fires; the shrink lands at the next boundary.  Only at batch
  boundaries is "shrunk away" meaningful.  Validation happens up front
  against the *schedule-aware maximum* pool
  (``scenario.validate_events``), so a failure scheduled after a timed
  grow is accepted even though the target MN doesn't exist yet at serve
  start.
- ``SetWorkload`` is consumed when the stream is built
  (``scenario.plan_workload``); here it is audit-trail-only.

Every applied (or skipped) event lands in the audit trail as an
:class:`EventRecord` — event, fire time, resulting pool shape — which
``serve`` returns on ``ClusterStats.events``.

**Pipelined execution** (``serving.pipeline``): the virtual clock is a
set of per-resource FIFO timelines — each CN's preprocess core, gather
NIC, and GPU, and each MN's memory bus — and a batch's completion time
is the max over its resource chains.  ``ClusterConfig.inflight_depth``
bounds how many batches may be inside the MN stage (scans + gather) at
once; at depth 1 the admission floor degenerates to the old global
``mn_barrier`` and the dispatcher commits every stage with the
sequential clock's closed-form arithmetic, so depth-1 runs are
bitwise-identical to the pre-pipeline engine (scores, latencies, and
every ClusterStats counter).  At depth > 1 batch k+1's scans overlap
batch k's gather and dense stages, with per-resource queueing charged
where contention actually happens.  A mid-stage ``FailMN`` aborts the
struck batch's planned intervals at the failure instant — the in-
flight prefix of each scan/gather is charged to its resource — before
the batch re-issues on the survivors.

**Traffic realism** (this layer's additions on top of the pipeline):
per-query queueing delay (arrival -> first batch admission) is
measured into ``ClusterStats.queue_wait_{mean,p99}``; ``DegradeMN``
events slow an MN's bus by a factor (a batch-boundary pool-state
event, and — like every non-Resize/SetWorkload event — a barrier for
the mid-stage failure scan in ``_next_fail``); scans straggling past
``ClusterConfig.hedge_multiplier x`` their nominal time are hedged
onto replica buses (``_mn_plan``); and an optional ``SLAController``
is fed every completion, its emitted ``Resize`` events joining the
live queue via ``_enqueue``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import clocksan
from repro_torch.core import embedding_manager as em
from repro_torch.core import hardware as hw
from repro_torch.core.scheduler import Batch, Batcher, Query
from repro_torch.serving.cluster import CN_ROUTERS, ClusterStats, ModelStats
from repro_torch.serving.engine import Request, Result
from repro_torch.serving.pipeline import (AdmissionWindow, BatchTrace, HedgeIssue,
                                    MNPlan, fit_clocks, summarize_resources)
from repro_torch.serving.scenario import (DegradeMN, FailMN, RecoverMN,
                                    ReloadParams, ReplanPlacement, Resize,
                                    ScenarioEvent, SetWorkload, ShiftTraffic,
                                    _lat_stats, sort_events, validate_events)


def legacy_events(failures: Sequence[Tuple[float, int]],
                  resizes: Sequence[Tuple[float, int, int]]
                  ) -> List[ScenarioEvent]:
    """Shim the historical ``serve(failures=, resizes=)`` kwargs into
    typed events.  Failures are listed before resizes so the stable
    time-sort reproduces the old tie-break (a failure and a resize at
    the same instant applied the failure first)."""
    evs: List[ScenarioEvent] = [
        FailMN(float(t), mn=int(j)) for t, j in sorted(failures)]
    evs += [Resize(float(t), n_cn=int(n), m_mn=int(m))
            for t, n, m in sorted(resizes)]
    return evs


@dataclass(frozen=True)
class EventRecord:
    """Audit-trail entry: one timeline event and the pool it left
    behind (``applied=False`` marks a recorded no-op — e.g. a failure
    aimed at an MN that had already shrunk away)."""
    event: ScenarioEvent
    time_s: float
    n_cn: int
    m_mn: int
    dead: Tuple[int, ...]
    applied: bool = True


class TimelineDispatcher:
    """One serve call: consume the event queue in global time order
    while batching, routing, and scoring the request stream on the
    engine's virtual clock."""

    def __init__(self, engine, requests: Sequence[Request],
                 events: Sequence[ScenarioEvent], controller=None,
                 controllers: Optional[Dict[int, object]] = None):
        self.eng = engine
        if engine.cfg.cn_router not in CN_ROUTERS:
            raise ValueError(
                f"unknown cn_router {engine.cfg.cn_router!r}; "
                f"choose from {CN_ROUTERS}")
        self.requests = list(requests)
        self.queue: List[ScenarioEvent] = sort_events(events)
        validate_events(self.queue, engine.m_mn)
        self.audit: List[EventRecord] = []
        # optional SLA feedback controller(s)
        # (serving.autoscaler.SLAController): fed every completion,
        # emitted Resize events join the live queue.  The fleet form
        # `controllers` maps model index -> controller, so each model's
        # latency window and SLA target are tracked independently over
        # the shared pool; the legacy singular kwarg is the one-entry
        # dict keyed by model 0.
        if controller is not None and controllers:
            raise ValueError("give either controller (single) or "
                             "controllers (fleet), not both")
        self.controllers: Dict[int, object] = (
            dict(controllers) if controllers
            else ({0: controller} if controller is not None else {}))
        self.sla_actions = 0
        self.sla_actions_cn = 0
        self.sla_actions_mn = 0
        # retire instant of every clock a CN shrink removed, keyed by
        # object id (safe: the registry keeps retired clocks alive, so
        # ids are never reused within a run) — the truncation point for
        # a superseded pre-stage booking's abort charge
        self._retire_s: Dict[int, float] = {}
        # audit-completeness accounting (checked by clocksan when
        # REPRO_CLOCKSAN=1): every event ever on the queue — initial
        # timeline plus dynamically enqueued — must land in the audit
        self._n_events0 = len(self.queue)
        self._n_enqueued = 0

    # ------------------------------------------------------ event apply
    def _record(self, ev: ScenarioEvent, applied: bool = True) -> None:
        e = self.eng
        self.audit.append(EventRecord(ev, ev.time_s, e.n_cn, e.m_mn,
                                      tuple(sorted(e.dead)), applied))

    def _apply(self, ev: ScenarioEvent) -> None:
        """Apply one batch-boundary event and record the resulting pool
        shape.  (Mid-MN-stage failures take the in-flight path in
        ``_run_batch`` instead.)"""
        e = self.eng
        if isinstance(ev, FailMN):
            if ev.mn < e.m_mn:      # an MN that shrank away can't fail
                already = ev.mn in e.dead
                e.fail_mn(ev.mn)
                self._record(ev, applied=not already)
            else:
                self._record(ev, applied=False)
        elif isinstance(ev, RecoverMN):
            if ev.mn < e.m_mn and ev.mn in e.dead:
                e.recover_mn(ev.mn)
                self._record(ev)
            else:                   # departed, never failed, or healed
                self._record(ev, applied=False)
        elif isinstance(ev, Resize):
            # an identity resize (the pool already has the target shape)
            # returns early inside the engine without counting — mirror
            # that in the audit so applied records match stats.resizes
            changed = ((e.n_cn if ev.n_cn is None else ev.n_cn,
                        e.m_mn if ev.m_mn is None else ev.m_mn)
                       != (e.n_cn, e.m_mn))
            plan = e.resize(ev.n_cn, ev.m_mn, ev.mn_type)
            self.st = e.unit_model.stage_times(e.cfg.batch_size)
            self.mn_bw = np.asarray(e.mn_bw)
            self.mn_slow = np.asarray(e.mn_slow)
            # joining nodes are idle from the resize instant; a
            # departing node's clocks retire with their accumulated
            # stats (they stay in the registry for end-of-run
            # aggregation).  Batches are placed by the configured
            # cn_router policy over the live pool.
            for c in self.cn_cpu[e.n_cn:]:   # CN shrink: remember when
                self._retire_s[id(c)] = ev.time_s
            self.cn_cpu = fit_clocks(self.cn_cpu, e.n_cn, "cn_cpu",
                                     ev.time_s, self._clocks)
            self.cn_nic = fit_clocks(self.cn_nic, e.n_cn, "cn_nic",
                                     ev.time_s, self._clocks)
            self.cn_gpu = fit_clocks(self.cn_gpu, e.n_cn, "cn_gpu",
                                     ev.time_s, self._clocks)
            self.mn_bus = fit_clocks(self.mn_bus, e.m_mn, "mn_bus",
                                     ev.time_s, self._clocks)
            # migration bytes stream over the fabric in the background,
            # starting when the resize fires
            self.mig_end = (max(self.mig_end, ev.time_s)
                            + plan.bytes_moved / hw.NIC_BW)
            # under multi-controller fleet serving every controller's
            # internal pool view tracks the shared pool, whichever
            # controller (or scheduled event) moved it — a single
            # controller keeps the historical own-emissions-only view
            if len(self.controllers) > 1:
                for c in self.controllers.values():
                    c.sync_pool(e.n_cn, e.m_mn)
            self._record(ev, applied=changed)
        elif isinstance(ev, ReloadParams):
            e.reload_seed(ev.seed)
            self._record(ev)
        elif isinstance(ev, ReplanPlacement):
            e.replan_placement()
            self._record(ev)
        elif isinstance(ev, DegradeMN):
            if ev.mn < e.m_mn:
                changed = e.degrade_mn(ev.mn, ev.factor)
                self.mn_slow = np.asarray(e.mn_slow)
                self._record(ev, applied=changed)
            else:                   # departed via an earlier shrink
                self._record(ev, applied=False)
        elif isinstance(ev, ShiftTraffic):
            # consumed at stream build (fleet.plan_fleet_workload);
            # audit-trail only at dispatch, like SetWorkload
            self._record(ev)
        else:       # SetWorkload: consumed at stream build; audit only
            self._record(ev)

    def _inject(self, upto: float) -> None:
        """Apply every queued event with fire time <= `upto`, in global
        time order (batch-boundary semantics)."""
        while self.queue and self.queue[0].time_s <= upto:
            self._apply(self.queue.pop(0))

    def _enqueue(self, ev: ScenarioEvent) -> None:
        """Insert a dynamically emitted event (SLA controller feedback)
        into the live queue, keeping the time sort; equal times land
        after existing entries (stable, matching listed-order
        semantics).  The event applies at the next batch boundary like
        any other — emission never reaches back in time."""
        i = len(self.queue)
        while i > 0 and self.queue[i - 1].time_s > ev.time_s:
            i -= 1
        self.queue.insert(i, ev)
        self._n_enqueued += 1

    def _next_fail(self) -> Tuple[Optional[int], Optional[FailMN]]:
        """The next failure eligible for the in-flight mid-stage path.

        ``Resize`` and ``SetWorkload`` are pure batch-boundary events
        and may be scanned past (the historical semantics: a failure
        strikes packets in flight even if a resize is stamped earlier
        inside the same stage — legacy parity pins this).  Pool-*state*
        events on the queue (``RecoverMN``/``ReloadParams``/
        ``ReplanPlacement``) are barriers instead: a failure behind one
        defers to the next boundary, where `_inject` applies both in
        true time order — otherwise a later failure of an MN could
        apply before its earlier-timed recovery and leave the pool in
        the time-reversed state (and the audit trail out of order).
        Likewise a failure whose target MN only exists after a pending
        earlier-timed grow defers to the boundary — popping it now
        (pool not yet grown) would silently no-op an event the
        schedule-aware validation promised would fire."""
        m_pend = self.eng.m_mn       # pool size at the failure's fire
        for i, ev in enumerate(self.queue):  # time, per pending resizes
            if isinstance(ev, FailMN):
                if ev.mn >= self.eng.m_mn and ev.mn < m_pend:
                    return None, None     # exists only after the grow
                return i, ev
            if isinstance(ev, Resize):
                if ev.m_mn is not None:
                    m_pend = ev.m_mn
                continue
            if isinstance(ev, SetWorkload):
                continue
            if isinstance(ev, ShiftTraffic):  # stream-build-time event:
                continue                      # scannable-past, like
            return None, None                 # SetWorkload
        return None, None

    # --------------------------------------------------------- routing
    def _outstanding(self, i: int, now: float) -> int:
        """Bookings on CN ``i``'s clocks (cpu/nic/gpu) not yet finished
        at ``now``.  FIFO clocks have nondecreasing interval ends, so a
        reverse scan stops at the first finished one."""
        n = 0
        for clocks in (self.cn_cpu, self.cn_nic, self.cn_gpu):
            for iv in reversed(clocks[i].intervals):
                if iv.end > now:
                    n += 1
                else:
                    break
        return n

    def _route_cn(self, now: float) -> int:
        """Pick the CN for the next batch per ``ClusterConfig.cn_router``.
        Ties break to the lowest index on every policy (``min`` over the
        index range) — routing is deterministic by construction.

        - ``cpu_free`` (legacy default): earliest-free preprocess core;
          bitwise-identical to the historical placement.
        - ``pipeline_free``: earliest point where the CN's *whole*
          pipeline (cpu, gather NIC, GPU) has drained — sees the per-CN
          NIC/GPU backlogs the cpu clock is blind to.
        - ``least_outstanding``: fewest uncommitted bookings across the
          CN's three clocks at ``now`` (join-shortest-queue).
        """
        policy = self.eng.cfg.cn_router
        if policy == "pipeline_free":
            def key(i):
                return max(self.cn_cpu[i].free_at,
                           self.cn_nic[i].free_at,
                           self.cn_gpu[i].free_at)
        elif policy == "least_outstanding":
            def key(i):
                return self._outstanding(i, now)
        else:                        # cpu_free
            def key(i):
                return self.cn_cpu[i].free_at
        return min(range(len(self.cn_cpu)), key=key)

    def _pool_pressure(self) -> Tuple[float, float]:
        """Per-node accumulated queueing seconds of each pool over the
        *live* clocks — the binding-pool attribution signal the
        decoupled SLA controller consumes.  CN pressure folds the cpu,
        gather-NIC, and GPU queues; MN pressure the memory buses."""
        cn = (sum(c.queue_s for c in self.cn_cpu)
              + sum(c.queue_s for c in self.cn_nic)
              + sum(c.queue_s for c in self.cn_gpu))
        mn = sum(c.queue_s for c in self.mn_bus)
        return (cn / max(1, len(self.cn_cpu)),
                mn / max(1, len(self.mn_bus)))

    # --------------------------------------------------------- serving
    def _stage_account(self, mem_j: np.ndarray,
                       gat_j: np.ndarray) -> np.ndarray:
        """Per-MN stage-seconds contributions (scan at the MN's bus
        bandwidth, slowed by any ``DegradeMN`` factor, + its share of
        the gather serialization) — the byte-derived accounting the
        sequential engine charged per batch.  ``mem_j * 1.0`` is
        float-exact, so an undegraded pool reproduces the historical
        numbers bit-for-bit."""
        return (mem_j * self.mn_slow) / self.mn_bw + gat_j / hw.NIC_BW

    def _mn_plan(self, task: int, mn_start: float, mem_j: np.ndarray,
                 gat_j: np.ndarray, cache_s: float) -> MNPlan:
        """Plan (without committing) one batch's MN stage on the
        per-resource clocks: every routed MN scans (and, for NMP, pools
        — a bandwidth-bound streaming reduction) locally in parallel on
        its own memory bus, then the batch's gather bytes serialize
        into the owning CN's back-end NIC once every scan and the
        CN-side cache probe (which overlaps the remote scans — hits
        never wait on the fabric) have drained.

        The closed-form gate ``t_gate`` is computed with the sequential
        clock's exact floating-point arithmetic; it is the committed
        stage time whenever no resource queues the batch (always true
        at depth 1), which is what makes depth-1 runs bitwise-identical
        to the pre-pipeline engine.

        **Hedged re-issue** (``ClusterConfig.hedge_multiplier > 0``,
        FlexEMR's optimistic get): a scan whose degraded duration
        exceeds ``multiplier x`` its nominal (undegraded) duration is
        re-issued at the detection instant — per table, on the fastest
        live replica bus holding that table — and the batch proceeds at
        the first finisher.  Both issues are charged to their buses.
        Hedging is all-or-nothing per scan: if any of the straggler's
        tables has no live alternate replica, no hedge is issued.  A
        plan with hedges always takes the queued commit path."""
        e = self.eng
        mult = float(e.cfg.hedge_multiplier)
        scans: List[Tuple[int, float, float]] = []
        max_dur = 0.0
        queued = False
        bus_tail: Dict[int, float] = {}   # overlay: planned FIFO tails
        for j in np.nonzero(mem_j > 0)[0]:
            dur = (mem_j[j] * self.mn_slow[j]) / self.mn_bw[j]
            s = self.mn_bus[j].peek(mn_start)
            if s > mn_start:
                queued = True
            scans.append((int(j), s, dur))
            bus_tail[int(j)] = s + dur
            if dur > max_dur:
                max_dur = dur
        # effective per-scan completion: the original end, or the hedge
        # end when the hedge wins
        ends: Dict[int, float] = {j: s + dur for j, s, dur in scans}
        hedges: List[HedgeIssue] = []
        if mult > 0:
            for j, s, dur in scans:
                nom = mem_j[j] / self.mn_bw[j]   # undegraded expectation
                if not dur > mult * nom:
                    continue
                detect = s + mult * nom
                per_table = e._last_scan.get(j, [])
                tot = sum(b for _, b in per_table)
                if tot <= 0:
                    continue
                # _last_scan holds raw per-table demand; rescale so the
                # hedge moves exactly the cache-adjusted bytes the
                # original scan was charged for
                scale = float(mem_j[j]) / tot
                groups: Dict[int, float] = {}
                ok = True
                for tid, b in per_table:
                    alts = [m for m in e.alloc.replicas.get(tid, ())
                            if m != j and m not in e.dead and m < e.m_mn]
                    if not alts:
                        ok = False      # all-or-nothing: no partial hedge
                        break
                    m2 = min(alts, key=lambda m: (
                        self.mn_slow[m] / self.mn_bw[m], m))
                    groups[m2] = groups.get(m2, 0.0) + b * scale
                if not ok or not groups:
                    continue
                issues: List[Tuple[int, float, float, float]] = []
                hend = detect
                for m2 in sorted(groups):
                    b2 = groups[m2]
                    d2 = (b2 * self.mn_slow[m2]) / self.mn_bw[m2]
                    s2 = max(self.mn_bus[m2].peek(detect),
                             bus_tail.get(m2, 0.0))
                    bus_tail[m2] = s2 + d2
                    issues.append((m2, s2, d2, b2))
                    if s2 + d2 > hend:
                        hend = s2 + d2
                won = hend < s + dur
                hedges.extend(
                    HedgeIssue(src_mn=j, alt_mn=m2, detect_s=detect,
                               start_s=s2, dur_s=d2, bytes_b=b2, won=won)
                    for m2, s2, d2, b2 in issues)
                if won:
                    ends[j] = hend
                queued = True           # alternate buses were planned
        scan_end = mn_start
        for j, s, dur in scans:
            if ends[j] > scan_end:
                scan_end = ends[j]
        g_dur = float(gat_j.sum() / hw.NIC_BW)
        t_gate = float(max(max_dur, cache_s) + g_dur)
        gather_ready = max(scan_end, mn_start + cache_s)
        if g_dur > 0:
            g_start = self.cn_nic[task].peek(gather_ready)
            if g_start > gather_ready:
                queued = True
        else:
            g_start = gather_ready
        end = (g_start + g_dur) if queued else (mn_start + t_gate)
        return MNPlan(mn_start=mn_start, scans=scans, t_gate=t_gate,
                      gather_ready=gather_ready, gather_start=g_start,
                      gather_dur=g_dur, queued=queued, end=end,
                      hedges=tuple(hedges))

    def _mn_abort(self, task: int, plan: MNPlan, t_fail: float,
                  bid: int) -> None:
        """An in-flight MN failure killed this batch's first pass at
        ``t_fail``: the traffic already on the buses and the NIC was
        real, so each planned interval's in-flight prefix is charged to
        its resource before the batch re-issues.  (The byte counters
        charge the full pass, matching the sequential engine.)

        Hedge prefixes are charged after the originals — a hedge's
        start never precedes its bus's planned tail, so FIFO causality
        holds.  Aborted hedges charge bus *time* only, not bytes: the
        full original pass's bytes (which the hedge duplicated a subset
        of) are already charged by the re-issue path."""
        for j, s, dur in plan.scans:
            self.mn_bus[j].charge_abort(s, min(s + dur, t_fail), bid)
        for h in plan.hedges:
            self.mn_bus[h.alt_mn].charge_abort(
                h.start_s, min(h.end_s, t_fail), bid)
        if plan.gather_dur > 0 and plan.gather_start < t_fail:
            self.cn_nic[task].charge_abort(
                plan.gather_start, min(plan.end, t_fail), bid)

    def _mn_commit(self, task: int, plan: MNPlan, extra_gather: float,
                   bid: int) -> Tuple[float, float, Tuple[float, float]]:
        """Commit the settled plan to the clocks.  Returns (stage done
        time, stage span, gather interval).  ``extra_gather`` is the
        in-flight shard migration's fair-share extension of the gather
        serialization.  Wait-free commits reproduce the sequential
        clock's closed-form chain bit-for-bit; queued commits follow
        the per-resource chain."""
        mn_start = plan.mn_start
        if plan.queued:
            g_dur = plan.gather_dur + extra_gather
            mn_done = (plan.gather_start + g_dur if plan.gather_dur > 0
                       else plan.gather_ready)
            t_mn = mn_done - mn_start
        else:
            t_mn = plan.t_gate
            if extra_gather:
                t_mn = t_mn + extra_gather
            mn_done = mn_start + t_mn
        for j, s, dur in plan.scans:
            self.mn_bus[j].book(mn_start, s, s + dur, bid)
        # hedges book after the originals: each hedge's start is at or
        # beyond its bus's planned tail, so FIFO causality holds.  The
        # hedge's bytes and stage-seconds are charged to the alternate
        # MN — the duplicate traffic is real, win or lose.
        e = self.eng
        for h in plan.hedges:
            self.mn_bus[h.alt_mn].book(h.detect_s, h.start_s, h.end_s,
                                       bid)
            e.mn_access_bytes[h.alt_mn] += h.bytes_b
            e.mn_stage_s[h.alt_mn] += h.dur_s
        if plan.hedges:
            e.hedges += len({h.src_mn for h in plan.hedges})
            e.hedge_wins += len({h.src_mn for h in plan.hedges if h.won})
        gather = (plan.gather_start, plan.gather_start)
        if plan.gather_dur > 0:
            self.cn_nic[task].book(plan.gather_ready, plan.gather_start,
                                   mn_done, bid)
            gather = (plan.gather_start, mn_done)
        return mn_done, t_mn, gather

    def _run_batch(self, b: Batch, now: float) -> None:
        e = self.eng
        cfg = e.cfg
        st = self.st
        # assemble real rows from each member query's payload
        dense_rows, idx_rows = [], []
        for q, nrows in b.parts:
            c = self.row_cursor[q.qid]
            dense_rows.append(self.payload[q.qid]["dense"][c:c + nrows])
            idx_rows.append(self.payload[q.qid]["indices"][c:c + nrows])
            self.row_cursor[q.qid] = c + nrows
        dense = np.concatenate(dense_rows)
        idx = np.concatenate(idx_rows)
        pad = cfg.batch_size - dense.shape[0]
        if pad > 0:
            dense = np.concatenate(
                [dense, np.zeros_like(dense[:1]).repeat(pad, 0)])
            idx = np.concatenate(
                [idx, -np.ones_like(idx[:1]).repeat(pad, 0)])

        scale = b.size / cfg.batch_size
        # plan-then-commit: peek the pre stage without booking, inject
        # any events due by mn_start, and only commit the pre on the CN
        # that survives them.  (Booking up front would leave a phantom
        # busy interval on a CN a shrink retires mid-window — and the
        # superseded booking would advance free_at past the abort's
        # start, so the FIFO clock could never take the charge back.)
        task = self._route_cn(now)
        cpu = self.cn_cpu[task]
        pre_start = cpu.peek(now)
        pre_done = pre_start + st.t_pre * scale  # reserve's exact chain
        chain_ready = pre_done + st.t_comm_in * scale
        mn_start = max(chain_ready, self.window.floor())

        # MNs that died during G_P/scatter are gone before this batch's
        # MN stage begins: re-route first, then execute
        self._inject(mn_start)
        # a CN shrink landing inside the G_P/scatter window may have
        # retired the chosen CN: charge the superseded pre's in-flight
        # prefix to the retired clock as an abort (mirroring _mn_abort)
        # and hand the batch off to a survivor
        while task >= len(self.cn_cpu):
            t_ret = self._retire_s.get(id(cpu), mn_start)
            cpu.charge_abort(pre_start, min(pre_done, t_ret), b.bid)
            st = self.st
            task = self._route_cn(now)
            cpu = self.cn_cpu[task]
            pre_start = cpu.peek(now)
            pre_done = pre_start + st.t_pre * scale
            chain_ready = pre_done + st.t_comm_in * scale
            mn_start = max(chain_ready, self.window.floor())
            self._inject(mn_start)
        st = self.st
        cpu.book(now, pre_start, pre_done, b.bid)
        self.window.wait_s += mn_start - chain_ready
        # per-query queueing delay: arrival -> first batch admission
        # (the instant its first part starts preprocessing).  Charged
        # once per query, at the part that admits it.
        for q, _ in b.parts:
            if q.qid not in self.first_admit:
                self.first_admit[q.qid] = pre_start
                self.queue_waits.append(pre_start - self.arrival[q.qid])
                self.m_queue_waits.setdefault(b.model, []).append(
                    pre_start - self.arrival[q.qid])
        scores, mem_j, gat_j = e._execute(task, dense, idx, model=b.model)
        stage_j = self._stage_account(mem_j, gat_j)
        plan = self._mn_plan(task, mn_start, mem_j, gat_j,
                             e._batch_cache_s)

        # a failure landing inside this batch's MN stage hits packets
        # in flight: rebuild routing, re-issue on the survivors
        reissued = 0
        while True:
            qi, nxt = self._next_fail()
            if nxt is None or not (mn_start < nxt.time_s <= plan.end):
                break
            self.queue.pop(qi)
            t_fail, j = nxt.time_s, nxt.mn
            if j >= e.m_mn:         # departed via an earlier shrink
                self._record(nxt, applied=False)
                continue
            hit = mem_j[j] > 0
            already = j in e.dead
            e.fail_mn(j)
            self._record(nxt, applied=not already)
            if hit:
                # the aborted pass's traffic was already on the wire
                # and the bus — charge the wasted bytes in full and
                # each planned interval's in-flight prefix to its
                # resource, then re-issue on the survivors
                e.reissues += 1
                reissued += 1
                e.mn_access_bytes += mem_j
                e.mn_gather_bytes += gat_j
                e.mn_stage_s += stage_j
                self._mn_abort(task, plan, t_fail, b.bid)
                scores, mem_j, gat_j = e._execute(task, dense, idx,
                                                  model=b.model)
                stage_j = self._stage_account(mem_j, gat_j)
                mn_start = t_fail + cfg.mn_recovery_s
                plan = self._mn_plan(task, mn_start, mem_j, gat_j,
                                     e._batch_cache_s)
        # an in-flight shard migration fair-shares the gather NIC path
        # with this batch: each stream extends by the other's demand
        # for the overlap
        extra = 0.0
        if mn_start < self.mig_end and gat_j.sum() > 0:
            extra = float(gat_j.sum()) / hw.NIC_BW
            self.mig_end += extra
        mn_done, t_mn, gather_iv = self._mn_commit(task, plan, extra,
                                                   b.bid)
        self.window.complete(mn_done)
        e.mn_access_bytes += mem_j
        e.mn_gather_bytes += gat_j
        e.mn_stage_s += stage_j
        e._mn_stage_max_sum += t_mn
        e._n_batches += 1
        # keep admission priorities tracking the live workload even on
        # an event-free run (deterministic: a pure function of the
        # stream prefix served so far)
        if e.caches and e._n_batches % 8 == 0:
            e._refresh_hot_tables()

        d_start, done = self.cn_gpu[task].reserve(
            mn_done, st.t_dense * scale, b.bid)
        if done > self.last_done:
            self.last_done = done
        self.trace.append(BatchTrace(
            bid=b.bid, task=task, size=b.size, pre=(pre_start, pre_done),
            chain_ready=chain_ready, mn_start=mn_start,
            scans=tuple((j, s, s + dur) for j, s, dur in plan.scans),
            gather=gather_iv, mn_done=mn_done, dense=(d_start, done),
            done=done, reissues=reissued,
            qids=tuple(q.qid for q, _ in b.parts),
            hedges=plan.hedges))

        o = 0
        for q, nrows in b.parts:
            self.pieces[q.qid].append(scores[o:o + nrows])
            o += nrows
            self.rows_left[q.qid] -= nrows
            prev = self.part_done.get(q.qid)
            if prev is None or done > prev:
                self.part_done[q.qid] = done
            if self.rows_left[q.qid] == 0:
                # a split query completes when its LAST part's dense
                # stage finishes — under pipelining (and even on the
                # sequential clock, across CNs with uneven GPU queues)
                # the batch that zeroes rows_left need not finish last
                lat = self.part_done[q.qid] - self.arrival[q.qid]
                self.latencies.append(lat)
                self.m_latencies.setdefault(b.model, []).append(lat)
                self.results.append(Result(
                    q.qid, np.concatenate(self.pieces[q.qid]), lat))
                ctl = self.controllers.get(b.model)
                if ctl is not None:
                    # feed the owning model's SLA loop; emitted resizes
                    # join the live queue and apply at the next batch
                    # boundary
                    for act in ctl.observe(
                            self.part_done[q.qid], lat,
                            pressure=self._pool_pressure()):
                        self._enqueue(act)
                        self.sla_actions += 1
                        self.m_sla_actions[b.model] = (
                            self.m_sla_actions.get(b.model, 0) + 1)
                        if act.n_cn is not None:
                            self.sla_actions_cn += 1
                        if act.m_mn is not None:
                            self.sla_actions_mn += 1

    def _drain_due(self, upto: Optional[float]) -> None:
        """Form every batch whose flush deadline has passed, earliest
        deadline first across the per-model batchers (equal deadlines
        break to the lowest model index — deterministic)."""
        while True:
            best: Optional[Tuple[int, float]] = None
            for k in sorted(self.batchers):
                dl = self.batchers[k].next_deadline()
                if dl is not None and (best is None or dl < best[1]):
                    best = (k, dl)
            if best is None or (upto is not None and best[1] > upto):
                return
            k, dl = best
            self._inject(dl)
            out = self.batchers[k].flush(dl)
            if not out:
                return
            for b in out:
                self._run_batch(b, dl)

    def run(self) -> Tuple[List[Result], ClusterStats]:
        e = self.eng
        cfg = e.cfg
        # one ingress batcher per model in the stream (a single-model
        # stream gets exactly the historical lone batcher: model 0,
        # bid_start 0, stride 1)
        models = sorted({r.model for r in self.requests}) or [0]
        self.batchers = {
            k: Batcher(cfg.batch_size, cfg.max_wait_s, model=k,
                       bid_start=i, bid_step=len(models))
            for i, k in enumerate(models)}
        self.m_latencies: Dict[int, List[float]] = {}
        self.m_queue_waits: Dict[int, List[float]] = {}
        self.m_sla_actions: Dict[int, int] = {}
        e._refresh_hot_tables()    # hotness measured by prior serving
        requests = self.requests
        self.payload = {r.rid: r.payload for r in requests}
        self.arrival = {r.rid: r.arrival for r in requests}
        self.row_cursor: Dict[int, int] = {r.rid: 0 for r in requests}
        self.pieces: Dict[int, List[np.ndarray]] = {
            r.rid: [] for r in requests}
        self.rows_left = {r.rid: r.size for r in requests}
        self.results: List[Result] = []
        self.latencies: List[float] = []

        self.st = e.unit_model.stage_times(cfg.batch_size)
        self.mn_bw = np.asarray(e.mn_bw)
        self.mn_slow = np.asarray(e.mn_slow)
        self.first_admit: Dict[int, float] = {}
        self.queue_waits: List[float] = []
        self.depth = int(cfg.inflight_depth)
        self.window = AdmissionWindow(self.depth)
        self._clocks: List = []    # every clock ever created (live+retired)
        self.cn_cpu = fit_clocks([], e.n_cn, "cn_cpu", 0.0, self._clocks)
        self.cn_nic = fit_clocks([], e.n_cn, "cn_nic", 0.0, self._clocks)
        self.cn_gpu = fit_clocks([], e.n_cn, "cn_gpu", 0.0, self._clocks)
        self.mn_bus = fit_clocks([], e.m_mn, "mn_bus", 0.0, self._clocks)
        self.mig_end = 0.0         # background migration busy-until
        self.last_done = 0.0       # makespan: latest dense finish
        self.trace: List[BatchTrace] = []
        self.part_done: Dict[int, float] = {}

        for req in sorted(requests, key=lambda r: r.arrival):
            self._drain_due(req.arrival)
            self._inject(req.arrival)
            q = Query(req.rid, req.arrival, req.size)
            for b in self.batchers[req.model].offer(q, req.arrival):
                self._run_batch(b, req.arrival)
        self._drain_due(None)
        # events stamped after the last batch deadline still belong to
        # the scenario: flush them in time order so the declared
        # end-state (and the audit trail) matches the timeline instead
        # of silently dropping the tail.  No batch runs after this, so
        # scores/latencies/bytes are untouched — only routing, pool
        # shape, and counters move.
        self._inject(math.inf)

        # nothing completed reports nan, not a fabricated 0.0
        mean_lat, p50, p95, p99 = _lat_stats(self.latencies)
        qw_mean, _, _, qw_p99 = _lat_stats(self.queue_waits)
        live = [a for j, a in enumerate(e.mn_access_bytes)
                if j not in e.dead]
        cs = e.cache_stats()
        makespan = self.last_done
        r_busy, r_queue, r_util, r_occ = summarize_resources(
            self._clocks, makespan)
        # per-model breakdown (one entry per fleet member, single-model
        # runs included — their lone entry mirrors the global fields)
        n_queries: Dict[int, int] = {}
        for r in requests:
            n_queries[r.model] = n_queries.get(r.model, 0) + 1
        per_model: Dict[str, ModelStats] = {}
        for k, name in enumerate(e.model_names):
            m_lats = self.m_latencies.get(k, [])
            _, _, _, m_p99 = _lat_stats(m_lats)
            _, _, _, m_qw99 = _lat_stats(self.m_queue_waits.get(k, []))
            per_model[name] = ModelStats(
                queries=n_queries.get(k, 0),
                completed=len(m_lats),
                p99=m_p99,
                queue_wait_p99=m_qw99,
                cache_hits=e.fleet_cache_hits[k],
                cache_bytes_saved=e.fleet_cache_bytes_saved[k],
                sla_actions=self.m_sla_actions.get(k, 0),
            )
        stats = ClusterStats(
            completed=len(self.results),
            mean_latency=mean_lat,
            p50=p50,
            p95=p95,
            failures=e.failures,
            reroutes=e.reroutes,
            reinits=e.reinits,
            mn_access_bytes=list(e.mn_access_bytes),
            mn_gather_bytes=list(e.mn_gather_bytes),
            mn_types=list(e.mn_types),
            imbalance=em.imbalance(live),
            recoveries=e.recoveries,
            resizes=e.resizes,
            migration_bytes=e.migration_bytes,
            retired_access_bytes=e.retired_access_bytes,
            retired_gather_bytes=e.retired_gather_bytes,
            p99=p99,
            reissues=e.reissues,
            cache_hits=cs.hits,
            cache_misses=cs.misses,
            cache_evictions=cs.evictions,
            cache_invalidations=cs.invalidations,
            cache_bytes_saved=e.cache_bytes_saved,
            inflight_depth=self.depth,
            makespan_s=makespan,
            throughput_qps=(len(self.results) / makespan
                            if makespan > 0 else float("nan")),
            admission_wait_s=self.window.wait_s,
            queue_wait_mean=qw_mean,
            queue_wait_p99=qw_p99,
            degrades=e.degrades,
            hedges=e.hedges,
            hedge_wins=e.hedge_wins,
            sla_actions=self.sla_actions,
            sla_actions_cn=self.sla_actions_cn,
            sla_actions_mn=self.sla_actions_mn,
            sla_window_filled=all(c.window_filled
                                  for c in self.controllers.values()),
            per_model=per_model,
            resource_busy_s=r_busy,
            resource_queue_s=r_queue,
            resource_util=r_util,
            resource_occupancy=r_occ,
            events=list(self.audit),
        )
        if clocksan.enabled():
            # post-hoc sanitize: FIFO/overlap over every clock ever
            # created (live + retired), busy-time conservation against
            # the committed intervals, the per-resource folds on stats,
            # and audit completeness (every fired event recorded)
            clocksan.verify_run(
                self._clocks, stats, audit=stats.events,
                n_audit_expected=self._n_events0 + self._n_enqueued)
        e.last_trace = self.trace
        e.last_resources = list(self._clocks)
        self.results.sort(key=lambda r: r.rid)
        return self.results, stats

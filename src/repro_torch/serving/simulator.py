"""Discrete-event cluster simulator (validates §III-C, §IV-C, §IV-D).
The port's copy of ``repro.serving.simulator``: numpy only, no device.

Pipeline per batch: batcher -> G_P (CN CPU) -> packet scatter -> MN pool
under INTERLEAVED (per-MN FCFS) or SEQUENTIAL (global lock-step) policy
-> Fsum gather -> G_D (CN GPU) -> done.

Why interleaving hurts (Fig. 8): packets from different CNs arrive at
MNs in different orders (network jitter); FCFS then runs query A before
B on one MN and B before A on another — every in-flight query waits for
the union. Sequential processing orders queries globally, so query i's
packets run in lock step and it completes as early as possible.

Failures (Fig. 9 / §IV-D): CN/MN failure events pause the affected
resources for their recovery time; MN failure triggers the routing
rebuild (fast) unless replicas are lost. Straggler mitigation: packets
exceeding `straggler_factor` x their nominal service are re-issued on the
least-loaded surviving MN.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import failure as fail_mod
from repro_torch.core.scheduler import INTERLEAVED, SEQUENTIAL
from repro_torch.core.serving_unit import ServingUnitModel
from repro_torch.data.queries import QueryDist, poisson_arrivals


@dataclass
class SimConfig:
    batch_size: int = 128
    policy: str = SEQUENTIAL
    max_batch_wait_s: float = 0.002
    net_jitter_s: float = 0.0002
    # batch-content variability (heavy-tailed pooling factors, Fig. 2a):
    # common to all of a batch's packets
    batch_cv: float = 0.5
    # residual per-MN imbalance after greedy MemAccess routing: small
    service_cv: float = 0.05
    # memory-interference penalty when an MN interleaves multiple queries:
    # concurrent table scans destroy DRAM row locality (RecNMP-style
    # row-buffer-hit degradation); calibrated to Fig. 8
    ps_overhead: float = 0.25
    seed: int = 0
    inject_failures: bool = False
    straggler_factor: float = 3.0
    duration_s: float = 5.0
    warmup_s: float = 1.0


def _ps_schedule(arrivals: np.ndarray, works: np.ndarray,
                 busy_until: float = 0.0,
                 overhead: float = 0.0,
                 max_concurrency: int = 4) -> np.ndarray:
    """Limited processor sharing: up to `max_concurrency` jobs progress
    together at 1/(k*(1+overhead)) each (overhead = memory-interference
    loss when scans of different queries interleave); excess jobs wait
    FIFO — the memory controller's bounded in-flight queue, which makes
    interleaved peak throughput approach FCFS at saturation (Fig. 8b)."""
    n = len(arrivals)
    order = np.argsort(arrivals, kind="stable")
    done = np.empty(n)
    active: List[List] = []                 # [remaining, id]
    waiting: List[int] = []                 # FIFO of job ids
    t = busy_until
    i = 0
    while active or waiting or i < n:
        # admit from FIFO up to the concurrency cap
        while waiting and len(active) < max_concurrency:
            jid = waiting.pop(0)
            active.append([works[jid], jid])
        next_arr = arrivals[order[i]] if i < n else np.inf
        if not active:
            t = max(t, next_arr)
            waiting.append(order[i])
            i += 1
            continue
        k = len(active)
        slow = k * (1.0 + (overhead if k > 1 else 0.0))
        min_rem = min(a[0] for a in active)
        t_fin = t + min_rem * slow
        if t_fin <= next_arr:
            for a in active:
                a[0] -= min_rem
            t = t_fin
            still = []
            for a in active:
                if a[0] <= 1e-15:
                    done[a[1]] = t
                else:
                    still.append(a)
            active = still
        else:
            dt = (next_arr - t) / slow
            for a in active:
                a[0] -= dt
            t = next_arr
            waiting.append(order[i])
            i += 1
    return done


@dataclass
class SimStats:
    throughput_qps: float
    mean_latency: float
    p50: float
    p95: float
    p99: float
    completed: int
    dropped_packets: int = 0
    failures: int = 0


class ClusterSim:
    """One serving unit ({n CN, m MN} or n monolithic servers)."""

    def __init__(self, unit_model: ServingUnitModel, cfg: SimConfig):
        self.um = unit_model
        self.cfg = cfg
        self.n = unit_model.unit.n
        self.m = max(unit_model.unit.m, 1)
        self.disagg = unit_model.unit.scheme == "disagg"

    # per-batch stage service times from the analytic unit model
    def _times(self, batch: int) -> Tuple[float, float, float, float]:
        st = self.um.stage_times(batch)
        t_packet = st.t_sparse            # total MN work, split over m
        return st.t_pre, st.t_comm_in + st.t_comm_out, t_packet, st.t_dense

    def run(self, rate_qps: float, query_dist: Optional[QueryDist] = None
            ) -> SimStats:
        cfg = self.cfg
        rng = np.random.RandomState(cfg.seed)
        qd = query_dist or QueryDist()
        arrivals = poisson_arrivals(rate_qps, cfg.duration_s, rng)
        sizes = qd.sample(rng, len(arrivals))

        # ---- form batches (shared batcher, round-robin to CNs)
        batches = []       # (formed_time, batch_samples, [(qid, arrival)])
        pend: List[Tuple[int, float, int]] = []
        pend_since = None
        acc = 0
        for qid, (t, s) in enumerate(zip(arrivals, sizes)):
            remaining = int(s)
            # split large queries into sub-batches
            while remaining > 0:
                take = min(remaining, cfg.batch_size)
                pend.append((qid, t, take))
                if pend_since is None:
                    pend_since = t
                acc += take
                remaining -= take
                while acc >= cfg.batch_size:
                    grab, members, rest = cfg.batch_size, [], []
                    for q, ta, c in pend:
                        u = min(c, grab)
                        grab -= u
                        if u > 0:
                            members.append((q, ta))
                        if c - u > 0:
                            rest.append((q, ta, c - u))
                    pend = rest
                    acc -= cfg.batch_size
                    batches.append((t, cfg.batch_size, members))
                    pend_since = t if pend else None
        if pend:
            batches.append((arrivals[-1] if len(arrivals) else 0.0,
                            acc, [(q, ta) for q, ta, _ in pend]))

        # ---- discrete-event pipeline
        t_pre, t_comm, t_sparse_total, t_dense = self._times(cfg.batch_size)
        cn_free = np.zeros(self.n)            # G_P servers
        gpu_free = np.zeros(self.n)           # G_D servers
        mn_free = np.zeros(self.m)            # MN servers
        mn_queue_release = 0.0                # sequential barrier clock
        fail_until = {"cn": np.zeros(self.n), "mn": np.zeros(self.m)}
        n_failures = 0

        if cfg.inject_failures:
            # window-scaled: P(fail in window) = daily_rate * window/86400
            frac = cfg.duration_s / 86400.0
            for kind, count, rate in (("cn", self.n, fail_mod.hw.FAIL_CN),
                                      ("mn", self.m, fail_mod.hw.FAIL_MN)):
                p = min(1.0, rate * frac)
                for i in range(count):
                    if rng.rand() < p:
                        t = rng.uniform(0, cfg.duration_s)
                        fail_until[kind][i] = (
                            t + fail_mod.recovery_cost_s(kind))
                        n_failures += 1

        query_done: Dict[int, float] = {}
        query_arr: Dict[int, float] = {}
        query_parts: Dict[int, int] = {}
        for t, b, members in batches:
            for q, ta in members:
                query_arr[q] = min(query_arr.get(q, np.inf), ta)
                query_parts[q] = query_parts.get(q, 0) + 1

        stragglers = 0
        nb = len(batches)
        scales = np.array([b / cfg.batch_size for _, b, _ in batches])
        pre_done = np.empty(nb)
        cn_of = np.empty(nb, np.int64)

        # ---- G_P on the least-loaded CN
        for bi, (formed, bsize, members) in enumerate(batches):
            i = int(np.argmin(np.maximum(cn_free, fail_until["cn"])))
            start = max(formed, cn_free[i], fail_until["cn"][i])
            pre_done[bi] = start + t_pre * scales[bi]
            cn_free[i] = pre_done[bi]
            cn_of[bi] = i

        # ---- MN stage: per-batch packet arrivals and service demands.
        # The CN back-end NIC serializes the m packet sends, so a batch's
        # packets arrive staggered across MNs (the interleaving window).
        pk_service = (t_sparse_total / self.m)
        send_order = np.stack([rng.permutation(self.m) for _ in range(nb)])
        stagger = send_order * (t_comm * scales[:, None] / self.m)
        pk_arrive = (pre_done[:, None] + stagger
                     + rng.uniform(0, cfg.net_jitter_s, (nb, self.m)))
        batch_factor = np.maximum(
            0.2, rng.lognormal(0.0, cfg.batch_cv, (nb, 1)))
        pk_time = (pk_service * scales[:, None] * batch_factor * np.maximum(
            0.2, rng.lognormal(0.0, cfg.service_cv, (nb, self.m))))
        lim = pk_service * scales[:, None] * cfg.straggler_factor
        over = pk_time > lim
        stragglers = int(over.sum())
        pk_time = np.where(over, lim + pk_service * scales[:, None], pk_time)

        sparse_done = np.empty(nb)
        if cfg.policy == SEQUENTIAL:
            # global manager: lock-step in pre-completion order
            barrier = float(fail_until["mn"].max())
            for bi in np.argsort(pre_done, kind="stable"):
                start_s = max(barrier, float(pk_arrive[bi].max()))
                done_s = start_s + float(pk_time[bi].max())
                barrier = done_s
                sparse_done[bi] = done_s
        else:
            # interleaved: per-MN processor sharing (packets of concurrent
            # queries alternate at fine grain, FCFS across packet slices)
            done_each = np.empty((nb, self.m))
            for j in range(self.m):
                done_each[:, j] = _ps_schedule(
                    pk_arrive[:, j],
                    pk_time[:, j],
                    float(fail_until["mn"][j]),
                    overhead=cfg.ps_overhead)
            sparse_done = done_each.max(axis=1)

        # ---- gather + G_D in sparse-completion order
        for bi in np.argsort(sparse_done, kind="stable"):
            i = cn_of[bi]
            g_start = max(sparse_done[bi] + 0.5 * t_comm * scales[bi],
                          gpu_free[i])
            done = g_start + t_dense * scales[bi]
            gpu_free[i] = done
            for q, _ in batches[bi][2]:
                query_parts[q] -= 1
                if query_parts[q] == 0:
                    query_done[q] = done

        lats = np.array([query_done[q] - query_arr[q]
                         for q in query_done
                         if query_arr[q] >= cfg.warmup_s])
        if len(lats) == 0:
            return SimStats(0, 0, 0, 0, 0, 0, failures=n_failures)
        horizon = cfg.duration_s - cfg.warmup_s
        return SimStats(
            throughput_qps=len(lats) / horizon,
            mean_latency=float(lats.mean()),
            p50=float(np.percentile(lats, 50)),
            p95=float(np.percentile(lats, 95)),
            p99=float(np.percentile(lats, 99)),
            completed=len(lats),
            failures=n_failures,
        )

    def latency_bounded_qps(self, sla: float, lo: float = 1.0,
                            hi: Optional[float] = None,
                            iters: int = 12) -> float:
        """Pressure test: binary-search max rate with p95 <= SLA."""
        if hi is None:
            hi = self.um.peak_qps() / QueryDist().mean_size * 2.0
        best = 0.0
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            st = self.run(mid)
            if st.p95 <= sla and st.completed > 0:
                best, lo = mid, mid
            else:
                hi = mid
        return best

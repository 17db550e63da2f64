"""Per-resource virtual timelines: the pipelined execution model.

The sequential virtual clock serialized the whole MN stage pool-wide
(one global barrier), so modeled throughput was the *sum* of stages
rather than the *bottleneck* stage — the opposite of how a production
disaggregated rack behaves (DisaggRec §IV; FlexEMR's overlapped
optimistic-get path).  This module supplies the primitives that make
pipelined overlap first-class:

:class:`ResourceClock`
    One independent FIFO queue per physical resource — a CN's
    preprocess core (``cn_cpu:i``), its back-end gather NIC
    (``cn_nic:i``), its GPU (``cn_gpu:i``), and each MN's memory bus
    (``mn_bus:j``).  A batch *books* busy intervals on the resources it
    touches; a booking starts no earlier than the resource's
    ``free_at`` (FIFO, no preemption) and the clock accumulates busy
    time, queueing delay, and the full interval list for the
    correctness battery (``tests/test_pipeline.py``).

:class:`AdmissionWindow`
    The ``ClusterConfig.inflight_depth`` gate: at most ``depth``
    batches may be inside their MN stage (scans + gather) at once.
    Admission is an order statistic over completed-stage times — batch
    i may start once at most ``depth - 1`` of the previously admitted
    batches are still in flight — which degenerates to the legacy
    global barrier at ``depth=1`` (the floor is then the max previous
    stage-done time, i.e. exactly the old ``mn_barrier``).

:class:`BatchTrace`
    One per-batch record of every interval the dispatcher booked —
    the raw material for the causality/conservation invariants.

**Depth-1 bitwise parity.**  At ``inflight_depth=1`` every resource is
idle by the time a batch reaches it (the admission floor is the
previous batch's stage-done time, which upper-bounds every bus/NIC
``free_at``), so the dispatcher takes its *wait-free* commit path: the
stage-done time is computed with the sequential clock's closed-form
gate — ``max(max_j scan_j, cache_s) + gather`` — in the same
floating-point operation order.  Parity with the pre-pipeline clock is
therefore by construction, not by rounding luck; the queued general
path only engages when a resource actually makes a batch wait, which
cannot happen at depth 1.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import clocksan


@dataclass(frozen=True)
class Interval:
    """One booked busy interval on a resource.  ``aborted`` marks the
    wasted first pass of a batch re-issued after an in-flight MN
    failure (charged up to the failure instant)."""
    start: float
    end: float
    tag: int = -1               # batch id (-1 = untagged)
    aborted: bool = False


class ResourceClock:
    """A single FIFO resource timeline.

    ``book`` records an interval the caller planned (the dispatcher
    plans a whole MN stage before committing, so a mid-stage failure
    can abort it without corrupting the clock); ``reserve`` is the
    plan-free convenience for the strictly serial stages (pre, dense).
    Causality is enforced, never silently repaired: a booking that
    starts before ``free_at`` is a dispatcher bug.
    """

    def __init__(self, name: str, free_at: float = 0.0):
        self.name = name
        self.free_at = free_at
        self.busy_s = 0.0
        self.queue_s = 0.0          # time bookings waited behind the queue
        self.bookings = 0
        self.intervals: List[Interval] = []

    def peek(self, ready_s: float) -> float:
        """Earliest start for work becoming ready at ``ready_s`` —
        without booking anything."""
        return ready_s if ready_s >= self.free_at else self.free_at

    def book(self, ready_s: float, start_s: float, end_s: float,
             tag: int = -1, aborted: bool = False) -> None:
        """Commit a planned busy interval.  ``ready_s`` is when the
        work *could* have started (start - ready is queueing delay)."""
        if clocksan.enabled():
            # pure observer, checked before any mutation: enabling the
            # sanitizer cannot perturb the simulated timeline
            clocksan.check_book(self, ready_s, start_s, end_s, tag,
                                aborted)
        if start_s < self.free_at or start_s < ready_s or end_s < start_s:
            raise AssertionError(
                f"{self.name}: booking [{start_s}, {end_s}) violates "
                f"FIFO causality (free_at={self.free_at}, "
                f"ready={ready_s})")
        self.queue_s += start_s - ready_s
        self.busy_s += end_s - start_s
        self.free_at = end_s
        self.bookings += 1
        self.intervals.append(Interval(start_s, end_s, tag, aborted))

    def reserve(self, ready_s: float, duration_s: float,
                tag: int = -1) -> Tuple[float, float]:
        """Book ``duration_s`` of work at the earliest FIFO slot;
        returns (start, end).  end = start + duration in the same
        floating-point order as the sequential clock's chain."""
        start = self.peek(ready_s)
        end = start + duration_s
        self.book(ready_s, start, end, tag)
        return start, end

    def charge_abort(self, start_s: float, upto_s: float,
                     tag: int = -1) -> None:
        """Charge the in-flight prefix of an aborted planned interval:
        the resource was genuinely busy from ``start_s`` until the
        failure at ``upto_s``.  A no-op if the work never started."""
        if upto_s <= start_s:
            return
        self.book(start_s, start_s, upto_s, tag, aborted=True)

    def __repr__(self) -> str:          # pragma: no cover - debug aid
        return (f"ResourceClock({self.name!r}, free_at={self.free_at:g}, "
                f"busy={self.busy_s:g}, queue={self.queue_s:g}, "
                f"n={self.bookings})")


class AdmissionWindow:
    """Depth-``d`` MN-stage admission: a batch may start its MN stage
    only when at most ``d - 1`` previously admitted batches are still
    inside theirs.

    The floor for the (i+1)-th batch is the (i+1-d)-th smallest of the
    previous stage-done times — an order statistic, *not* the d-th most
    recent completion, because at depth > 1 batches complete out of
    admission order.  At ``depth=1`` the floor is the max previous
    stage-done time: exactly the legacy global ``mn_barrier``.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"inflight_depth must be >= 1, got {depth}")
        self.depth = depth
        self.wait_s = 0.0           # total admission stall across batches
        self._done: List[float] = []

    def floor(self) -> float:
        """Earliest instant the next batch may start its MN stage."""
        k = len(self._done)
        if k < self.depth:
            return 0.0
        return self._done[k - self.depth]

    def complete(self, done_s: float) -> None:
        bisect.insort(self._done, done_s)


@dataclass(frozen=True)
class BatchTrace:
    """Every interval one batch booked, for the correctness battery."""
    bid: int
    task: int                       # owning CN
    size: int                       # real (unpadded) rows
    pre: Tuple[float, float]        # G_P on cn_cpu:task
    chain_ready: float              # pre done + scatter: earliest MN start
    mn_start: float                 # after admission (+ recovery stalls)
    scans: Tuple[Tuple[int, float, float], ...]   # (mn, start, end)
    gather: Tuple[float, float]     # on cn_nic:task (start == end: none)
    mn_done: float
    dense: Tuple[float, float]      # G_D on cn_gpu:task
    done: float
    reissues: int                   # in-flight MN losses this batch ate
    qids: Tuple[int, ...]           # member queries
    hedges: Tuple["HedgeIssue", ...] = ()   # straggler re-issues


@dataclass(frozen=True)
class HedgeIssue:
    """One hedged re-issue of a straggling MN scan (FlexEMR's
    optimistic get): the scan's tables re-issued on an alternate
    replica's bus at the detection instant.  Both the original and the
    hedge are charged to their buses; the batch proceeds at the first
    finisher."""
    src_mn: int                     # the straggling MN
    alt_mn: int                     # the replica bus the hedge runs on
    detect_s: float                 # when the straggle was detected
    start_s: float                  # hedge start on the alternate bus
    dur_s: float                    # hedge scan duration
    bytes_b: float                  # bytes the hedge moved (charged to alt)
    won: bool                       # hedge finished before the original

    @property
    def end_s(self) -> float:
        return self.start_s + self.dur_s


@dataclass
class MNPlan:
    """A batch's planned (not yet committed) MN stage.

    ``queued`` is True when any bus or the gather NIC would make this
    batch wait — only then does the stage-done time come from the
    general per-resource chain; otherwise it is the sequential clock's
    closed-form gate (``mn_start + t_gate``), preserving depth-1
    bitwise parity (see module docstring).  ``hedges`` (always empty
    when ``ClusterConfig.hedge_multiplier`` is 0) lists the straggler
    re-issues; a plan with hedges is always ``queued`` — the closed-
    form gate knows nothing about alternate buses.
    """
    mn_start: float
    scans: List[Tuple[int, float, float]]   # (mn, start, duration)
    t_gate: float                   # max(max scan, cache_s) + gather
    gather_ready: float             # scans done and cache probe drained
    gather_start: float
    gather_dur: float
    queued: bool
    end: float                      # planned stage-done time
    hedges: Tuple[HedgeIssue, ...] = ()


def fit_clocks(clocks: List[ResourceClock], n: int, prefix: str,
               fill: float, registry: Optional[List[ResourceClock]] = None
               ) -> List[ResourceClock]:
    """Resize a per-node clock list across an elastic resize: joining
    nodes are idle from the resize instant (``fill``); a departing
    node's clock retires with its accumulated stats (it stays in
    ``registry`` for end-of-run aggregation, mirroring how departed
    MNs retire their byte counters)."""
    if len(clocks) >= n:
        return clocks[:n]
    out = list(clocks)
    for i in range(len(clocks), n):
        c = ResourceClock(f"{prefix}:{i}", free_at=fill)
        if registry is not None:
            registry.append(c)
        out.append(c)
    return out


def summarize_resources(clocks: List[ResourceClock], makespan_s: float
                        ) -> Tuple[Dict[str, float], Dict[str, float],
                                   Dict[str, float], Dict[str, float]]:
    """Fold every clock ever created (live + retired) into per-resource
    stats keyed by name: busy seconds, queueing-delay seconds,
    utilization (busy / makespan), and occupancy ((busy + queued) /
    makespan).  A re-grown node's clock shares its predecessor's name
    and their stats sum — the name identifies the slot, not the
    incarnation.

    The returned dicts are key-sorted: accumulation runs in clock
    creation order (so the floating-point sums are reproducible against
    the per-clock fold), but the emitted mappings iterate in sorted-key
    order so serialized reports are byte-stable run to run."""
    busy: Dict[str, float] = {}
    queue: Dict[str, float] = {}
    for c in clocks:
        busy[c.name] = float(busy.get(c.name, 0.0) + c.busy_s)
        queue[c.name] = float(queue.get(c.name, 0.0) + c.queue_s)
    names = sorted(busy)
    busy = {k: busy[k] for k in names}
    queue = {k: queue[k] for k in names}
    if makespan_s > 0:
        util = {k: busy[k] / makespan_s for k in names}
        occ = {k: (busy[k] + queue[k]) / makespan_s for k in names}
    else:
        util = {k: 0.0 for k in names}
        occ = {k: 0.0 for k in names}
    return busy, queue, util, occ

"""clocksan: the opt-in runtime sanitizer for the per-resource clocks.

The depth-d pipelined execution model (``serving.pipeline``) stakes its
correctness on invariants no single call site can see whole: bookings on
a :class:`ResourceClock` are FIFO and causal, committed busy time is
conserved (``busy_s`` is exactly the sum of the committed intervals,
aborted prefixes included), and every fired timeline event lands in the
``ClusterStats.events`` audit trail.  clocksan is the race-detector
analogue: with ``REPRO_CLOCKSAN=1`` in the environment,

- :func:`check_book` runs inside every ``ResourceClock.book`` *before*
  the clock mutates — catching time-travel, starts before ready,
  FIFO/overlap violations against the actual interval list (so a
  desynced ``free_at`` cannot mask one), double-commits of an identical
  planned interval, and out-of-band mutation of the clock's accumulators
  between bookings (via a shadow copy of every counter);
- :func:`verify_run` runs post-hoc over every clock a dispatch created
  (live and retired) — re-deriving ``busy_s`` from the interval list in
  the same accumulation order (so the conservation comparison is exact,
  not epsilon), re-checking FIFO/overlap globally, cross-checking the
  per-resource dicts on ``ClusterStats``, and asserting audit-trail
  completeness (initial events + dynamically enqueued == recorded).

The sanitizer is a pure observer: it never mutates a clock and adds no
floating-point operations to the simulated timeline, so enabling it
cannot perturb the depth-1 bitwise-parity claims it exists to guard.
Violations raise :class:`ClockSanError` (an ``AssertionError`` subclass,
so existing "clock discipline is asserted" expectations hold).
"""
from __future__ import annotations

import os
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

ENV_VAR = "REPRO_CLOCKSAN"


class ClockSanError(AssertionError):
    """A clock-discipline invariant was violated at runtime."""


def enabled() -> bool:
    """Read the gate dynamically so tests can flip it per-run."""
    return os.environ.get(ENV_VAR, "") == "1"


@dataclass
class _Shadow:
    """Sanitizer-private replica of one clock's accumulators, updated in
    lock-step with every sanitized booking.  Divergence between shadow
    and clock means something mutated the clock outside ``book``."""
    free_at: float
    busy_s: float
    queue_s: float
    bookings: int
    committed: Set[Tuple[float, float, int]] = field(default_factory=set)


_shadows: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reset() -> None:
    """Drop all shadow state (test isolation)."""
    _shadows.clear()


def check_book(clock, ready_s: float, start_s: float, end_s: float,
               tag: int, aborted: bool) -> None:
    """Validate one booking against the clock's visible state and the
    sanitizer's shadow, *before* the clock mutates.  Raises
    :class:`ClockSanError`; on success, advances the shadow."""
    sh = _shadows.get(clock)
    if sh is None:
        sh = _Shadow(free_at=clock.free_at, busy_s=clock.busy_s,
                     queue_s=clock.queue_s, bookings=clock.bookings)
        _shadows[clock] = sh
    problems: List[str] = []
    if end_s < start_s:
        problems.append(
            f"time-travel: interval [{start_s}, {end_s}) ends before "
            f"it starts")
    if start_s < ready_s:
        problems.append(
            f"causality: start {start_s} precedes ready {ready_s} — "
            f"work began before its inputs existed")
    if start_s < clock.free_at:
        problems.append(
            f"FIFO: start {start_s} precedes free_at {clock.free_at} — "
            f"the resource is still busy")
    if clock.intervals and start_s < clock.intervals[-1].end:
        problems.append(
            f"overlap: start {start_s} lands inside the last committed "
            f"interval (ends {clock.intervals[-1].end}) — free_at has "
            f"desynced from the interval list")
    if not aborted and (start_s, end_s, tag) in sh.committed:
        problems.append(
            f"double-commit: interval [{start_s}, {end_s}) tag={tag} "
            f"was already committed on this clock")
    # the comparisons below are identity checks on values the sanitizer
    # itself stored — exact equality is the point, not an epsilon bug
    if clock.free_at != sh.free_at:
        problems.append(
            f"out-of-band mutation: free_at={clock.free_at} but the "
            f"shadow recorded {sh.free_at} after the last booking")
    if ((clock.busy_s, clock.queue_s, clock.bookings)
            != (sh.busy_s, sh.queue_s, sh.bookings)):
        problems.append(
            f"out-of-band mutation: (busy_s, queue_s, bookings)="
            f"({clock.busy_s}, {clock.queue_s}, {clock.bookings}) vs "
            f"shadow ({sh.busy_s}, {sh.queue_s}, {sh.bookings})")
    if problems:
        raise ClockSanError(
            f"clocksan[{clock.name}]: " + "; ".join(problems))
    if not aborted:
        sh.committed.add((start_s, end_s, tag))
    sh.free_at = end_s
    sh.busy_s = sh.busy_s + (end_s - start_s)
    sh.queue_s = sh.queue_s + (start_s - ready_s)
    sh.bookings += 1


def _fold_resources(clocks) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Recompute the per-resource busy/queue folds in the same clock
    order and accumulation order as ``pipeline.summarize_resources``,
    so the conservation comparison against ``ClusterStats`` is exact."""
    busy: Dict[str, float] = {}
    queue: Dict[str, float] = {}
    for c in clocks:
        busy[c.name] = float(busy.get(c.name, 0.0) + c.busy_s)
        queue[c.name] = float(queue.get(c.name, 0.0) + c.queue_s)
    return busy, queue


def verify_run(clocks, stats=None, audit=None,
               n_audit_expected: Optional[int] = None) -> None:
    """Post-hoc verification over every clock a dispatch created.

    ``clocks`` must be the dispatcher's creation-order registry (live
    and retired) — the same list ``summarize_resources`` folded — so the
    recomputed per-resource sums are bitwise-comparable to the ones on
    ``stats``.  Raises :class:`ClockSanError` listing every violation.
    """
    problems: List[str] = []
    for c in clocks:
        busy = 0.0
        prev_end: Optional[float] = None
        for i, iv in enumerate(c.intervals):
            if iv.end < iv.start:
                problems.append(
                    f"{c.name}: interval #{i} [{iv.start}, {iv.end}) "
                    f"ends before it starts")
            if prev_end is not None and iv.start < prev_end:
                problems.append(
                    f"{c.name}: interval #{i} starts at {iv.start}, "
                    f"inside its predecessor (ends {prev_end}) — "
                    f"FIFO/overlap violation")
            prev_end = iv.end
            busy = busy + (iv.end - iv.start)
        # conservation: busy_s accumulated one (end - start) per booking
        # in commit order; `busy` above re-adds in the identical order,
        # so equality is exact by construction, not by epsilon
        if busy != c.busy_s:  # disagglint: disable=clock-eq -- conservation recomputation in identical fp order; inequality means busy_s was mutated outside book()
            problems.append(
                f"{c.name}: busy_s={c.busy_s} but the committed "
                f"intervals (aborted prefixes included) sum to {busy} — "
                f"busy time is not conserved")
        if c.intervals and c.free_at != c.intervals[-1].end:
            problems.append(
                f"{c.name}: free_at={c.free_at} != last interval end "
                f"{c.intervals[-1].end}")
        sh = _shadows.get(c)
        if sh is not None and (
                (c.busy_s, c.queue_s, c.free_at, c.bookings)
                != (sh.busy_s, sh.queue_s, sh.free_at, sh.bookings)):
            problems.append(
                f"{c.name}: clock diverged from its shadow — "
                f"out-of-band mutation between bookings")
    # a batch's pre stage commits on exactly one CN cpu incarnation: a
    # CN shrink hands the pre off to a survivor, and the superseded
    # booking on the retired clock must be charged as an abort — a
    # second non-aborted commit of the same tag means retired busy time
    # is double-counted (phantom booking).  Scoped to cn_cpu: bus/NIC
    # clocks legitimately re-book a tag (hedges, failure re-issues).
    pre_commit: Dict[int, str] = {}
    for c in clocks:
        if not c.name.startswith("cn_cpu"):
            continue
        for iv in c.intervals:
            if iv.aborted or iv.tag < 0:
                continue
            prev = pre_commit.get(iv.tag)
            if prev is not None:
                problems.append(
                    f"{c.name}: pre stage of batch tag={iv.tag} already "
                    f"committed on {prev} — phantom booking on a "
                    f"retired CN (busy time not conserved)")
            else:
                pre_commit[iv.tag] = c.name
    if stats is not None:
        busy_f, queue_f = _fold_resources(clocks)
        if dict(stats.resource_busy_s) != busy_f:
            problems.append(
                "stats.resource_busy_s does not equal the fold of the "
                "committed intervals over all clocks (live + retired)")
        if dict(stats.resource_queue_s) != queue_f:
            problems.append(
                "stats.resource_queue_s does not equal the fold of the "
                "booked queueing delays over all clocks")
    if n_audit_expected is not None and audit is not None:
        if len(audit) != n_audit_expected:
            problems.append(
                f"audit trail has {len(audit)} records but "
                f"{n_audit_expected} events were fired (initial queue + "
                f"dynamically enqueued) — an event vanished without a "
                f"record")
    if problems:
        raise ClockSanError("clocksan: " + "\n  ".join(problems))

"""Query scheduling (paper §IV-C): sequential vs interleaved processing.

`Batcher` implements the paper's ingress behavior: large queries split
into sub-batches, small queries fused into one batch (Fig. 3a). The two
MN scheduling policies are consumed by serving/simulator.py:

interleaved: each MN serves packets FCFS independently — packets of
             different queries interleave; every in-flight query finishes
             late (head-of-line blocking across queries).
sequential:  the global task manager runs one query's packets on all MNs
             in lock step; the next query starts only when the previous
             query's embedding ops complete on every MN.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

INTERLEAVED = "interleaved"
SEQUENTIAL = "sequential"


@dataclass
class Query:
    qid: int
    arrival: float
    size: int                     # candidate items to rank
    # filled by the pipeline
    batch_id: int = -1
    done: float = -1.0


@dataclass
class Batch:
    bid: int
    queries: List[Query]
    formed_at: float
    size: int
    # (query, rows contributed) in row order — lets an engine slice each
    # query's payload rows out of the fused batch (split queries appear in
    # several batches; their contributions are consumed FIFO)
    parts: List[Tuple[Query, int]] = field(default_factory=list)
    # owning model under fleet serving (0 for single-model streams)
    model: int = 0


class Batcher:
    """Split/fuse incoming queries into fixed-size batches.

    Under fleet serving each model gets its own ingress Batcher; `model`
    tags the emitted batches and `bid_start`/`bid_step` stride the batch
    id space so ids stay globally unique across per-model batchers (the
    defaults reproduce the single-batcher id sequence exactly).
    """

    def __init__(self, batch_size: int, max_wait_s: float = 0.005,
                 model: int = 0, bid_start: int = 0, bid_step: int = 1):
        self.batch_size = batch_size
        self.max_wait = max_wait_s
        self.model = model
        self._pending: List[Tuple[Query, int]] = []   # (query, remaining)
        self._pending_since: Optional[float] = None
        self._next_bid = bid_start
        self._bid_step = bid_step

    def offer(self, q: Query, now: float) -> List[Batch]:
        """Add a query; return any batches that became full."""
        remaining = q.size
        out = []
        self._pending.append((q, remaining))
        if self._pending_since is None:
            self._pending_since = now
        while self._pending_total() >= self.batch_size:
            out.append(self._form(now))
        return out

    def flush(self, now: float) -> List[Batch]:
        """Emit a partial batch if max_wait elapsed. Compares against
        next_deadline() so `flush(next_deadline())` always fires (the
        subtraction form can miss by one ulp)."""
        deadline = self.next_deadline()
        if deadline is not None and now >= deadline:
            return [self._form(now)]
        return []

    def next_deadline(self) -> Optional[float]:
        if self._pending and self._pending_since is not None:
            return self._pending_since + self.max_wait
        return None

    def _pending_total(self) -> int:
        return sum(r for _, r in self._pending)

    def _form(self, now: float) -> Batch:
        take = self.batch_size
        members: List[Query] = []
        parts: List[Tuple[Query, int]] = []
        kept: List[Tuple[Query, int]] = []
        used = 0
        for q, rem in self._pending:
            if take <= 0:
                kept.append((q, rem))
                continue
            grab = min(rem, take)
            take -= grab
            used += grab
            members.append(q)
            parts.append((q, grab))
            if rem - grab > 0:
                kept.append((q, rem - grab))
        self._pending = kept
        # a kept remainder is fresh work: restart its flush clock at the
        # forming instant, or a long-waiting head query would leave the
        # remainder's deadline already in the past and drain loops would
        # emit degenerate partial batches instead of waiting max_wait_s
        self._pending_since = now if kept else None
        b = Batch(self._next_bid, members, now, used, parts,
                  model=self.model)
        self._next_bid += self._bid_step
        return b

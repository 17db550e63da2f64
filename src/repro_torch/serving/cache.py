"""CN-side hot-row embedding cache (FlexEMR-style; Huang et al.).

Production embedding access streams are heavily Zipf-skewed (Gupta et
al.): a small hot set of rows absorbs most lookups.  In a disaggregated
serving unit every one of those lookups otherwise pays gather bytes over
the CN's back-end NIC (the G_S stage), so each CN carves a byte budget
out of its HBM and keeps the hot rows local.  ``RowCache`` is that
budget: a per-CN, per-table row cache keyed by ``(table id, row id)``.

Policies
--------
- ``lru``: evict the least-recently-probed row.
- ``lfu``: evict the least-frequently-probed row (ties: oldest touch).

Skew awareness: the engine feeds the cache the *measured* per-table
hotness classification (``core.embedding_manager.HotnessCounter``).
Rows of hot tables outrank rows of cold tables at eviction time — a
victim is always drawn from the lowest priority class first, and a cold
row is refused admission rather than displace a hot resident — so a cold
capacity-table scan cannot flush the hot working set.

Fleet partitioning: under multi-model serving one CN cache is shared by
every model's lookup stream, so an aggressive model could flush the
others' hot rows.  ``set_partitions`` installs a per-model byte budget
(tid -> owning model, model -> budget bytes): each admission is charged
to the owning model's partition and evicts only within it, and
``rebalance`` re-installs new budgets mid-run (shrinking partitions
shed their coldest residents immediately).  Without partitions the
cache behaves exactly as before.

Coherence: the cache stores *bitwise copies* of authoritative MN rows,
so serving a hit is numerically indistinguishable from re-fetching; what
must be protocol-correct is residency.  ``invalidate_table`` drops every
row of one table (the engine calls it for exactly the tables whose
authoritative serving copy moved under ``fail_mn`` / ``recover_mn`` /
``resize`` migration) and ``flush`` clears the cache (DLRM weight
reload).  All bookkeeping is deterministic: same probe stream, same
state — the engine's bitwise-parity and determinism suites rely on it.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

POLICIES = ("lru", "lfu")


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0           # rows dropped by coherence events
    rejects: int = 0                 # admissions refused (cold vs hot set)

    @property
    def probes(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.probes if self.probes else 0.0

    def absorb(self, other: "CacheStats") -> None:
        """Fold another counter set in (retiring a departed CN's cache)."""
        self.hits += other.hits
        self.misses += other.misses
        self.evictions += other.evictions
        self.invalidations += other.invalidations
        self.rejects += other.rejects


class RowCache:
    """Byte-budgeted (table, row) cache with LRU/LFU + hot-table priority.

    Entries may carry a value (the embedding row) for content-fidelity
    tests; the engine itself passes ``value=None`` because the shard
    storage already holds the authoritative bitwise rows.
    """

    def __init__(self, capacity_bytes: int, row_bytes: int,
                 policy: str = "lru"):
        if policy not in POLICIES:
            raise ValueError(f"unknown cache policy {policy!r} "
                             f"(choose from {POLICIES})")
        if row_bytes <= 0:
            raise ValueError("row_bytes must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self.row_bytes = int(row_bytes)
        self.policy = policy
        self.stats = CacheStats()
        # entries: key -> value, in recency order (oldest first) for LRU
        self._entries: "OrderedDict[Tuple[int, int], object]" = OrderedDict()
        self._freq: Dict[Tuple[int, int], int] = {}       # lfu counters
        self._touch: Dict[Tuple[int, int], int] = {}      # last-touch tick
        self._heap: List[Tuple[int, int, int, Tuple[int, int]]] = []
        self._tick = 0
        self._hot: Optional[Set[int]] = None              # hot table ids
        self._n_by_pri = {0: 0, 1: 0}
        self._rows_by_table: Dict[int, int] = {}
        self._owner_of: Optional[Dict[int, int]] = None   # tid -> model
        self._budgets: Dict[int, int] = {}                # model -> bytes
        self._bytes_by_part: Dict[int, int] = {}

    # ------------------------------------------------------------ introspection
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[int, int]) -> bool:
        return tuple(key) in self._entries

    @property
    def size_bytes(self) -> int:
        return len(self._entries) * self.row_bytes

    def table_rows(self, tid: int) -> int:
        """Resident row count for one table."""
        return self._rows_by_table.get(tid, 0)

    def get(self, tid: int, row: int):
        """Stored value for a resident row (no stats/recency side effects)."""
        return self._entries.get((tid, row))

    # ---------------------------------------------------------------- priority
    def set_hot_tables(self, hot: Optional[Iterable[int]]) -> None:
        """Install the measured hot-table set (None = no classification:
        every table is priority 1 and the cache degenerates to plain
        LRU/LFU).  Resident entries are re-classified in place."""
        self._hot = set(hot) if hot is not None else None
        self._n_by_pri = {0: 0, 1: 0}
        for tid, _ in self._entries:
            self._n_by_pri[self._pri(tid)] += 1
        if self.policy == "lfu":        # priorities changed: rebuild heap
            self._rebuild_heap()

    def _rebuild_heap(self) -> None:
        self._heap = [(self._pri(k[0]), self._freq[k], self._touch[k], k)
                      for k in self._entries]
        heapq.heapify(self._heap)

    def _pri(self, tid: int) -> int:
        if self._hot is None:
            return 1
        return 1 if tid in self._hot else 0

    # -------------------------------------------------------------- partitions
    def _part(self, tid: int) -> Optional[int]:
        if self._owner_of is None:
            return None
        return self._owner_of.get(tid)

    def partition_bytes(self, part: int) -> int:
        """Resident bytes currently charged to one partition."""
        return self._bytes_by_part.get(part, 0)

    def set_partitions(self, owner_of: Optional[Dict[int, int]],
                       budgets: Optional[Dict[int, int]]) -> int:
        """Install per-model byte budgets (fleet serving).

        ``owner_of`` maps table id -> partition (model) id, ``budgets``
        maps partition id -> byte budget; a tid without an owner is only
        bounded by the global capacity.  ``None`` for both disables
        partitioning.  Residents are re-attributed, and any partition
        now over budget sheds rows immediately; returns rows evicted.
        """
        if (owner_of is None) != (budgets is None):
            raise ValueError("owner_of and budgets must be set together")
        self._owner_of = dict(owner_of) if owner_of is not None else None
        self._bytes_by_part = {}
        if self._owner_of is not None:
            for tid, _ in self._entries:
                p = self._part(tid)
                if p is not None:
                    self._bytes_by_part[p] = (self._bytes_by_part.get(p, 0)
                                              + self.row_bytes)
        return self.rebalance(budgets or {})

    def rebalance(self, budgets: Dict[int, int]) -> int:
        """Re-install partition budgets mid-run (the fleet rebalance
        hook): partitions shrunk below their residency shed their
        lowest-priority rows now.  Returns rows evicted."""
        self._budgets = {int(p): int(b) for p, b in budgets.items()}
        evicted = 0
        for p in sorted(self._budgets):
            budget = self._budgets[p]
            while self._bytes_by_part.get(p, 0) > budget:
                if not (self._evict_one(max_pri=0, part=p)
                        or self._evict_one(max_pri=1, part=p)):
                    break
                evicted += 1
        return evicted

    # ------------------------------------------------------------------ probes
    def probe(self, tid: int, row: int) -> bool:
        """One lookup: True on hit (recency/frequency updated)."""
        key = (tid, row)
        self._tick += 1
        if key in self._entries:
            self.stats.hits += 1
            self._touch[key] = self._tick
            if self.policy == "lru":
                self._entries.move_to_end(key)
            else:
                f = self._freq[key] + 1
                self._freq[key] = f
                heapq.heappush(self._heap,
                               (self._pri(tid), f, self._tick, key))
                # stale tuples are normally reclaimed at eviction time;
                # a hit-dominated stream (few evictions) would grow the
                # lazy heap per probe, so compact once it outnumbers the
                # residents severalfold
                if len(self._heap) > 4 * len(self._entries) + 64:
                    self._rebuild_heap()
            return True
        self.stats.misses += 1
        return False

    def lookup(self, tid: int, row: int, value=None) -> bool:
        """Serving fast path: probe, and on a miss admit the fetched row
        (fetch-on-miss).  Returns True on hit."""
        if self.probe(tid, row):
            return True
        self.admit(tid, row, value)
        return False

    # --------------------------------------------------------------- admission
    def admit(self, tid: int, row: int, value=None) -> bool:
        """Insert a row, evicting within the byte budget.  A row whose
        table outranks every candidate victim is refused (returns False)
        rather than displace the hot set."""
        key = (tid, row)
        if key in self._entries:
            self._entries[key] = value
            return True
        if self.capacity_bytes < self.row_bytes:
            self.stats.rejects += 1
            return False
        pri = self._pri(tid)
        part = self._part(tid)
        if part is not None and part in self._budgets:
            budget = self._budgets[part]
            if budget < self.row_bytes:
                self.stats.rejects += 1
                return False
            while (self._bytes_by_part.get(part, 0) + self.row_bytes
                   > budget):
                if not self._evict_one(max_pri=pri, part=part):
                    self.stats.rejects += 1
                    return False
        while self.size_bytes + self.row_bytes > self.capacity_bytes:
            if not self._evict_one(max_pri=pri):
                self.stats.rejects += 1
                return False
        self._tick += 1
        self._entries[key] = value
        self._freq[key] = 1
        self._touch[key] = self._tick
        self._n_by_pri[pri] += 1
        self._rows_by_table[tid] = self._rows_by_table.get(tid, 0) + 1
        if part is not None:
            self._bytes_by_part[part] = (self._bytes_by_part.get(part, 0)
                                         + self.row_bytes)
        if self.policy == "lfu":
            heapq.heappush(self._heap, (pri, 1, self._tick, key))
        return True

    def _evict_one(self, max_pri: int, part: Optional[int] = None) -> bool:
        """Evict one victim of priority <= max_pri; False if none exists.
        With ``part`` the victim must belong to that partition (scan-based
        selection: partitions are a fleet feature with no lazy-heap
        index, and resident counts stay small per CN)."""
        if part is not None:
            best = None
            for key in self._entries:          # recency order (oldest first)
                if self._part(key[0]) != part:
                    continue
                pri = self._pri(key[0])
                if pri > max_pri:
                    continue
                if self.policy == "lru":
                    best = key                 # oldest eligible wins
                    break
                cand = (pri, self._freq[key], self._touch[key], key)
                if best is None or cand < best:
                    best = cand
            if best is None:
                return False
            self._drop(best if self.policy == "lru" else best[3])
            self.stats.evictions += 1
            return True
        if sum(n for p, n in self._n_by_pri.items() if p <= max_pri) == 0:
            return False
        if self.policy == "lru":
            for key in self._entries:          # oldest first
                if self._pri(key[0]) <= max_pri:
                    self._drop(key)
                    self.stats.evictions += 1
                    return True
            return False
        while self._heap:                      # lfu: lazy-invalidated heap
            pri, f, tick, key = self._heap[0]
            if (key not in self._entries or pri != self._pri(key[0])
                    or f != self._freq[key] or tick != self._touch[key]):
                heapq.heappop(self._heap)      # stale entry
                continue
            if pri > max_pri:
                return False                   # heap min outranks incoming
            heapq.heappop(self._heap)
            self._drop(key)
            self.stats.evictions += 1
            return True
        return False

    def _drop(self, key: Tuple[int, int]) -> None:
        del self._entries[key]
        self._freq.pop(key, None)
        self._touch.pop(key, None)
        self._n_by_pri[self._pri(key[0])] -= 1
        tid = key[0]
        part = self._part(tid)
        if part is not None and part in self._bytes_by_part:
            left_b = self._bytes_by_part[part] - self.row_bytes
            if left_b > 0:
                self._bytes_by_part[part] = left_b
            else:
                del self._bytes_by_part[part]
        left = self._rows_by_table[tid] - 1
        if left:
            self._rows_by_table[tid] = left
        else:
            del self._rows_by_table[tid]

    # --------------------------------------------------------------- coherence
    def invalidate_table(self, tid: int) -> int:
        """Drop every resident row of one table (its authoritative copy
        moved).  Returns the number of rows invalidated."""
        if not self._rows_by_table.get(tid):
            return 0
        victims = [k for k in self._entries if k[0] == tid]
        for k in victims:
            self._drop(k)
        self.stats.invalidations += len(victims)
        return len(victims)

    def flush(self) -> int:
        """Drop everything (DLRM weight reload: all rows went stale)."""
        n = len(self._entries)
        self._entries.clear()
        self._freq.clear()
        self._touch.clear()
        self._heap.clear()
        self._n_by_pri = {0: 0, 1: 0}
        self._rows_by_table.clear()
        self._bytes_by_part.clear()
        self.stats.invalidations += n
        return n

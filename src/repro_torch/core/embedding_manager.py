"""Intelligent embedding management (paper §IV-B, Fig. 7).

Greedy **allocation**: compute nReplicas from aggregate MN capacity, then
place each table's replicas on the nReplicas MNs with the most available
capacity. Greedy **MemAccess routing**: for every (task, table), route to
the replica-holding MN with the least accumulated access bytes
(access bytes = avg pooling factor x embedding row bytes, profiled from
historical queries). The random baseline (Fig. 7d) picks both uniformly.

Failure handling (§IV-A): losing an MN re-routes to surviving replicas;
losing all replicas of any table triggers a re-initialization with backup
MNs.

Elastic resize (§III, Fig. 2b/11): `allocate_incremental` re-allocates a
grown/shrunk pool while keeping every surviving placement in place, and
`plan_migration` diffs two allocations into the minimal set of shard
copies that must cross the fabric — only tables whose placement changed
move.
"""
from __future__ import annotations

import dataclasses
import random as _random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class TableInfo:
    tid: int
    rows: int
    dim: int
    avg_pooling: float
    dtype_bytes: int = 4

    @property
    def size_bytes(self) -> int:
        return self.rows * self.dim * self.dtype_bytes

    @property
    def access_bytes(self) -> float:
        """Expected bytes touched per sample (pooling x row bytes)."""
        return self.avg_pooling * self.dim * self.dtype_bytes


@dataclass
class Allocation:
    replicas: Dict[int, List[int]]           # table id -> MN ids
    mn_used: List[int]                       # bytes allocated per MN
    n_replicas: int


@dataclass
class RoutingTable:
    # (task id, table id) -> destination MN id  (paper Fig. 7c tuple)
    routes: Dict[Tuple[int, int], int]
    mn_access: List[float]                   # accumulated access bytes/sample


class HotnessCounter:
    """Measured per-table access stream (paper §IV-B: profiled hotness).

    The engine bumps one counter per *valid* embedding lookup it serves,
    so ``measured_access_bytes`` replaces the allocator's assumed
    ``avg_pooling``-derived access profile with what the live workload
    actually touched — hot tables then prefer DDR (where the CN row
    cache can capture their traffic) and cold capacity tables prefer
    NMP, measured rather than assumed.  The same classification
    (``hot_tables``: above-median access density) feeds cache admission
    priorities.

    ``owners`` (per-tid group id, e.g. the owning model of a fleet)
    scopes the median cut per group: without it, one model's heavy
    traffic raises the global median and silently demotes every other
    model's genuinely-hot tables to cold — the classic shared-pool
    attribution bug. ``owners=None`` is the single-group (single-model)
    behavior, unchanged.
    """

    def __init__(self, n_tables: int,
                 owners: Optional[Sequence[int]] = None):
        self.lookups = [0.0] * n_tables
        if owners is not None and len(owners) != n_tables:
            raise ValueError(f"{len(owners)} owners for {n_tables} tables")
        self.owners = list(owners) if owners is not None else None

    def update(self, tids: Sequence[int], counts: Sequence[float]) -> None:
        for t, c in zip(tids, counts):
            self.lookups[t] += float(c)

    @property
    def total(self) -> float:
        return sum(self.lookups)

    def measured_access_bytes(self, tables: Sequence[TableInfo]
                              ) -> Optional[List[float]]:
        """Per-tid observed access bytes (lookups x row bytes), indexed
        by tid; None before any lookup was observed (cold start — the
        caller falls back to the assumed profile)."""
        if not self.total:
            return None
        out = [0.0] * len(self.lookups)
        for t in tables:
            out[t.tid] = self.lookups[t.tid] * t.dim * t.dtype_bytes
        return out

    def owner_totals(self, tables: Sequence[TableInfo]) -> Dict[int, float]:
        """Measured access bytes summed per owner group (0 for all tables
        when no ``owners`` were given) — the cache-budget rebalance signal."""
        out: Dict[int, float] = {}
        for t in tables:
            o = self.owners[t.tid] if self.owners is not None else 0
            out[o] = out.get(o, 0.0) + self.lookups[t.tid] * t.dim * t.dtype_bytes
        return out

    def hot_tables(self, tables: Sequence[TableInfo]) -> Optional[Set[int]]:
        """Tables with above-median measured access density (the same
        cut ``allocate_heterogeneous`` uses); None on cold start.

        With ``owners`` the median is taken within each owner group, so
        hotness is relative to the table's own model's traffic."""
        ab = self.measured_access_bytes(tables)
        if ab is None:
            return None
        hot: Set[int] = set()
        for group in _owner_groups(tables, self.owners):
            dens = sorted(ab[t.tid] / max(t.size_bytes, 1) for t in group)
            cut = dens[len(dens) // 2] if dens else 0.0
            hot |= {t.tid for t in group
                    if ab[t.tid] / max(t.size_bytes, 1) > cut}
        return hot


def _owner_groups(tables: Sequence[TableInfo],
                  owners: Optional[Sequence[int]]) -> List[List[TableInfo]]:
    """Partition tables by owner id (one group when owners is None),
    in ascending owner order for determinism."""
    if owners is None:
        return [list(tables)]
    by: Dict[int, List[TableInfo]] = {}
    for t in tables:
        by.setdefault(owners[t.tid], []).append(t)
    return [by[o] for o in sorted(by)]


def compute_n_replicas(tables: Sequence[TableInfo], capacities: Sequence[int]) -> int:
    total = sum(t.size_bytes for t in tables)
    cap = sum(capacities)
    if total == 0:
        return len(capacities)
    return max(1, min(len(capacities), int(cap // total)))


def allocate_greedy(tables: Sequence[TableInfo], capacities: Sequence[int],
                    n_replicas: Optional[int] = None) -> Allocation:
    m = len(capacities)
    nrep = n_replicas or compute_n_replicas(tables, capacities)
    used = [0] * m
    replicas: Dict[int, List[int]] = {}
    # large tables first: classic greedy bin balance
    for t in sorted(tables, key=lambda t: -t.size_bytes):
        avail = sorted(range(m), key=lambda i: capacities[i] - used[i],
                       reverse=True)[:nrep]
        for i in avail:
            used[i] += t.size_bytes
        replicas[t.tid] = sorted(avail)
    return Allocation(replicas=replicas, mn_used=used, n_replicas=nrep)


def allocate_random(tables: Sequence[TableInfo], capacities: Sequence[int],
                    n_replicas: Optional[int] = None, seed: int = 0) -> Allocation:
    rng = _random.Random(seed)
    m = len(capacities)
    nrep = n_replicas or compute_n_replicas(tables, capacities)
    used = [0] * m
    replicas: Dict[int, List[int]] = {}
    for t in tables:
        picks = rng.sample(range(m), nrep)
        for i in picks:
            used[i] += t.size_bytes
        replicas[t.tid] = sorted(picks)
    return Allocation(replicas=replicas, mn_used=used, n_replicas=nrep)


def route_greedy(tables: Sequence[TableInfo], alloc: Allocation,
                 n_tasks: int, m: int,
                 exclude: Sequence[int] = (),
                 mn_weights: Optional[Sequence[float]] = ()) -> RoutingTable:
    """Greedy MemAccess routing; `mn_weights` makes it node-type-aware.

    A weight is the relative cost of one access byte on that MN (e.g.
    base_bw / mn_bw, so a 4x-bandwidth NMP node weighs 0.25): the greedy
    pick minimizes accumulated *cost*, steering traffic toward the
    faster replica while `mn_access` keeps reporting raw bytes. Uniform
    (or omitted) weights reproduce the homogeneous behavior exactly.
    """
    w = list(mn_weights) if mn_weights else [1.0] * m
    acc = [0.0] * m                          # raw access bytes (reported)
    cost = [0.0] * m                         # weighted bytes (decision)
    routes: Dict[Tuple[int, int], int] = {}
    dead = set(exclude)
    # heaviest access streams first for tighter balance
    order = sorted(tables, key=lambda t: -t.access_bytes)
    for task in range(n_tasks):
        for t in order:
            cands = [i for i in alloc.replicas[t.tid] if i not in dead]
            if not cands:
                raise LookupError(f"table {t.tid}: all replicas failed")
            dest = min(cands, key=lambda i: cost[i])
            acc[dest] += t.access_bytes
            cost[dest] += t.access_bytes * w[dest]
            routes[(task, t.tid)] = dest
    return RoutingTable(routes=routes, mn_access=acc)


def allocate_heterogeneous(tables: Sequence[TableInfo],
                           capacities: Sequence[int],
                           mn_types: Sequence[str],
                           n_replicas: Optional[int] = None,
                           access_bytes: Optional[Sequence[float]] = None,
                           table_groups: Optional[Sequence[int]] = None
                           ) -> Allocation:
    """Node-type-aware placement for a mixed DDR/NMP pool (paper §NMP).

    Policy: *hot* tables — high access density (access bytes per byte of
    capacity) — prefer commodity DDR MNs, where re-streaming rows is
    cheap and NMP capacity is not wasted on small tables; *capacity*
    tables (the bulk of the pool, below-median density) prefer NMP MNs,
    where their dominant row traffic is pooled on-node and never crosses
    the fabric. Replicas alternate classes, so with n_replicas >= 2
    every table keeps one copy in each class: a class-wide issue cannot
    lose a table, and node-type-aware routing can arbitrage bandwidth
    between the two copies. Homogeneous pools fall back to the plain
    greedy allocator unchanged.

    ``access_bytes`` (indexed by tid, e.g. from ``HotnessCounter.
    measured_access_bytes``) replaces each table's assumed
    ``avg_pooling``-derived access profile with measured traffic, so
    the hot/cold classification follows the live workload.

    ``table_groups`` (per-tid owner id, e.g. the owning model of a
    fleet) scopes the hot/cold median cut within each group, exactly
    mirroring ``HotnessCounter.hot_tables``: a fleet's heavy model must
    not push every other model's tables below the global median and off
    DDR. One group (or None) reproduces the historical classification.
    """
    m = len(capacities)
    if len(mn_types) != m:
        raise ValueError(f"{len(mn_types)} MN types for {m} capacities")
    nmp_ids = [i for i, t in enumerate(mn_types) if "nmp" in t]
    ddr_ids = [i for i, t in enumerate(mn_types) if "nmp" not in t]
    if not nmp_ids or not ddr_ids:
        return allocate_greedy(tables, capacities, n_replicas)
    classes = {"nmp": nmp_ids, "ddr": ddr_ids}
    # clamp like allocate_greedy's avail[:nrep]: never more replicas
    # than there are MNs to hold them
    nrep = min(n_replicas or compute_n_replicas(tables, capacities), m)

    def _ab(t: TableInfo) -> float:
        return (access_bytes[t.tid] if access_bytes is not None
                else t.access_bytes)

    cuts: Dict[int, float] = {}
    for group in _owner_groups(tables, table_groups):
        dens = sorted(_ab(t) / max(t.size_bytes, 1) for t in group)
        cut = dens[len(dens) // 2] if dens else 0.0
        for t in group:
            cuts[t.tid] = cut
    used = [0] * m
    replicas: Dict[int, List[int]] = {}
    for t in sorted(tables, key=lambda t: -t.size_bytes):
        hot = _ab(t) / max(t.size_bytes, 1) > cuts[t.tid]
        pref = "ddr" if hot else "nmp"
        other = "nmp" if pref == "ddr" else "ddr"
        chosen: List[int] = []
        for r in range(nrep):
            cls = pref if r % 2 == 0 else other
            pool = [i for i in classes[cls] if i not in chosen]
            if not pool:                 # class exhausted: spill anywhere
                pool = [i for i in range(m) if i not in chosen]
            dest = max(pool, key=lambda i: capacities[i] - used[i])
            chosen.append(dest)
            used[dest] += t.size_bytes
        replicas[t.tid] = sorted(chosen)
    return Allocation(replicas=replicas, mn_used=used, n_replicas=nrep)


def allocate_fleet(tables: Sequence[TableInfo],
                   capacities: Sequence[int],
                   mn_types: Sequence[str],
                   owners: Sequence[int],
                   n_replicas: Optional[int] = None,
                   access_bytes: Optional[Sequence[float]] = None
                   ) -> Allocation:
    """Shared-table placement for a multi-model fleet on one MN pool.

    All models' tables (global tid space, ``owners[tid]`` = owning
    model) are placed together on the single pool — hot-on-DDR /
    capacity-on-NMP with the hot/cold median taken *within each model*,
    replicas class-preserving across models.  A fleet of one is exactly
    ``allocate_heterogeneous``.
    """
    if len(owners) != len(tables):
        raise ValueError(f"{len(owners)} owners for {len(tables)} tables")
    return allocate_heterogeneous(tables, capacities, mn_types,
                                  n_replicas=n_replicas,
                                  access_bytes=access_bytes,
                                  table_groups=owners)


def allocate_incremental(tables: Sequence[TableInfo],
                         capacities: Sequence[int],
                         mn_types: Sequence[str],
                         prev: Allocation,
                         n_replicas: Optional[int] = None,
                         exclude: Sequence[int] = ()) -> Allocation:
    """Minimal-movement re-allocation for an elastic pool resize.

    Every replica that still lands on a live MN of the new pool stays
    put; only replicas stranded on departed/excluded MNs are re-placed,
    and tables short of `n_replicas` (a grown pool may afford more)
    gain copies.  New copies follow the same node-type class policy as
    `allocate_heterogeneous`: in a mixed pool a table's replica set
    should keep spanning classes, so a top-up targets the class the
    surviving copies miss; within the class the most-available MN wins.
    A homogeneous pool degenerates to plain most-available placement.
    """
    m = len(capacities)
    if len(mn_types) != m:
        raise ValueError(f"{len(mn_types)} MN types for {m} capacities")
    dead = set(exclude)
    live = [i for i in range(m) if i not in dead]
    if not live:
        raise ValueError("resize leaves no live MN")
    nrep = min(n_replicas or prev.n_replicas, len(live))
    classes = {"nmp": [i for i in live if "nmp" in mn_types[i]],
               "ddr": [i for i in live if "nmp" not in mn_types[i]]}
    hetero = bool(classes["nmp"]) and bool(classes["ddr"])
    used = [0] * m
    replicas: Dict[int, List[int]] = {}
    order = sorted(tables, key=lambda t: -t.size_bytes)
    # first pass: keep every surviving placement (zero movement)
    for t in order:
        keep = [i for i in prev.replicas.get(t.tid, ())
                if i < m and i not in dead][:nrep]
        for i in keep:
            used[i] += t.size_bytes
        replicas[t.tid] = keep
    # second pass: top up stranded / newly-affordable replicas
    for t in order:
        chosen = replicas[t.tid]
        while len(chosen) < nrep:
            pool = [i for i in live if i not in chosen]
            if hetero:
                have = {("nmp" if "nmp" in mn_types[i] else "ddr")
                        for i in chosen}
                missing = [c for c in ("ddr", "nmp") if c not in have]
                if missing:
                    cls_pool = [i for c in missing for i in classes[c]
                                if i not in chosen]
                    pool = cls_pool or pool
            if not pool:
                break                        # nrep > live pool: clamp
            dest = max(pool, key=lambda i: capacities[i] - used[i])
            chosen.append(dest)
            used[dest] += t.size_bytes
        replicas[t.tid] = sorted(chosen)
    # third pass: rebalance.  A joining MN starts empty, and routing only
    # targets replica holders — without movement a grown pool would never
    # absorb load.  Shift replicas from the fullest to the emptiest MN
    # (class-preserving, so the placement policy survives) while a single
    # move still narrows the spread; each move strictly decreases
    # sum(used^2), so this terminates.
    groups = [classes["nmp"], classes["ddr"]] if hetero else [live]
    for group in groups:
        if len(group) < 2:
            continue
        while True:
            lo = min(group, key=lambda i: (used[i], i))
            hi = max(group, key=lambda i: (used[i], i))
            gap = used[hi] - used[lo]
            cands = [t for t in order
                     if hi in replicas[t.tid] and lo not in replicas[t.tid]
                     and t.size_bytes < gap]
            if not cands:
                break
            t = min(cands, key=lambda t: (abs(gap - 2 * t.size_bytes),
                                          t.tid))
            replicas[t.tid] = sorted(
                [i for i in replicas[t.tid] if i != hi] + [lo])
            used[hi] -= t.size_bytes
            used[lo] += t.size_bytes
    return Allocation(replicas=replicas, mn_used=used, n_replicas=nrep)


PARAM_STORE = -1          # migration source when no replica can stream


@dataclass
class MigrationPlan:
    """Incremental shard migration between two allocations.

    `moves` is one entry per embedding-table copy that must be created:
    (table id, source MN, destination MN).  The source is a surviving
    replica when one exists, else a departing replica being drained,
    else `PARAM_STORE` (re-streamed from the parameter store).  Dropped
    replicas are free — no bytes cross the fabric to delete a copy.
    """
    moves: List[Tuple[int, int, int]]
    dropped: List[Tuple[int, int]]           # (table id, MN) copies freed
    bytes_moved: int

    @property
    def n_moves(self) -> int:
        return len(self.moves)


def plan_migration(old: Allocation, new: Allocation,
                   tables: Sequence[TableInfo]) -> MigrationPlan:
    """Diff two allocations into the minimal copy set (elastic resize).

    Only tables whose placement changed appear in the plan; a table
    whose replica set is identical in both allocations moves nothing.
    """
    size = {t.tid: t.size_bytes for t in tables}
    moves: List[Tuple[int, int, int]] = []
    dropped: List[Tuple[int, int]] = []
    bytes_moved = 0
    for tid, new_reps in new.replicas.items():
        old_reps = list(old.replicas.get(tid, ()))
        added = [j for j in new_reps if j not in old_reps]
        removed = [j for j in old_reps if j not in new_reps]
        survivors = [j for j in old_reps if j in new_reps]
        for k, dst in enumerate(added):
            if survivors:
                src = survivors[k % len(survivors)]
            elif removed:                    # drain the departing copy
                src = removed[k % len(removed)]
            else:
                src = PARAM_STORE
            moves.append((tid, src, dst))
            bytes_moved += size.get(tid, 0)
        dropped += [(tid, j) for j in removed]
    return MigrationPlan(moves=moves, dropped=dropped,
                         bytes_moved=bytes_moved)


def route_random(tables: Sequence[TableInfo], alloc: Allocation,
                 n_tasks: int, m: int, seed: int = 0,
                 exclude: Sequence[int] = ()) -> RoutingTable:
    rng = _random.Random(seed)
    acc = [0.0] * m
    routes: Dict[Tuple[int, int], int] = {}
    dead = set(exclude)
    for task in range(n_tasks):
        for t in tables:
            cands = [i for i in alloc.replicas[t.tid] if i not in dead]
            if not cands:
                raise LookupError(f"table {t.tid}: all replicas failed")
            dest = rng.choice(cands)
            acc[dest] += t.access_bytes
            routes[(task, t.tid)] = dest
    return RoutingTable(routes=routes, mn_access=acc)


def imbalance(values: Sequence[float]) -> float:
    """max/mean load ratio (1.0 = perfectly balanced)."""
    vals = [v for v in values if v > 0] or [0.0]
    mean = sum(vals) / len(vals)
    return max(vals) / mean if mean else 1.0


def rebuild_after_failure(tables: Sequence[TableInfo], alloc: Allocation,
                          n_tasks: int, m: int,
                          failed: Sequence[int],
                          backup_capacity: int = 0):
    """MN failure handling (paper Fig. 7b).

    Returns (routing, reinitialized: bool, alloc). If every table still has
    a live replica we only re-run greedy routing over survivors; otherwise
    the serving unit re-initializes: backup MNs join and allocation is
    recomputed from scratch.
    """
    dead = set(failed)
    lost = [t for t in tables
            if all(r in dead for r in alloc.replicas[t.tid])]
    if not lost:
        routing = route_greedy(tables, alloc, n_tasks, m, exclude=failed)
        return routing, False, alloc
    # re-initialize with backups replacing dead MNs; survivors must absorb
    # the full replica set, so size their capacity for it (the old per-MN
    # usage is too small once the pool shrinks)
    live = max(1, m - len(dead))
    total = sum(t.size_bytes for t in tables)
    need = (alloc.n_replicas * total) // live + max(
        (t.size_bytes for t in tables), default=0)
    caps = [0 if i in dead else max(backup_capacity, need)
            for i in range(m)]
    new_alloc = allocate_greedy(tables, caps,
                                n_replicas=min(alloc.n_replicas, live))
    routing = route_greedy(tables, new_alloc, n_tasks, m, exclude=failed)
    return routing, True, new_alloc


def shard_assignment(alloc: Allocation, routing: RoutingTable,
                     n_tables: int, m: int, task: int = 0) -> List[List[int]]:
    """Per-MN table lists for the JAX table-sharded embedding op: the MN a
    task's lookups route to is the shard that owns the table for that task."""
    shards: List[List[int]] = [[] for _ in range(m)]
    for tid in range(n_tables):
        shards[routing.routes[(task, tid)]].append(tid)
    return shards

"""Cluster-scale disaggregated serving engine (paper §IV, Fig. 6/7/9).

The PyTorch counterpart of ``repro.serving.cluster``: the same routing,
placement, failure, elasticity, caching and virtual-clock accounting,
with the shards held as torch tensors on the device and pooled by the
hand-written CUDA bag kernels (``kernels/csrc/embedding_bag.cu``).
Everything the clock and ``ClusterStats`` read (hotness, cache probes,
scanned and shipped bytes) stays on host numpy, computed exactly as the
reference computes it, so the stats match the reference field for field.
Per batch, the lookup indices go to the device once, the pooled vectors
stay there for the dense step, and only the scores come back.

One engine serves a cluster of {n CNs, m MNs}: queries enter a shared
ingress ``Batcher`` (large queries split, small queries fused — Fig. 3a),
each batch lands on the least-loaded CN, and that CN's task id selects the
rows of the MemAccess routing table (``core.embedding_manager``) that
scatter its table lookups over the MN pool.  Every MN holds a replica
shard — the stacked tables the allocator placed on it — and the pool may
mix node types (paper §NMP, Fig. 14):

- **DDR MN**: passive remote memory — the shard's raw rows stream back to
  the owning CN (``rows x D`` gather bytes), which pools them with the
  fused CN-side bag (``kernels.ops.embedding_bag_fused_flat``).
- **NMP MN**: pools *on the memory node* with the near-memory kernel
  (``kernels.ops.embedding_bag_nmp_flat``) at NMP bandwidth;
  only pooled (B, T_j, D) Fsum vectors cross the fabric (``tables x D``
  gather bytes) and the CN skips its pooling stage for that shard.

Both paths accumulate pooling slots in the same ascending order, so a
mixed DDR+NMP deployment scores bitwise-identically to the all-DDR
baseline while moving strictly fewer gather bytes.  Placement is
node-type-aware (``core.embedding_manager.allocate_heterogeneous``: hot
tables on DDR, capacity tables on NMP, replicas spanning both classes)
and routing weighs replicas by per-node bandwidth.

Failures (§IV-A/§IV-D): ``fail_mn`` marks an MN dead and rebuilds routing
over the surviving replicas (fast path) or re-initializes the allocation
when a table lost every replica.  ``serve`` accepts timed failure events;
a failure landing inside a batch's MN stage re-issues that batch's lookups
on the survivors — no query is ever dropped.

Scenarios: ``serve`` consumes a typed event timeline — ``FailMN``,
``RecoverMN`` (timed recoveries), ``Resize``, ``ReloadParams``,
``ReplanPlacement``, ``SetWorkload`` — dispatched in global time order
by ``serving.timeline``; the declarative front door is
``serving.scenario.run_scenario(spec)``, and the legacy ``failures=`` /
``resizes=`` kwargs are bitwise-identical shims over the same queue.

Elasticity (§III, Fig. 2b/11): ``resize(n_cn, m_mn)`` grows or shrinks
either pool independently while the engine keeps serving.  MN resizes go
through the incremental migration planner
(``core.embedding_manager.allocate_incremental`` / ``plan_migration``):
surviving placements stay put, a departing MN drains its shard copies to
the survivors, a joining MN is topped up with replicas — and only the
tables whose placement changed cross the fabric.  ``serve`` consumes
timed resize events alongside failure events, charging the migration
bytes to the virtual clock as a background stream that fair-shares the
gather NIC path with the G_S stage.  Because pooling accumulates slots
in the same ascending order on every node, scores before, during, and
after any resize are bitwise-identical to a fixed-pool run.

Hot-row caching (FlexEMR; Gupta et al.): with ``cache_mb > 0`` every CN
carves a byte budget out of its HBM for a ``serving.cache.RowCache`` and
splits each MemAccess into cache **hits** — served locally, zero memory-
bus and gather bytes on the virtual clock — and **misses**, routed to
the MN pool exactly as before (miss rows are admitted on return,
LRU/LFU under ``cache_policy``, with measured hot tables outranking
cold ones at eviction time).  The numeric pooling path is unchanged:
cached rows are bitwise copies of the authoritative shard rows, and the
fused bag accumulates the merged hit+miss row set in the same ascending
slot order, so a cached engine scores **bitwise-identically** to the
uncached baseline — the cache moves bytes and time, never values.
Coherence: whenever a CN's authoritative serving copy of a table moves
(``fail_mn`` / ``recover_mn`` re-route, ``resize`` migration, a reinit's
fresh allocation), exactly that table's rows are invalidated in that
CN's cache; ``reload_params`` (DLRM weight reload) flushes everything.
NMP-routed lookups bypass the cache — their rows never cross the fabric
to begin with, which is why measured-hotness placement steers hot
tables toward DDR where the cache can capture them.

Latency accounting is wall-clock-free: a virtual clock driven by the
analytic unit model's stage times (G_P, scatter, G_S + gather from
*measured* per-MN access/gather bytes at *per-node-type* bandwidths,
G_D), so per-query latencies can be cross-validated against
``ServingUnitModel.stage_times`` and the DES (``validate_latency_model``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import embedding_manager as em
from repro_torch.core import failure as fail_mod
from repro_torch.core import hardware as hw
from repro_torch.core.hardware import NODE_TYPES
from repro_torch.core.serving_unit import ServingUnitModel, UnitSpec
from repro_torch.device import DeviceLike, require_on, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import embedding_bag_ref
from repro_torch.serving.cache import CacheStats, RowCache
from repro_torch.serving.engine import Request, Result

if TYPE_CHECKING:   # timeline imports cluster; annotation-only reverse dep
    from repro_torch.serving.timeline import EventRecord


def _fit(arr: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    """Resize a per-node accounting/clock array to `n` entries: growth
    appends `fill`, shrink drops the departing tail."""
    if len(arr) >= n:
        return arr[:n].copy()
    return np.concatenate([arr, np.full(n - len(arr), fill)])


def _validate_mn_types(types: Sequence[str], m_mn: int) -> List[str]:
    if len(types) != m_mn:
        raise ValueError(f"{len(types)} MN types for a pool of {m_mn}")
    for t in types:
        if t not in NODE_TYPES or NODE_TYPES[t].kind != "mn":
            raise ValueError(f"unknown memory-node type {t!r}")
    return list(types)


def parse_mn_types(spec: str, m_mn: int) -> List[str]:
    """Parse a CLI memory-pool spec into a per-MN node-type list.

    Accepts a single type (``"nmp_mn"`` — the whole pool), an explicit
    comma list (``"ddr_mn,ddr_mn,nmp_mn,nmp_mn"``), or counted groups
    (``"2xddr_mn+2xnmp_mn"``).  The expansion must match the pool size.
    """
    types: List[str] = []
    for part in spec.replace("+", ",").split(","):
        part = part.strip()
        if "x" in part and part.split("x", 1)[0].isdigit():
            count, name = part.split("x", 1)
            types += [name.strip()] * int(count)
        elif part:
            types.append(part)
    if len(types) == 1:
        types = types * m_mn
    return _validate_mn_types(types, m_mn)


#: batch -> CN placement policies (ClusterConfig.cn_router /
#: topology.cn_router / --cn-router); cpu_free is the bitwise-parity
#: legacy default
CN_ROUTERS = ("cpu_free", "pipeline_free", "least_outstanding")


@dataclass
class ClusterConfig:
    n_cn: int = 2                 # serving-unit compute nodes (= tasks)
    m_mn: int = 4                 # memory-node pool
    batch_size: int = 64
    max_wait_s: float = 0.002     # ingress batcher flush deadline
    n_replicas: int = 2           # embedding replication factor
    use_kernel: bool = True       # CUDA bag kernels on the hot path
    cn_type: str = "cn_1g"
    mn_type: str = "ddr_mn"       # default type for the whole pool
    mn_types: Optional[Sequence[str]] = None   # per-MN override, len m_mn
    mn_recovery_s: float = fail_mod.recovery_cost_s("mn")
    cache_mb: float = 0.0         # per-CN hot-row cache budget (CN HBM)
    cache_policy: str = "lru"     # lru | lfu
    inflight_depth: int = 1       # max batches concurrently inside the MN
                                  # stage (scans + gather) pool-wide; 1 =
                                  # the sequential clock (bitwise parity
                                  # with the pre-pipeline engine), >1 =
                                  # pipelined overlap on per-resource
                                  # FIFO queues (serving.pipeline)
    cn_router: str = "cpu_free"   # batch -> CN placement policy
                                  # (serving.timeline._route_cn):
                                  # cpu_free = earliest-free preprocess
                                  # core (legacy, bitwise parity);
                                  # pipeline_free = earliest drain of
                                  # the CN's whole cpu/nic/gpu pipeline;
                                  # least_outstanding = fewest
                                  # uncommitted bookings (JSQ).  Ties
                                  # break to the lowest index everywhere.
    hedge_multiplier: float = 0.0  # straggler mitigation (FlexEMR
                                  # optimistic get): a scan projected to
                                  # exceed hedge_multiplier x its nominal
                                  # (degradation-free) duration is
                                  # re-issued on the fastest live replica
                                  # at the detection instant — both
                                  # issues charged, first finisher wins.
                                  # 0 disables (the parity default).
    seed: int = 0                 # the stream seed this engine serves
                                  # (dlrm_request_stream convention); the
                                  # serving path itself holds no RNG, so
                                  # same-seed runs give identical stats

    def resolved_mn_types(self) -> List[str]:
        types = (list(self.mn_types) if self.mn_types is not None
                 else [self.mn_type] * self.m_mn)
        return _validate_mn_types(types, self.m_mn)


@dataclass
class ModelStats:
    """Per-model slice of a fleet run's ClusterStats (keyed by model
    name in ``ClusterStats.per_model``).  Single-model runs carry one
    entry; percentiles are nearest-rank like the cluster-wide ones."""
    queries: int
    completed: int
    p99: float                    # nan when the model completed nothing
    queue_wait_p99: float         # arrival -> admission tail, per model
    cache_hits: int               # hot-row cache hits on this model's tables
    cache_bytes_saved: float      # gather bytes those hits kept off the NIC
    sla_actions: int = 0          # Resize events this model's controller emitted


@dataclass
class ClusterStats:
    completed: int
    mean_latency: float           # nan when no query completed
    p50: float
    p95: float
    failures: int
    reroutes: int
    reinits: int
    mn_access_bytes: List[float]  # memory-bus bytes scanned per MN
    mn_gather_bytes: List[float]  # bytes each MN shipped to CNs (fabric)
    mn_types: List[str]
    imbalance: float              # max/mean access over surviving MNs
    recoveries: int = 0           # MNs brought back via recover_mn
    resizes: int = 0              # elastic resize events applied
    migration_bytes: float = 0.0  # shard bytes moved by resizes
    retired_access_bytes: float = 0.0   # departed (shrunk-away) MNs' scans
    retired_gather_bytes: float = 0.0   # ... and their shipped bytes
    p99: float = float("nan")     # tail latency (nan when nothing completed)
    reissues: int = 0             # batches re-executed after in-flight MN loss
    cache_hits: int = 0           # CN hot-row cache counters (0 = no cache)
    cache_misses: int = 0
    cache_evictions: int = 0
    cache_invalidations: int = 0  # rows dropped by coherence events
    cache_bytes_saved: float = 0.0      # gather bytes hits kept off the NIC
    # pipelined execution (serving.pipeline): per-resource timelines.
    # Resource keys are "cn_cpu:i" (G_P), "cn_nic:i" (gather),
    # "cn_gpu:i" (G_D), "mn_bus:j" (scans); a retired (shrunk-away)
    # node's clock folds into its slot's totals.
    inflight_depth: int = 1       # the depth this run was served at
    makespan_s: float = 0.0       # last batch completion on the clock
    throughput_qps: float = float("nan")   # completed / makespan
    admission_wait_s: float = 0.0  # MN-stage admission stall, all batches
    # per-query queueing delay (arrival -> batch admission, i.e. the
    # first resource start of the query's first batch).  Nearest-rank
    # p99; nan when nothing completed (the mean_latency contract).
    queue_wait_mean: float = float("nan")
    queue_wait_p99: float = float("nan")
    # straggler mitigation (hedged re-issue of slow MN scans)
    degrades: int = 0             # DegradeMN events applied
    hedges: int = 0               # scans re-issued on an alternate replica
    hedge_wins: int = 0           # hedges that finished before the original
    # SLA feedback control (serving.autoscaler.SLAController)
    sla_actions: int = 0          # Resize events the controller emitted
    sla_actions_cn: int = 0       # ... that resized the CN pool
    sla_actions_mn: int = 0       # ... that resized the MN pool
    sla_window_filled: bool = True   # False only when a controller was
                                  # attached but its p99 window never
                                  # filled (run shorter than cfg.window:
                                  # the controller silently saw nothing)
    resource_busy_s: Dict[str, float] = field(default_factory=dict)
    resource_queue_s: Dict[str, float] = field(default_factory=dict)
    resource_util: Dict[str, float] = field(default_factory=dict)
    resource_occupancy: Dict[str, float] = field(default_factory=dict)
    # multi-model fleet serving: per-model breakdown keyed by model
    # name (one entry for single-model runs — the whole-cluster numbers
    # restricted to that model's stream)
    per_model: Dict[str, ModelStats] = field(default_factory=dict)
    # per-event audit trail: serving.timeline.EventRecord entries in
    # fire order — event, fire time, resulting pool shape.  Recoveries,
    # resizes, reloads, and replans all appear here with real virtual-
    # clock timestamps instead of being untimed method calls.
    events: List["EventRecord"] = field(default_factory=list)


class ClusterEngine:
    """Serve a DLRM over {n CN, m MN} with replica-aware routing.

    Fleet serving: ``fleet`` is an optional ``[(name, model, params),
    ...]`` list (first entry = the primary ``model``/``params`` pair)
    whose members share this engine's CN and MN pools.  Every model's
    tables map into one global table-id space — model k's local table
    ``t`` is global tid ``_tbl_off[k] + t`` — so placement, routing,
    shards, hedging, and the caches all run unchanged over the union;
    only hot/cold classification and cache budgets are attributed per
    model.  The shared pool needs a uniform table shape ``(rows, dim)``
    across members (table *counts* and pooling factors may differ).  A
    fleet of one is exactly the single-model engine.

    The engine runs on ``device`` (default: the CUDA card, see
    ``repro_torch.device``); every member's ``params`` must already lie
    there."""

    def __init__(self, model, params, cfg: Optional[ClusterConfig] = None,
                 unit_model: Optional[ServingUnitModel] = None,
                 fleet: Optional[Sequence[Tuple[str, object, object]]] = None,
                 device: DeviceLike = None):
        assert model.cfg.family == "dlrm"
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg or ClusterConfig()
        self.fleet = (list(fleet) if fleet is not None
                      else [(model.cfg.name, model, params)])
        if fleet is not None and (not self.fleet
                                  or self.fleet[0][1] is not model):
            raise ValueError("fleet[0] must be the engine's primary "
                             "(model, params) pair")
        for _, _, p in self.fleet:
            require_on(p["embed"], self.device)
        self.model_names = [n for n, _, _ in self.fleet]
        self.n_models = len(self.fleet)
        r = model.cfg.dlrm
        self.R, self.D = r.rows_per_table, r.embed_dim
        self._tbl_off: List[int] = []
        self._tbl_count: List[int] = []
        self._tbl_owner: List[int] = []
        self.tables = []
        for k, (name, m, _) in enumerate(self.fleet):
            assert m.cfg.family == "dlrm"
            rk = m.cfg.dlrm
            if (rk.rows_per_table, rk.embed_dim) != (self.R, self.D):
                raise ValueError(
                    f"fleet model {name!r} has table shape "
                    f"({rk.rows_per_table}, {rk.embed_dim}); the shared "
                    f"MN pool needs the uniform shape "
                    f"({self.R}, {self.D})")
            off = len(self.tables)
            self._tbl_off.append(off)
            self._tbl_count.append(rk.num_tables)
            self._tbl_owner += [k] * rk.num_tables
            self.tables += [em.TableInfo(off + t, self.R, self.D,
                                         float(rk.avg_pooling))
                            for t in range(rk.num_tables)]
        self.T = len(self.tables)
        self._fleet_params = [p for _, _, p in self.fleet]
        self.params = (params if self.n_models == 1
                       else self._fleet_embed())
        # live pool sizes — cfg keeps the initial provisioning, these move
        # with resize()
        self.n_cn = self.cfg.n_cn
        self.m_mn = self.cfg.m_mn
        # heterogeneous pool: one node type per MN (all cfg.mn_type when
        # no per-MN override is given)
        self.mn_types = self.cfg.resolved_mn_types()
        self.mn_nmp = [NODE_TYPES[t].nmp for t in self.mn_types]
        self.mn_bw = [NODE_TYPES[t].mem_bw for t in self.mn_types]
        # per-MN bandwidth degradation (DegradeMN straggler injection):
        # MN j scans at mem_bw / mn_slow[j]; 1.0 = nominal, and a
        # multiply by 1.0 is float-exact so an all-ones pool is bitwise-
        # identical to the pre-degrade engine
        self.mn_slow = [1.0] * self.m_mn
        self._route_w = [max(self.mn_bw) / bw for bw in self.mn_bw]
        self.capacities = self._pool_capacities(self.m_mn)
        self.alloc = self._allocate(self.tables, self.capacities,
                                    self.mn_types,
                                    n_replicas=self.cfg.n_replicas)
        self.dead: Set[int] = set()
        self.routing = em.route_greedy(self.tables, self.alloc,
                                       self.n_cn, self.m_mn,
                                       mn_weights=self._route_w)
        self._build_shards()
        self.unit_model = unit_model or ServingUnitModel(
            model.cfg, UnitSpec(self.n_cn, self.cfg.cn_type,
                                self.m_mn, self.cfg.mn_type,
                                mn_types=tuple(self.mn_types)))
        # measured per-table hotness: feeds cache admission priorities
        # and re-allocation (reinit / replan) hot/cold classification.
        # Under a fleet the counter is owner-scoped, so one model's
        # traffic cannot demote another model's hot tables.
        self.hotness = em.HotnessCounter(
            self.T, owners=(self._tbl_owner if self.n_models > 1
                            else None))
        # per-CN hot-row caches + the routes their entries were fetched
        # over (the coherence protocol diffs these on every rebuild)
        self.caches: List[RowCache] = self._make_caches(self.n_cn)
        self._cache_routes: List[Dict[int, int]] = []
        self._retired_cache = CacheStats()     # departed CNs' counters
        self.cache_bytes_saved = 0.0
        # per-model cache attribution (index = fleet position)
        self.fleet_cache_hits = [0] * self.n_models
        self.fleet_cache_bytes_saved = [0.0] * self.n_models
        self._batch_cache_s = 0.0              # last batch's probe+hit time
        self._sync_caches()
        # counters / accounting
        self.failures = 0
        self.reroutes = 0
        self.reinits = 0
        self.reissues = 0
        self.recoveries = 0
        self.resizes = 0
        self.degrades = 0
        self.hedges = 0
        self.hedge_wins = 0
        # per-MN (tid, bytes) split of the most recent _execute's scans:
        # the hedging planner re-issues a straggler's tables on their
        # fastest live alternate replicas from this
        self._last_scan: Dict[int, List[Tuple[int, float]]] = {}
        self.migration_bytes = 0.0
        self.mn_access_bytes = np.zeros(self.m_mn)
        self.mn_gather_bytes = np.zeros(self.m_mn)
        self.mn_stage_s = np.zeros(self.m_mn)       # modeled G_S per MN
        self.retired_access_bytes = 0.0             # departed MNs' totals
        self.retired_gather_bytes = 0.0
        self._mn_stage_max_sum = 0.0                # per-batch gating stage
        self._n_batches = 0
        # pipelined-execution introspection: the most recent serve()
        # call's per-batch trace and resource clocks (serving.pipeline)
        self.last_trace: List = []
        self.last_resources: List = []

    def _pool_capacities(self, m_mn: int) -> List[int]:
        """Per-MN shard budget at pool size `m_mn`: the requested
        replication factor fits, with one table of slack per MN for
        greedy placement skew.  The elastic pool re-provisions this
        budget at every size, so a shrink's survivors can always absorb
        the departing shards."""
        total = sum(t.size_bytes for t in self.tables)
        cap = (math.ceil(self.cfg.n_replicas * total / m_mn)
               + self.tables[0].size_bytes)
        return [cap] * m_mn

    def _fleet_embed(self) -> Dict[str, torch.Tensor]:
        """Concatenate the fleet members' embedding banks along the table
        axis, in fleet order — global tid `_tbl_off[k] + t` indexes model
        k's local table t directly.  The concatenation is a new device
        tensor beside the members' own banks."""
        return {"embed": torch.cat(
            [p["embed"] for p in self._fleet_params], dim=0)}

    def _allocate(self, tables, capacities, mn_types, n_replicas,
                  access_bytes=None):
        """Placement dispatch: owner-scoped `allocate_fleet` for a
        multi-model pool, `allocate_heterogeneous` for a single model."""
        if self.n_models > 1:
            return em.allocate_fleet(
                tables, capacities, mn_types,
                [self._tbl_owner[t.tid] for t in tables],
                n_replicas=n_replicas, access_bytes=access_bytes)
        return em.allocate_heterogeneous(
            tables, capacities, mn_types, n_replicas=n_replicas,
            access_bytes=access_bytes)

    # ------------------------------------------------------------- shards
    def _build_shards(self) -> None:
        """Materialize each MN's replica shard: the tables the allocator
        placed on it, flattened row-wise for the bag kernels.  Each shard
        is its own device copy (a replica); the previous shards are
        released before the new ones are built."""
        embed = self.params["embed"]                      # (T, R, D)
        self._shard_tids: List[List[int]] = []
        self._shard_slot: List[Dict[int, int]] = []
        self._shard_flat: List[torch.Tensor] = []
        for j in range(self.m_mn):
            tids = sorted(t for t, reps in self.alloc.replicas.items()
                          if j in reps)
            self._shard_tids.append(tids)
            self._shard_slot.append({t: s for s, t in enumerate(tids)})
            if len(tids) * self.R > np.iinfo(np.int32).max:
                raise ValueError(
                    f"MN {j}'s shard holds {len(tids) * self.R} rows: the "
                    f"bag kernels address a shard's tables by int32 row "
                    f"offsets")
            if tids:
                sel = torch.tensor(tids, dtype=torch.long,
                                   device=embed.device)
                flat = embed.index_select(0, sel).reshape(
                    len(tids) * self.R, self.D)
            else:
                flat = embed.new_zeros((0, self.D))
            self._shard_flat.append(flat)

    # ------------------------------------------------------------- caching
    def _make_caches(self, n_cn: int) -> List[RowCache]:
        if self.cfg.cache_mb <= 0:
            return []
        budget = int(self.cfg.cache_mb * 1e6)
        caches = [RowCache(budget, self.D * 4, self.cfg.cache_policy)
                  for _ in range(n_cn)]
        if self.n_models > 1:
            owner_of = {tid: o for tid, o in enumerate(self._tbl_owner)}
            budgets = self._cache_budgets(budget)
            for c in caches:
                c.set_partitions(owner_of, budgets)
        return caches

    def _cache_budgets(self, budget: int) -> Dict[int, int]:
        """Split one CN's cache byte budget across fleet members in
        proportion to their measured access bytes (equal split on a cold
        counter).  The remainder after integer division goes to model 0."""
        totals = self.hotness.owner_totals(self.tables)
        grand = sum(totals.values())
        if grand <= 0.0:
            budgets = {k: budget // self.n_models
                       for k in range(self.n_models)}
        else:
            budgets = {k: int(budget * (totals.get(k, 0.0) / grand))
                       for k in range(self.n_models)}
        budgets[0] += budget - sum(budgets.values())
        return budgets

    def rebalance_cache_budgets(self) -> int:
        """Re-split every CN cache's partition budgets to the current
        per-model traffic mix; returns rows evicted to fit the new
        budgets.  No-op for a single-model engine."""
        if self.n_models <= 1 or not self.caches:
            return 0
        budgets = self._cache_budgets(int(self.cfg.cache_mb * 1e6))
        return sum(c.rebalance(budgets) for c in self.caches)

    def _sync_caches(self) -> None:
        """Coherence: after any routing rebuild, invalidate in each CN's
        cache exactly the tables whose authoritative serving copy (the
        MN this CN's lookups route to) moved — rows of unmoved tables
        survive.  Also refreshes the measured hot-table admission set."""
        if not self.caches:
            return
        hot = self.hotness.hot_tables(self.tables)
        for task, cache in enumerate(self.caches):
            new = {tid: self.routing.routes[(task, tid)]
                   for tid in range(self.T)}
            old = (self._cache_routes[task]
                   if task < len(self._cache_routes) else {})
            for tid in range(self.T):
                if old.get(tid) != new[tid]:
                    cache.invalidate_table(tid)
            if task < len(self._cache_routes):
                self._cache_routes[task] = new
            else:
                self._cache_routes.append(new)
            cache.set_hot_tables(hot)

    def _refresh_hot_tables(self) -> None:
        """Install the current measured hot-table classification into
        every CN cache.  Runs on coherence syncs AND periodically during
        healthy serving (`run_batch`), so the admission priority tracks
        the live workload instead of waiting for a failure/resize."""
        if not self.caches:
            return
        hot = self.hotness.hot_tables(self.tables)
        for cache in self.caches:
            cache.set_hot_tables(hot)

    def _cache_serve(self, cache: RowCache, tids: Sequence[int],
                     sub: np.ndarray) -> int:
        """Probe one DDR shard's lookup stream through a CN cache in
        deterministic order (table-ascending, then batch-row-major slot
        order); misses are admitted fetch-on-miss.  Returns hits."""
        hits = 0
        lookup = cache.lookup
        for k, tid in enumerate(tids):
            rows = sub[:, k, :].ravel()
            for row in rows[rows >= 0].tolist():
                if lookup(tid, row):
                    hits += 1
        return hits

    def cache_stats(self) -> CacheStats:
        """Aggregate cache counters over live CNs + retired (shrunk-away)
        CN caches."""
        cs = CacheStats()
        for c in self.caches:
            cs.absorb(c.stats)
        cs.absorb(self._retired_cache)
        return cs

    def reload_params(self, params) -> None:
        """DLRM weight reload: every authoritative row changed, so the
        MN shards re-materialize and every CN cache flushes."""
        require_on(params["embed"], self.device)
        self.params = params
        if self.n_models == 1:
            self._fleet_params = [params]
        self._build_shards()
        for cache in self.caches:
            cache.flush()

    def reload_seed(self, seed: Optional[int]) -> None:
        """Seeded weight reload (the ReloadParams event): re-initialize
        every fleet member's parameters from `seed` on the engine's
        device (None keeps current weights but still forces the shard
        rebuild + cache flush)."""
        if seed is None:
            self.reload_params(self.params)
        elif self.n_models == 1:
            self.reload_params(self.model.init(seed, device=self.device))
        else:
            self._fleet_params = [m.init(seed, device=self.device)
                                  for _, m, _ in self.fleet]
            self.reload_params(self._fleet_embed())

    def replan_placement(self) -> None:
        """Re-run node-type-aware placement with *measured* hotness (the
        serve-path counters) instead of the assumed ``avg_pooling``
        profile: hot tables migrate toward DDR MNs — where the CN cache
        can capture their traffic — and cold capacity tables toward NMP.
        Placement only targets live MNs (a replica parked on a dead node
        would silently shrink the effective replication factor), and
        routing rebuilds / caches invalidate per the moved routes."""
        live = [j for j in range(self.m_mn) if j not in self.dead]
        sub = self._allocate(
            self.tables,
            [self.capacities[j] for j in live],
            [self.mn_types[j] for j in live],
            n_replicas=min(self.cfg.n_replicas, len(live)),
            access_bytes=self.hotness.measured_access_bytes(self.tables))
        mn_used = [0] * self.m_mn
        for i, j in enumerate(live):
            mn_used[j] = sub.mn_used[i]
        self.alloc = em.Allocation(
            replicas={tid: sorted(live[i] for i in reps)
                      for tid, reps in sub.replicas.items()},
            mn_used=mn_used, n_replicas=sub.n_replicas)
        self.routing = em.route_greedy(self.tables, self.alloc,
                                       self.n_cn, self.m_mn,
                                       exclude=sorted(self.dead),
                                       mn_weights=self._route_w)
        self._build_shards()
        self._sync_caches()
        # a replan is also the natural moment to re-split the per-model
        # cache byte budgets to the measured traffic mix (no-op single)
        self.rebalance_cache_budgets()

    # ------------------------------------------------------------ failure
    def fail_mn(self, j: int) -> None:
        """Kill MN `j`: re-route to surviving replicas, or re-initialize
        the shard allocation if some table lost its last replica."""
        if not 0 <= j < self.m_mn:
            raise ValueError(f"MN id {j} outside pool of {self.m_mn}")
        if j in self.dead:
            return
        self.dead.add(j)
        self.failures += 1
        lost = any(all(r in self.dead for r in self.alloc.replicas[t.tid])
                   for t in self.tables)
        if lost:
            # §IV-A re-initialization: some table lost its last replica, so
            # standby backup MNs take over the failed slots and replicas
            # are restored from the parameter store — the pool returns to
            # full strength under a fresh allocation
            self.reinits += 1
            self.dead.clear()
            self.alloc = self._allocate(
                self.tables, self.capacities, self.mn_types,
                n_replicas=self.cfg.n_replicas,
                access_bytes=self.hotness.measured_access_bytes(self.tables))
            self.routing = em.route_greedy(self.tables, self.alloc,
                                           self.n_cn, self.m_mn,
                                           mn_weights=self._route_w)
            self._build_shards()
        else:
            self.reroutes += 1
            self.routing = em.route_greedy(self.tables, self.alloc,
                                           self.n_cn, self.m_mn,
                                           exclude=sorted(self.dead),
                                           mn_weights=self._route_w)
        self._sync_caches()

    def recover_mn(self, j: int) -> None:
        """Bring a failed MN back: its shard is still materialized (or was
        rebuilt by a reinit), so recovery is a routing rebuild only."""
        if not 0 <= j < self.m_mn:
            raise ValueError(f"MN id {j} outside pool of {self.m_mn}")
        if j not in self.dead:
            return
        self.dead.discard(j)
        self.recoveries += 1
        self.routing = em.route_greedy(self.tables, self.alloc,
                                       self.n_cn, self.m_mn,
                                       exclude=sorted(self.dead),
                                       mn_weights=self._route_w)
        self._sync_caches()

    def degrade_mn(self, j: int, factor: float = 1.0) -> bool:
        """Slow MN `j`'s memory bus by `factor` (>= 1.0; 1.0 restores
        nominal speed) — straggler injection for the hedged re-issue
        path.  Routing, placement, and scores are untouched: only the
        virtual clock's scan durations move.  Returns whether the
        slowdown state actually changed (an identity degrade is a
        recorded no-op, mirroring identity resizes)."""
        if not 0 <= j < self.m_mn:
            raise ValueError(f"MN id {j} outside pool of {self.m_mn}")
        if factor < 1.0:
            raise ValueError(f"degrade factor must be >= 1.0, "
                             f"got {factor!r}")
        changed = float(factor) != self.mn_slow[j]
        self.mn_slow[j] = float(factor)
        if changed:
            self.degrades += 1
        return changed

    # --------------------------------------------------------- elasticity
    def resize(self, n_cn: Optional[int] = None, m_mn: Optional[int] = None,
               mn_type: Optional[str] = None) -> em.MigrationPlan:
        """Grow/shrink either pool independently (paper §III, Fig. 2b/11).

        MN grow: the joining MNs (of `mn_type`, default the config's pool
        type) start empty and the incremental allocator tops replicas up
        onto them.  MN shrink: the highest-numbered MNs depart, draining
        their shard copies to the survivors first (the migration plan's
        moves) so no table ever loses availability.  CN resize holds no
        embedding state — it only rebalances the routing rows across the
        new task count.  Scores are bitwise-invariant across any resize:
        placement decides WHERE a table pools, never the slot
        accumulation order.

        Returns the migration plan; `serve` charges its bytes to the
        virtual clock as a background stream contending with the G_S
        gather path.
        """
        new_n = self.n_cn if n_cn is None else int(n_cn)
        new_m = self.m_mn if m_mn is None else int(m_mn)
        if new_n < 1 or new_m < 1:
            raise ValueError(
                f"cannot resize to {{n_cn={new_n}, m_mn={new_m}}}")
        if (new_n, new_m) == (self.n_cn, self.m_mn):
            return em.MigrationPlan(moves=[], dropped=[], bytes_moved=0)
        plan = em.MigrationPlan(moves=[], dropped=[], bytes_moved=0)
        if new_m != self.m_mn:
            if new_m > self.m_mn:
                add = mn_type or self.cfg.mn_type
                new_types = self.mn_types + [add] * (new_m - self.m_mn)
            else:
                new_types = self.mn_types[:new_m]
            new_types = _validate_mn_types(new_types, new_m)
            caps = self._pool_capacities(new_m)
            dead = {j for j in self.dead if j < new_m}
            new_alloc = em.allocate_incremental(
                self.tables, caps, new_types, prev=self.alloc,
                n_replicas=self.cfg.n_replicas, exclude=sorted(dead))
            plan = em.plan_migration(self.alloc, new_alloc, self.tables)
            if new_m < self.m_mn:
                # departing MNs retire their accumulated byte counters
                self.retired_access_bytes += float(
                    self.mn_access_bytes[new_m:].sum())
                self.retired_gather_bytes += float(
                    self.mn_gather_bytes[new_m:].sum())
            self.mn_access_bytes = _fit(self.mn_access_bytes, new_m)
            self.mn_gather_bytes = _fit(self.mn_gather_bytes, new_m)
            self.mn_stage_s = _fit(self.mn_stage_s, new_m)
            self.alloc = new_alloc
            self.mn_types = new_types
            self.mn_nmp = [NODE_TYPES[t].nmp for t in new_types]
            self.mn_bw = [NODE_TYPES[t].mem_bw for t in new_types]
            # joining MNs scan at nominal speed; a departing MN takes
            # its slowdown with it
            self.mn_slow = (self.mn_slow[:new_m]
                            + [1.0] * (new_m - len(self.mn_slow)))
            self._route_w = [max(self.mn_bw) / bw for bw in self.mn_bw]
            self.capacities = caps
            self.dead = dead
            self.m_mn = new_m
            self._build_shards()
        if new_n != self.n_cn and self.caches:
            if new_n < self.n_cn:
                # a departing CN retires its cache with its counters
                for cache in self.caches[new_n:]:
                    self._retired_cache.absorb(cache.stats)
                self.caches = self.caches[:new_n]
                self._cache_routes = self._cache_routes[:new_n]
            else:
                self.caches += self._make_caches(new_n - self.n_cn)
        self.n_cn = new_n
        self.routing = em.route_greedy(self.tables, self.alloc,
                                       self.n_cn, self.m_mn,
                                       exclude=sorted(self.dead),
                                       mn_weights=self._route_w)
        self._sync_caches()
        self.unit_model = ServingUnitModel(
            self.model.cfg, UnitSpec(self.n_cn, self.cfg.cn_type,
                                     self.m_mn, self.cfg.mn_type,
                                     mn_types=tuple(self.mn_types)))
        self.resizes += 1
        self.migration_bytes += plan.bytes_moved
        return plan

    # ------------------------------------------------------ real compute
    def _mn_pool(self, j: int, tids: Sequence[int],
                 idx_sub: torch.Tensor) -> torch.Tensor:
        """Pool MN j's routed tables — on-node for NMP, CN-side for DDR.

        An NMP MN reduces each bag locally with the near-memory kernel
        and ships only pooled vectors; a DDR MN ships raw rows, which
        the owning CN pools with the fused multi-table bag.  Both
        accumulate slots in ascending order, so the scores are bitwise
        independent of the pool's node-type mix.  ``idx_sub`` lies on
        the engine's device; the result (B, T_j, D) fp32 stays there.
        """
        slots = np.asarray([self._shard_slot[j][t] for t in tids], np.int32)
        if self.cfg.use_kernel:
            offsets = torch.from_numpy(slots * np.int32(self.R)).to(
                self.device)
            bag = (ops.embedding_bag_nmp_flat if self.mn_nmp[j]
                   else ops.embedding_bag_fused_flat)
            return bag(self._shard_flat[j], offsets, idx_sub)
        sel = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        stack = self._shard_flat[j].reshape(-1, self.R, self.D).index_select(
            0, sel)
        return embedding_bag_ref(stack, idx_sub)

    def _execute(self, task: int, dense: np.ndarray, idx: np.ndarray,
                 model: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Scatter -> per-MN pooling -> gather -> DenseNet.

        Returns (scores, per-MN memory-bus bytes scanned, per-MN gather
        bytes shipped to the CN).  For a DDR MN the two are equal (raw
        rows cross the fabric); an NMP MN scans the same rows locally
        but ships only ``valid rows x T_j x D`` pooled bytes.

        With a CN cache, each DDR MemAccess splits into hits — served
        from the CN's resident copy, charged to neither the MN bus nor
        the fabric — and misses, routed (and admitted) as before.  The
        pooling math is untouched: cache rows are bitwise copies, so
        the fused bag over the merged hit+miss set in ascending slot
        order IS the uncached computation, and only the byte/time
        accounting moves.

        The batch's indices go to the device once; each MN's pooled
        vectors land in one device buffer, and only the scores return
        to the host.  The byte accounting reads the host copy of
        ``idx``, exactly as the reference does.

        `model` selects the fleet member the batch belongs to: `idx` is
        indexed by the model's *local* table ids, its lookups touch only
        the model's global-tid slice, and the dense step runs that
        member's parameters.  Model 0 of a single-model engine is the
        single-model path bit-for-bit (the slice is the whole pool)."""
        off = self._tbl_off[model]
        Tm = self._tbl_count[model]
        shards = em.shard_assignment(self.alloc, self.routing, self.T,
                                     self.m_mn, task)
        B = dense.shape[0]
        idx_dev = torch.from_numpy(idx).to(self.device)
        pooled = torch.zeros((B, Tm, self.D), dtype=torch.float32,
                             device=self.device)
        mem_j = np.zeros(self.m_mn)
        gat_j = np.zeros(self.m_mn)
        row_b = self.D * 4
        cache = self.caches[task] if self.caches else None
        batch_probes = 0
        batch_hit_bytes = 0.0
        self._last_scan = {}
        for j, tids in enumerate(shards):
            # restrict this MN's shard slice to the owning model's tables
            mtids = [t for t in tids if off <= t < off + Tm]
            if not mtids:
                continue
            if j in self.dead:          # stale routing — never expected
                raise LookupError(f"routing targets dead MN {j}")
            cols = [t - off for t in mtids]
            cols_dev = torch.tensor(cols, dtype=torch.long,
                                    device=self.device)
            out = self._mn_pool(j, mtids, idx_dev.index_select(1, cols_dev))
            pooled.index_copy_(1, cols_dev, out.float())
            sub = idx[:, cols, :]
            per_table = (sub >= 0).sum(axis=(0, 2))
            self._last_scan[j] = [(int(t), float(pt) * row_b) for t, pt
                                  in zip(mtids, per_table.tolist())]
            self.hotness.update(mtids, per_table)
            nvalid = int(per_table.sum())
            if cache is not None and not self.mn_nmp[j]:
                hits = self._cache_serve(cache, mtids, sub)
                mem_j[j] = float(nvalid - hits) * row_b
                gat_j[j] = mem_j[j]
                self.cache_bytes_saved += float(hits) * row_b
                # every tid in mtids belongs to `model`, so the whole
                # shard's hits attribute to it without a per-tid split
                self.fleet_cache_hits[model] += hits
                self.fleet_cache_bytes_saved[model] += float(hits) * row_b
                batch_probes += nvalid
                batch_hit_bytes += float(hits) * row_b
            elif self.mn_nmp[j]:
                mem_j[j] = float(nvalid) * row_b
                live_rows = int((sub >= 0).any(axis=(1, 2)).sum())
                gat_j[j] = float(live_rows * len(mtids)) * row_b
            else:
                mem_j[j] = float(nvalid) * row_b
                gat_j[j] = mem_j[j]
        # probe tags + hit rows stream from CN HBM on the virtual clock
        self._batch_cache_s = ((batch_probes * hw.CACHE_TAG_BYTES
                                + batch_hit_bytes) / hw.CN_HBM_BW)
        dense_dev = torch.from_numpy(dense).to(self.device)
        member = self.fleet[model][1]
        scores = torch.sigmoid(member.dense_forward(
            self._fleet_params[model], dense_dev, pooled))
        return scores.cpu().numpy(), mem_j, gat_j

    # ---------------------------------------------------------- serving
    def serve(self, requests: List[Request],
              failures: Sequence[Tuple[float, int]] = (),
              resizes: Sequence[Tuple[float, int, int]] = (),
              events: Sequence = (),
              controller=None,
              controllers=None,
              ) -> Tuple[List[Result], ClusterStats]:
        """Serve a request stream under a typed event timeline.

        ``events`` is a sequence of ``serving.scenario`` events
        (``FailMN``, ``RecoverMN``, ``Resize``, ``ReloadParams``,
        ``ReplanPlacement``, ``SetWorkload``) consumed in global time
        order by ``serving.timeline.TimelineDispatcher`` — see that
        module for the ordering and batch-boundary/mid-stage semantics,
        and ``serving.scenario.run_scenario`` for the declarative front
        door that also builds the stream.

        The legacy kwargs are thin shims kept bitwise-identical:
        ``failures=[(time_s, mn_id), ...]`` becomes ``FailMN`` events
        and ``resizes=[(time_s, n_cn, m_mn), ...]`` becomes ``Resize``
        events (failures first at equal times — the historical
        tie-break).  Failure/recovery ids are validated against the
        schedule-aware *maximum* pool, so a failure scheduled after a
        timed grow is accepted.

        ``controller`` is an optional SLA feedback controller
        (``serving.autoscaler.SLAController``): the dispatcher feeds it
        every completion (virtual finish time, measured latency) and
        enqueues whatever ``Resize`` events it emits into the live
        timeline — the declarative front door builds one when
        ``ScenarioSpec.sla_p99_s`` is set.  ``controllers`` is the fleet
        form — a ``{model_index: SLAController}`` dict giving each fleet
        member its own latency window and SLA target over the shared
        pool (mutually exclusive with ``controller``).

        Execution is real PyTorch on the device; time is a virtual clock
        advanced with the analytic stage model, so latencies are
        deterministic and comparable to ServingUnitModel / ClusterSim."""
        from repro_torch.serving.timeline import TimelineDispatcher, legacy_events
        evs = legacy_events(failures, resizes) + list(events or ())
        return TimelineDispatcher(self, requests, evs,
                                  controller=controller,
                                  controllers=controllers).run()

    # ------------------------------------------------------- validation
    def validate_latency_model(self) -> Dict[str, float]:
        """Unloaded single-batch latency: engine clock vs analytic model.

        The engine's virtual clock uses the analytic stage times for
        G_P/comm-in/G_D but *measured* per-MN access + gather bytes at
        per-node-type bandwidths for the G_S + gather stage, so the
        ratio engine/analytic isolates how far the observed pooling,
        routing imbalance, and node-type mix sit from the analytic
        model's uniform near-memory-reduction assumption (~1 when the
        workload matches cfg.avg_pooling on a homogeneous pool; > 1 on
        DDR pools, whose raw-row gather the analytic Fsum-only comm
        model undercounts — by construction the very bytes an NMP pool
        saves).  `engine_mn_stage_s` vs `analytic_mn_stage_s` compares
        the memory+gather stage in isolation (the NMP regression tests
        pin this band)."""
        st = self.unit_model.stage_times(self.cfg.batch_size)
        analytic = st.total()
        analytic_mn = st.t_sparse + st.t_comm_out
        mn_measured = (self._mn_stage_max_sum / self._n_batches
                       if self._n_batches else 0.0)
        # the analytic cross-check models an UNLOADED single batch: no
        # query waits for admission, so the queue-wait term is exactly
        # 0.0 by construction.  The assert pins that contract — if the
        # queueing-delay accounting ever leaks a nonzero term into this
        # path, the engine/analytic ratio would silently shift.
        queue_wait_s = 0.0
        assert queue_wait_s == 0.0, (
            "validate_latency_model assumes zero queueing; the "
            "unloaded-path queue-wait term must be exactly 0.0")
        engine = (st.t_pre + st.t_comm_in + queue_wait_s + mn_measured
                  + st.t_dense)
        return {"analytic_s": analytic, "engine_s": engine,
                "ratio": engine / analytic if analytic else 1.0,
                "engine_mn_stage_s": mn_measured,
                "analytic_mn_stage_s": analytic_mn,
                "queue_wait_s": queue_wait_s,
                "mn_stage_ratio": (mn_measured / analytic_mn
                                   if analytic_mn else 1.0)}

    @property
    def batches_seen(self) -> int:
        return self._n_batches

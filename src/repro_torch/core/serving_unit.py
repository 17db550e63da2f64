"""Serving-unit performance/cost model (paper §IV-A, §V).

A serving unit is {n CNs, m MNs} (disaggregated) or n monolithic servers.
The analytic model produces stage latencies, peak and latency-bounded
throughput (hill-climbing pressure test, §III-C), power and capex — the
inputs QPS_{M,S} / Power_{M,S} to the failure-aware allocator (§IV-D).

Stage model (per query of `q` samples):
  G_P  preprocess  : hash ops on CN/host CPUs
  comm (indices)   : CN -> MNs scatter over back-end NICs / UPI
  G_S  SparseNet   : table scans at MN memory bandwidth (near-memory
                     reduction: only pooled Fsum returns)
  comm (Fsum)      : MNs -> CN gather
  G_D  DenseNet    : MLPs+interaction on CN GPUs

Queries pipeline across stages; latency-bounded QPS sweeps (batch, rate)
like the paper's pressure test, with an M/D/1-style queueing estimate
validated by the discrete-event simulator (serving/simulator.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs import counting
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hardware as hw
from repro_torch.core.hardware import NODE_TYPES, NodeType


@dataclass(frozen=True)
class UnitSpec:
    """{n CNs, m MNs} or (n monolithic servers, m=0).

    `mn_types` makes the MN pool heterogeneous: one node-type name per
    MN (length m), e.g. ("ddr_mn", "ddr_mn", "nmp_mn", "nmp_mn").  When
    omitted every MN is `mn_type`, reproducing the homogeneous model
    bit-for-bit.
    """
    n: int
    cn_type: str
    m: int = 0
    mn_type: str = "ddr_mn"
    scheme: str = "disagg"        # disagg | distributed | su_naive | su_numa
    mn_types: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.mn_types is not None:
            object.__setattr__(self, "mn_types", tuple(self.mn_types))
            if len(self.mn_types) != self.m:
                raise ValueError(
                    f"mn_types has {len(self.mn_types)} entries for m={self.m}")

    @property
    def cn(self) -> NodeType:
        return NODE_TYPES[self.cn_type]

    @property
    def mn(self) -> NodeType:
        return NODE_TYPES[self.mn_type]

    def mn_node_types(self) -> Tuple[NodeType, ...]:
        names = self.mn_types or (self.mn_type,) * self.m
        return tuple(NODE_TYPES[t] for t in names)

    def capex(self) -> float:
        return (self.n * self.cn.capex
                + sum(mn.capex for mn in self.mn_node_types()))

    def power(self) -> float:
        return (self.n * self.cn.power
                + sum(mn.power for mn in self.mn_node_types()))

    def nodes(self) -> int:
        return self.n + self.m

    def mem_capacity(self) -> float:
        return (self.n * self.cn.mem_capacity
                + sum(mn.mem_capacity for mn in self.mn_node_types()))


@dataclass
class StageTimes:
    t_pre: float
    t_comm_in: float
    t_sparse: float
    t_comm_out: float
    t_dense: float

    def total(self) -> float:
        return (self.t_pre + self.t_comm_in + self.t_sparse
                + self.t_comm_out + self.t_dense)

    def bottleneck(self) -> float:
        return max(self.t_pre, self.t_comm_in + self.t_comm_out,
                   self.t_sparse, self.t_dense)


class ServingUnitModel:
    def __init__(self, model: ModelConfig, unit: UnitSpec,
                 routing_imbalance: float = 1.0):
        assert model.family == "dlrm"
        self.model = model
        self.unit = unit
        self.imbalance = max(1.0, routing_imbalance)
        r = model.dlrm
        self.sparse_bytes = counting.dlrm_sparse_bytes(model)
        self.dense_flops = counting.dlrm_dense_flops(model)
        self.idx_bytes = r.num_tables * r.avg_pooling * 4
        self.fsum_bytes = r.num_tables * r.embed_dim * 4
        self.hash_ops = r.num_tables * r.avg_pooling
        self.size_bytes = counting.dlrm_size_bytes(model)

    # ------------------------------------------------------------ checks
    def fits(self) -> bool:
        return self.unit.mem_capacity() >= self.size_bytes

    def _sparse_bw_latency(self) -> float:
        """Aggregate bandwidth serving one batch's embedding scan."""
        u = self.unit
        if u.scheme == "su_naive":
            per_socket = 1.0 / (0.5 / hw.NUMA_LOCAL_BW + 0.5 / hw.NUMA_REMOTE_BW)
            return 2 * per_socket
        if u.scheme == "su_numa":
            return 2 * hw.LOCAL_MEM_BW
        if u.scheme == "distributed":
            return u.n * u.cn.mem_bw
        return sum(mn.mem_bw for mn in u.mn_node_types())

    def _cn_cores(self) -> int:
        cn = self.unit.cn
        cores = (hw.ICELAKE_CORES if "icelake" in cn.cpus
                 else hw.COOPERLAKE_CORES) // 2        # half: G_P thread
        if self.unit.scheme in ("su_naive", "su_numa"):
            cores *= len(cn.cpus)
        return cores

    # ------------------------------------------------------- stage times
    def stage_times(self, batch: int) -> StageTimes:
        """Latency of ONE batch through ONE CN's pipeline (MNs shared)."""
        u = self.unit
        t_pre = batch * self.hash_ops / (self._cn_cores() * hw.CPU_PREPROC_RATE)
        t_sparse = batch * self.sparse_bytes * self.imbalance / self._sparse_bw_latency()
        if u.scheme == "su_naive":
            t_comm_in = t_comm_out = 0.0
        else:
            comm_bw = hw.UPI_BW if u.scheme == "su_numa" else hw.NIC_BW
            t_comm_in = batch * self.idx_bytes / comm_bw
            t_comm_out = batch * self.fsum_bytes / comm_bw
        gpus = max(u.cn.gpus, 1)
        t_dense = batch * self.dense_flops / (gpus * hw.A100_EFF_FLOPS)
        return StageTimes(t_pre, t_comm_in, t_sparse, t_comm_out, t_dense)

    # -------------------------------------------------------- throughput
    def capacities(self) -> Dict[str, float]:
        """Aggregate per-resource capacity (samples/s): n CN streams run
        concurrently, the MN pool (or server memory) is shared."""
        u = self.unit
        n = 1 if u.scheme in ("su_naive", "su_numa") else u.n
        cap = {
            "pre": n * self._cn_cores() * hw.CPU_PREPROC_RATE / self.hash_ops,
            "sparse": self._sparse_bw_latency()
                      / (self.sparse_bytes * self.imbalance),
            "dense": n * max(u.cn.gpus, 1) * hw.A100_EFF_FLOPS
                     / max(self.dense_flops, 1),
        }
        if u.scheme != "su_naive":
            comm_bw = hw.UPI_BW if u.scheme == "su_numa" else hw.NIC_BW
            cap["comm"] = n * comm_bw / (self.idx_bytes + self.fsum_bytes)
        return cap

    def peak_qps(self, batch: int = 256) -> float:
        """Pipelined peak (samples/s) over all CN streams."""
        return min(self.capacities().values())

    def latency(self, batch: int, rate: float) -> float:
        """Mean query latency at arrival rate `rate` (samples/s):
        M/D/1-ish wait on the bottleneck resource + pipeline traversal."""
        st = self.stage_times(batch)
        cap = self.peak_qps(batch)
        rho = min(rate / cap, 0.9999)
        wait = rho / (2.0 * (1.0 - rho)) * (batch / cap)
        batching_delay = 0.5 * batch / max(rate, 1e-9)
        return min(batching_delay, 0.05) + wait + st.total()

    def p95_latency(self, batch: int, rate: float) -> float:
        # heavy-tailed query sizes push p95 ~3x the mean wait (calibrated
        # against the DES); pipeline time is deterministic.
        st = self.stage_times(batch)
        cap = self.peak_qps(batch)
        rho = min(rate / cap, 0.9999)
        wait95 = 3.0 * rho / (2.0 * (1.0 - rho)) * (batch / cap)
        batching_delay = 0.5 * batch / max(rate, 1e-9)
        return min(batching_delay, 0.05) + wait95 + st.total()

    def latency_bounded_qps(self, sla: float = 0.1,
                            batches=(32, 64, 128, 256, 512, 1024, 2048),
                            ) -> Tuple[float, int]:
        """Paper's hill-climbing pressure test: sweep batch sizes; for each,
        binary-search the max rate with p95 <= SLA; return the best."""
        best, best_b = 0.0, 0
        for b in batches:
            if self.stage_times(b).total() > sla:
                continue
            lo, hi = 0.0, self.peak_qps(b)
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if self.p95_latency(b, mid) <= sla:
                    lo = mid
                else:
                    hi = mid
            if lo > best:
                best, best_b = lo, b
        return best, best_b


def sequential_vs_interleaved_gain() -> float:
    """Documented paper claim (Fig. 8b): sequential scheduling sustains
    ~28% higher latency-bounded throughput; the DES reproduces this."""
    return 0.28

"""Hardware constants: paper Tables I/II + measured bandwidths (§III).

All prices are the paper's public market prices; the MN ASIC price is not
given in the paper — we model it at $1.5K (documented assumption; its
power is the paper's 23.9 W figure).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

# ------------------------------------------------------------ paper Table II
DEVICE_PRICE = {                     # USD
    "icelake": 4_500.0,
    "cooperlake": 2_500.0,
    "a100": 13_500.0,
    "ddr4_16gb": 80.0,
    "ddr4_64gb": 350.0,
    "nmp_64gb": 700.0,               # assumed 2x DDR (paper Table II)
    "nic": 2_500.0,
    "mn_asic": 1_500.0,              # modeled (not in Table II)
}

DEVICE_TDP_W = {
    "icelake": 270.0,
    "cooperlake": 86.0,
    "a100": 400.0,
    "ddr4_16gb": 5.0,
    "ddr4_64gb": 24.0,
    "nmp_64gb": 24.0,
    "nic": 20.0,
    "mn_asic": 23.9,
}

# --------------------------------------------------- measured bandwidths §III
LOCAL_MEM_BW = 145e9                 # B/s per socket, peak
NUMA_LOCAL_BW = 93e9                 # B/s achieved local half (Fig. 4b)
NUMA_REMOTE_BW = 52e9                # B/s achieved via UPI (Fig. 4b)
UPI_BW = 55e9
NIC_BW = 25e9                        # back-end RDMA, ~200Gbps ConnectX-6
NMP_SPEEDUP = 4.0                    # DIMM- + rank-level parallelism
# CN-side hot-row cache lives in the accelerator's HBM (A100 40GB class);
# probe + hit service run at this bandwidth on the virtual clock
CN_HBM_BW = 1.555e12
CACHE_TAG_BYTES = 16                 # per-probe tag/metadata traffic
# sustained dense-MLP FLOP/s: ranking MLPs are low-arithmetic-intensity
# (batch <= a few hundred rows); ~8% of peak is typical (calibrated so
# RM2's DenseNet binds GPUs, reproducing Fig. 10/13's compute regime)
A100_EFF_FLOPS = 25e12
CPU_PREPROC_RATE = 1.0e8             # hash ops/s/core (calibrated, G_P)
ICELAKE_CORES = 40
COOPERLAKE_CORES = 26

ELECTRICITY_RATE = 0.10 / 3.6e6      # USD per Joule ($0.10/kWh)
LIFETIME_YEARS = 3.0

# daily machine failure rates (Fig. 9 / §VI-C)
FAIL_GPU_SERVER = 0.07               # monolithic (follows least-reliable part)
FAIL_CN = 0.07
FAIL_MN = 0.0004
LOAD_VARIANCE_R = 0.05               # R% over-provision for load variance

# ------------------------------------------------------------------- nodes


@dataclass(frozen=True)
class NodeType:
    name: str
    kind: str                        # mono | cn | mn
    cpus: Tuple[str, ...] = ()
    gpus: int = 0
    dimms: Dict[str, int] = field(default_factory=dict)
    nics: int = 1
    asic: bool = False
    nmp: bool = False                # near-memory processing (pools on-node)
    mem_bw: float = LOCAL_MEM_BW     # embedding-scan bandwidth
    mem_capacity: float = 0.0        # bytes usable for embeddings

    @property
    def capex(self) -> float:
        c = sum(DEVICE_PRICE[x] for x in self.cpus)
        c += self.gpus * DEVICE_PRICE["a100"]
        c += sum(n * DEVICE_PRICE[d] for d, n in self.dimms.items())
        c += self.nics * DEVICE_PRICE["nic"]
        if self.asic:
            c += DEVICE_PRICE["mn_asic"]
        return c

    @property
    def power(self) -> float:
        p = sum(DEVICE_TDP_W[x] for x in self.cpus)
        p += self.gpus * DEVICE_TDP_W["a100"]
        p += sum(n * DEVICE_TDP_W[d] for d, n in self.dimms.items())
        p += self.nics * DEVICE_TDP_W["nic"]
        if self.asic:
            p += DEVICE_TDP_W["mn_asic"]
        return p


TB = 1024 ** 4
GB = 1024 ** 3


def _mk(name, **kw) -> NodeType:
    return NodeType(name=name, **kw)


NODE_TYPES: Dict[str, NodeType] = {
    # monolithic scale-up: 2 sockets, 2TB, 8 GPUs
    "su2s": _mk("su2s", kind="mono", cpus=("icelake", "icelake"), gpus=8,
                dimms={"ddr4_64gb": 32}, nics=2,
                mem_bw=2 * LOCAL_MEM_BW, mem_capacity=1.8 * TB),
    # monolithic scale-out: 1 socket, 1TB, 1/2/4 GPUs
    "so1s_1g": _mk("so1s_1g", kind="mono", cpus=("icelake",), gpus=1,
                   dimms={"ddr4_64gb": 16}, nics=3,
                   mem_bw=LOCAL_MEM_BW, mem_capacity=0.9 * TB),
    "so1s_2g": _mk("so1s_2g", kind="mono", cpus=("icelake",), gpus=2,
                   dimms={"ddr4_64gb": 16}, nics=3,
                   mem_bw=LOCAL_MEM_BW, mem_capacity=0.9 * TB),
    "so1s_4g": _mk("so1s_4g", kind="mono", cpus=("icelake",), gpus=4,
                   dimms={"ddr4_64gb": 16}, nics=3,
                   mem_bw=LOCAL_MEM_BW, mem_capacity=0.9 * TB),
    # NMP variants of monolithic scale-out
    "so1s_1g_nmp": _mk("so1s_1g_nmp", kind="mono", cpus=("icelake",), gpus=1,
                       dimms={"nmp_64gb": 16}, nics=3, nmp=True,
                       mem_bw=NMP_SPEEDUP * LOCAL_MEM_BW, mem_capacity=0.9 * TB),
    "so1s_4g_nmp": _mk("so1s_4g_nmp", kind="mono", cpus=("icelake",), gpus=4,
                       dimms={"nmp_64gb": 16}, nics=3, nmp=True,
                       mem_bw=NMP_SPEEDUP * LOCAL_MEM_BW, mem_capacity=0.9 * TB),
    # disaggregated compute nodes
    "cn_1g": _mk("cn_1g", kind="cn", cpus=("cooperlake",), gpus=1,
                 dimms={"ddr4_16gb": 4}, nics=2, mem_capacity=0),
    "cn_4g": _mk("cn_4g", kind="cn", cpus=("cooperlake",), gpus=4,
                 dimms={"ddr4_16gb": 4}, nics=2, mem_capacity=0),
    # disaggregated memory nodes
    "ddr_mn": _mk("ddr_mn", kind="mn", asic=True,
                  dimms={"ddr4_64gb": 16}, nics=1,
                  mem_bw=LOCAL_MEM_BW, mem_capacity=0.95 * TB),
    "nmp_mn": _mk("nmp_mn", kind="mn", asic=True, nmp=True,
                  dimms={"nmp_64gb": 16}, nics=1,
                  mem_bw=NMP_SPEEDUP * LOCAL_MEM_BW, mem_capacity=0.95 * TB),
}


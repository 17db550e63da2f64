"""The one generator of DLRM request traffic, driven by a mix file.

A mix (``traffic/<name>.json``) fixes the parameters: request sizes
(lognormal around a mean, capped), row indices (``"uniform"`` over each
table's rows, the only kind drawn), bag lengths (lognormal around
``center_frac`` x P, clipped to [1, P], the rest of the bag padded with
-1), arrivals (Poisson at a rate in samples per second) and the size of
the payload pool.  The semantics follow the
port's ``data/queries.dlrm_batch``, rewritten to draw from
``torch.Generator``s seeded with the run's seed.

Set-up draws a pool of ``pool_samples`` samples on the device in a few
large calls and moves it to the host once (requests carry numpy
payloads).  Chunks of requests are then cut from a stream of sizes and
arrivals drawn on the host: each chunk holds exactly
``batches x batch_size`` samples, so every batch of a serve call fills,
and its requests take consecutive slices of the pool, wrapping at its
end.  The window serves the chunks and makes no traffic.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

#: the run's seed streams: the parameters, the pool (both on the
#: device), the sizes and arrivals of the window's chunks and of the
#: warm-up's (on the host), and the correctness sample
PARAM_STREAM, POOL_STREAM, CHUNK_STREAM, WARMUP_STREAM, CHECK_STREAM = range(5)


def seeded(seed: int, stream: int, device="cpu") -> torch.Generator:
    """A generator for one of the run's streams, seeded with a hash of
    ``seed`` (any whole number) and the stream id: the CPU generator
    keeps only a seed's low 32 bits, so every bit is mixed into them."""
    h = hashlib.blake2b(f"{int(seed)}/{stream}".encode(), digest_size=8)
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return g


@dataclass
class Pool:
    dense: np.ndarray       # (N, F) float32
    indices: np.ndarray     # (N, T, P) int32, -1 padded


@dataclass
class Chunk:
    offsets: List[int]      # each request's first sample in the pool
    sizes: List[int]
    arrivals: List[float]   # virtual seconds from the serve call's start

    @property
    def samples(self) -> int:
        return sum(self.sizes)


def make_pool(mix: dict, cfg: dict, seed: int, device) -> Pool:
    """``mix['pool_samples']`` samples of dense features and -1 padded
    bags for config ``cfg``, drawn on ``device`` from ``seed``."""
    if mix["indices"] != "uniform":
        raise ValueError(f"the generator draws uniform rows, not "
                         f"{mix['indices']!r}")
    n = int(mix["pool_samples"])
    T, P = cfg["num_tables"], cfg["avg_pooling"]
    g = seeded(seed, POOL_STREAM, device)
    dense = torch.randn((n, cfg["num_dense_features"]), generator=g,
                        device=device, dtype=torch.float32)
    idx = torch.randint(0, cfg["rows_per_table"], (n, T, P), generator=g,
                        device=device, dtype=torch.int32)
    bl = mix["bag_length"]
    center = math.log(max(P * float(bl["center_frac"]), 1.0))
    lens = torch.empty((n, T), device=device, dtype=torch.float64)
    lens.log_normal_(center, float(bl["sigma"]), generator=g)
    lens.clamp_(1, P)
    keep = torch.arange(P, device=device)[None, None, :] < lens[..., None]
    idx.masked_fill_(~keep, -1)
    return Pool(dense.cpu().numpy(), idx.cpu().numpy())


def make_chunks(mix: dict, seed: int, chunk_samples: int, n_chunks: int,
                pool_samples: int, stream: int = CHUNK_STREAM) -> List[Chunk]:
    """``n_chunks`` chunks of exactly ``chunk_samples`` samples each,
    from one host stream of sizes and Poisson arrivals."""
    sz, arr = mix["sizes"], mix["arrival"]
    if sz["dist"] != "lognormal" or arr["process"] != "poisson":
        raise ValueError(f"the generator draws lognormal sizes and poisson "
                         f"arrivals, not {sz['dist']!r} / {arr['process']!r}")
    cap = int(sz["max"])
    if cap > pool_samples:
        raise ValueError("a request may not be larger than the pool")
    g = seeded(seed, stream)
    sigma = float(sz["sigma"])
    mu = math.log(float(sz["mean"])) - 0.5 * sigma ** 2
    req_rate = float(arr["rate_samples_per_s"]) / float(sz["mean"])
    # at most one request a sample: draw that many once, use a prefix
    n = n_chunks * chunk_samples
    sizes = torch.empty(n, dtype=torch.float64).log_normal_(
        mu, sigma, generator=g).ceil_().clamp_(1, cap).to(torch.int64)
    gaps = torch.empty(n, dtype=torch.float64).exponential_(
        req_rate, generator=g)
    sizes, gaps = sizes.tolist(), gaps.tolist()
    chunks, k, off = [], 0, 0
    for _ in range(n_chunks):
        c = Chunk([], [], [])
        left, t = chunk_samples, 0.0
        while left > 0:
            s = min(sizes[k], left)
            t += gaps[k]
            k += 1
            if off + s > pool_samples:
                off = 0
            c.offsets.append(off)
            c.sizes.append(s)
            c.arrivals.append(t)
            off += s
            left -= s
        chunks.append(c)
    return chunks

"""Query workload generation (paper Fig. 2).

- Heavy-tailed query-size distribution (Fig. 2a): lognormal, most queries
  small, a long tail of large ranking requests.
- Poisson arrivals modulated by the diurnal load curve (Fig. 2b).
- Arrival processes (:class:`ArrivalProcess`): request streams may be
  ``linear`` (the historical evenly-spaced stream, byte-for-byte), or
  realistic — ``poisson`` (exponential inter-arrival gaps at mean
  ``gap_s``), ``bursty`` (a two-state burst/lull modulation of the
  Poisson stream, Gupta et al.'s production traffic shape), or ``trace``
  (replay absolute timestamps from a JSON file).
- Preprocessing (G_P): hashing raw sparse features to table indices.
- Zipf-skewed row popularity (Gupta et al.: production embedding access
  streams concentrate on a small hot set): ``alpha > 0`` draws table
  indices from a truncated Zipf over the row space instead of uniform
  hashing, giving CN-side caches a hot set to exploit.

Everything is seeded and wall-clock-free.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class QueryDist:
    mean_size: float = 64.0
    sigma: float = 1.0          # lognormal shape: heavy tail
    max_size: int = 4096
    alpha: float = 0.0          # Zipf row-popularity skew (0 = uniform)

    def sample(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        mu = np.log(self.mean_size) - 0.5 * self.sigma ** 2
        s = rng.lognormal(mu, self.sigma, size=n)
        return np.clip(np.ceil(s), 1, self.max_size).astype(np.int64)


def poisson_arrivals(rate_qps: float, duration_s: float,
                     rng: np.random.RandomState) -> np.ndarray:
    """Arrival timestamps over [0, duration)."""
    n = rng.poisson(rate_qps * duration_s)
    return np.sort(rng.uniform(0.0, duration_s, size=n))


# ------------------------------------------------------ arrival processes
ARRIVALS = ("linear", "poisson", "bursty", "trace")

# bursty process shape: geometric burst/lull episode lengths (in
# arrivals), mean episode length in arrivals
BURST_EPISODE_MEAN = 8.0


def _arrival_seed(seed: int) -> int:
    """Derive the arrival-stream seed from the workload seed.  The
    arrival RNG is a *separate* stream from the size/payload RNG so
    switching ``linear`` -> ``poisson`` never perturbs the sampled
    query contents (and ``linear``, which consumes no randomness,
    stays byte-for-byte identical to the historical streams)."""
    return int((int(seed) * 2654435761 + 0x9E37) % (1 << 31))


def load_trace(path: str) -> List[float]:
    """Load a JSON arrival trace: either a bare list of absolute
    timestamps or ``{"arrivals": [...]}``.  Timestamps are sorted and
    must be finite and >= 0."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("arrivals")
    if not isinstance(data, list) or not all(
            isinstance(t, (int, float)) and not isinstance(t, bool)
            for t in data):
        raise ValueError(f"{path}: arrival trace must be a JSON list of "
                         f"timestamps (or {{'arrivals': [...]}})")
    out = sorted(float(t) for t in data)
    if out and (not np.isfinite(out[0]) or out[0] < 0
                or not np.isfinite(out[-1])):
        raise ValueError(f"{path}: trace timestamps must be finite and >= 0")
    return out


class ArrivalProcess:
    """Seeded per-phase arrival-time generator for the four processes:

    - ``linear``: evenly spaced at ``gap_s`` from the phase start (the
      historical stream; the first arrival of every phase lands exactly
      on the declared phase start).
    - ``poisson``: exponential inter-arrival gaps with mean ``gap_s``
      from the phase start.
    - ``bursty``: a two-state Markov-modulated Poisson stream — bursts
      draw gaps at ``gap_s / burstiness``, lulls at
      ``gap_s * burstiness``, with geometric episode lengths (mean
      ``BURST_EPISODE_MEAN`` arrivals), so the long-run mean rate stays
      near ``1 / gap_s`` while the short-run rate swings.
    - ``trace``: replay absolute timestamps (``trace`` list or a JSON
      file via :func:`load_trace`); ``realign`` is a no-op — a trace is
      absolute, phases only re-shape the query contents.  A trace
      shorter than the request count extends linearly at ``gap_s``
      past its last timestamp.

    ``realign(t_start, gap_s)`` starts a new phase: subsequent arrivals
    are generated from ``t_start`` under the new gap.  Callers pop one
    candidate with :meth:`next`; a candidate discarded because a phase
    change fired before it is simply regenerated after ``realign`` (the
    stochastic processes burn the discarded draw — deterministic either
    way, since everything hangs off one seeded ``RandomState``).
    """

    def __init__(self, kind: str, gap_s: float, seed: int = 0,
                 burstiness: float = 4.0,
                 trace: Optional[List[float]] = None):
        if kind not in ARRIVALS:
            raise ValueError(f"unknown arrival process {kind!r} "
                             f"(known: {ARRIVALS})")
        if kind == "trace" and trace is None:
            raise ValueError("trace arrivals need a trace "
                             "(list or loaded file)")
        if burstiness < 1.0:
            raise ValueError(f"burstiness must be >= 1.0, "
                             f"got {burstiness!r}")
        self.kind = kind
        self.gap_s = float(gap_s)
        self.burstiness = float(burstiness)
        self.trace = list(trace) if trace is not None else None
        self.rng = (np.random.RandomState(_arrival_seed(seed))
                    if kind in ("poisson", "bursty") else None)
        self._base_t = 0.0      # current phase start
        self._i = 0             # arrivals generated in this phase
        self._t = 0.0           # last generated arrival (stochastic)
        self._k = 0             # trace cursor
        self._burst = True      # bursty: current episode state
        self._left = 0          # bursty: arrivals left in the episode

    def realign(self, t_start: float, gap_s: float) -> None:
        """Start a new phase at ``t_start`` with inter-arrival ``gap_s``.

        For a trace the timestamps are absolute, so the clock doesn't
        move — but the caller's discard-and-regenerate protocol (a
        candidate popped before the phase change fired is thrown away
        and :meth:`next` called again) must not drop a trace arrival:
        the cursor rewinds one step so the pending candidate is
        re-delivered.  ``gap_s`` still updates (it shapes the past-end
        linear extension)."""
        self.gap_s = float(gap_s)
        if self.kind == "trace":
            self._k = max(0, self._k - 1)
            return
        self._base_t = float(t_start)
        self._t = float(t_start)
        self._i = 0

    def _episode_gap(self) -> float:
        """Bursty: the current episode's mean gap, advancing the
        two-state machine one arrival."""
        if self._left <= 0:
            self._burst = not self._burst
            self._left = 1 + int(self.rng.geometric(
                1.0 / BURST_EPISODE_MEAN))
        self._left -= 1
        return (self.gap_s / self.burstiness if self._burst
                else self.gap_s * self.burstiness)

    def next(self) -> float:
        """Generate the next arrival timestamp (non-decreasing within a
        phase; across phases, non-decreasing whenever ``realign`` targets
        a time at or after every arrival already emitted — which
        ``plan_workload`` guarantees by popping a phase change only once
        the candidate arrival reaches it)."""
        if self.kind == "linear":
            t = self._base_t + self.gap_s * self._i
            self._i += 1
            return t
        if self.kind == "trace":
            if self._k < len(self.trace):
                t = self.trace[self._k]
            else:       # past the trace end: extend linearly at gap_s
                last = self.trace[-1] if self.trace else 0.0
                t = last + self.gap_s * (self._k - len(self.trace) + 1)
            self._k += 1
            return t
        mean = (self._episode_gap() if self.kind == "bursty"
                else self.gap_s)
        self._t = self._t + (self.rng.exponential(mean) if mean > 0
                             else 0.0)
        return self._t


def hash_features(raw: np.ndarray, num_rows: int, salt: int = 0) -> np.ndarray:
    """G_P: map raw sparse ids to table row indices (multiplicative hash)."""
    x = raw.astype(np.uint64) * np.uint64(2654435761) + np.uint64(salt)
    x ^= x >> np.uint64(16)
    return (x % np.uint64(num_rows)).astype(np.int32)


# truncated-Zipf CDFs are pure functions of (num_rows, alpha): memoize so
# per-request batch generation doesn't recompute a row-space-sized cumsum
_ZIPF_CDF: Dict[Tuple[int, float], np.ndarray] = {}


def zipf_row_cdf(num_rows: int, alpha: float) -> np.ndarray:
    """CDF of a truncated Zipf over ranks 1..num_rows: P(k) ~ 1/k^alpha."""
    key = (int(num_rows), float(alpha))
    cdf = _ZIPF_CDF.get(key)
    if cdf is None:
        w = 1.0 / np.arange(1, num_rows + 1, dtype=np.float64) ** alpha
        cdf = np.cumsum(w)
        cdf /= cdf[-1]
        _ZIPF_CDF[key] = cdf
    return cdf


def zipf_indices(rng: np.random.RandomState, shape, num_rows: int,
                 alpha: float) -> np.ndarray:
    """Zipf-skewed row indices: rank k (0 = hottest row) drawn with
    probability ~ 1/(k+1)^alpha via inverse-CDF sampling.  Row id == rank,
    so the hot set of every table is its low row ids — a deterministic,
    seed-stable convention the cache/placement layers can be tested
    against."""
    u = rng.uniform(size=shape)
    return np.searchsorted(zipf_row_cdf(num_rows, alpha), u,
                           side="right").astype(np.int32)


def dlrm_batch(cfg, batch: int, rng: np.random.RandomState,
               pooling_sigma: float = 0.3, alpha: float = 0.0):
    """Synthetic click-log batch for a DLRM config: dense features,
    per-table pooled index lists (-1 padded), labels.

    ``alpha > 0`` switches index generation from uniform hashing to a
    truncated Zipf over each table's rows (the skewed production access
    pattern); ``alpha = 0`` keeps the exact uniform-hash RNG stream of
    earlier revisions, so seeded goldens are unaffected."""
    r = cfg.dlrm
    dense = rng.randn(batch, r.num_dense_features).astype(np.float32)
    P = r.avg_pooling
    if alpha > 0.0:
        idx = zipf_indices(rng, (batch, r.num_tables, P),
                           r.rows_per_table, alpha)
    else:
        raw = rng.randint(0, 1 << 31, size=(batch, r.num_tables, P))
        idx = hash_features(raw, r.rows_per_table)
    # variable pooling: mask out a lognormal-distributed tail per bag
    lens = np.clip(rng.lognormal(np.log(max(P * 0.7, 1.0)), pooling_sigma,
                                 size=(batch, r.num_tables)), 1, P)
    mask = np.arange(P)[None, None, :] < lens[..., None]
    idx = np.where(mask, idx, -1).astype(np.int32)
    labels = rng.binomial(1, 0.2, size=batch).astype(np.int32)
    return {"dense": dense, "indices": idx, "labels": labels}


def dlrm_request_stream(cfg, n: int, seed: int = 0,
                        dist: QueryDist = None,
                        gap_s: float = 0.002,
                        arrival: str = "linear",
                        burstiness: float = 4.0,
                        trace: Optional[List[float]] = None) -> List[Tuple]:
    """Standard seeded DLRM request stream: (rid, payload, size, arrival)
    tuples ready to splat into ``serving.engine.Request``.

    One explicit ``np.random.RandomState(seed)`` drives sizes and
    payloads — the single sanctioned way for benches/launchers to build
    engine workloads, so two builds from the same seed are identical
    (``ClusterConfig.seed`` threads the same convention through the
    engine).  ``dist.alpha`` selects the Zipf row-popularity skew;
    ``arrival`` selects the :class:`ArrivalProcess` (the arrival RNG is
    a separate derived stream, so every process yields byte-identical
    payloads — only the timestamps move, and ``linear`` reproduces the
    historical ``gap_s * i`` spacing bit-for-bit)."""
    rng = np.random.RandomState(seed)
    qd = dist or QueryDist(mean_size=8.0, max_size=64)
    proc = ArrivalProcess(arrival, gap_s, seed=seed,
                          burstiness=burstiness, trace=trace)
    sizes = qd.sample(rng, n)
    reqs = []
    for i, s in enumerate(sizes):
        b = dlrm_batch(cfg, int(s), rng, alpha=qd.alpha)
        reqs.append((i, {"dense": b["dense"], "indices": b["indices"]},
                     int(s), proc.next()))
    return reqs


def lm_batch(vocab: int, batch: int, seq: int, rng: np.random.RandomState):
    """Synthetic token stream (zipf-ish unigram) for LM train smoke."""
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class ShardedLoader:
    """Deterministic per-host data sharding: host i of k reads every k-th
    batch (the standard multi-pod input pipeline contract)."""

    def __init__(self, gen_fn, host_id: int = 0, num_hosts: int = 1,
                 seed: int = 0):
        self.gen = gen_fn
        self.host = host_id
        self.k = num_hosts
        self.seed = seed

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            rng = np.random.RandomState(
                (self.seed * 9973 + step * self.k + self.host) % (1 << 31))
            yield self.gen(rng)
            step += 1

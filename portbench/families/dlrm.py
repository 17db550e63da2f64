"""DLRM cells: the port's ``ClusterEngine.serve`` scoring CTR requests.

``Session`` does a cell's set-up: the parameters, drawn on the device
from the seed in the port's layout (``embed`` (T, R, D), ``proj``
(T, K), ``bottom``/``top`` ``w{i}`` and ``b{i}``); the payload pool and
the chunks of requests (``generator``); the engine (``ClusterConfig`` from
the cell's file); and a warm-up serve of the cell's own batch shape.
``serve(i)`` is one call of ``ClusterEngine.serve`` on chunk ``i``;
the session keeps each call's results and its ``ClusterStats``
(``stats``, one a call of the window) for the check and the readers.
Set-up's first phase, ``program_imports``, times the port's imports.

With ``trace`` the session wraps, on its own engine and model objects
only, ``ClusterEngine._execute``, ``ClusterEngine._mn_pool`` and
``DLRMModel.dense_forward`` in ``torch.profiler.record_function`` spans
(``portbench.execute``, ``portbench.mn_pool.<ddr|nmp>``,
``portbench.dense_forward``) and host clocks, and counts each bag
launch's work.  The untraced run wraps nothing.

``check()`` runs after the program's state is freed: it draws the
parameters again from the seed, and holds the scores that the timed
serve calls returned, for a sample of requests drawn from the seed,
against ``reference.scores``.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import generator, reference

#: distinct chunks of requests built at set-up; the window cycles them
N_CHUNKS = 64

SPAN_EXECUTE = "portbench.execute"
SPAN_DENSE = "portbench.dense_forward"
SPAN_POOL = "portbench.mn_pool."


def _layers(dims, gen, device) -> Dict[str, torch.Tensor]:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = _normal((a, b), 1.0 / math.sqrt(a), gen, device)
        out[f"b{i}"] = _normal((b,), 0.01, gen, device)
    return out


def _normal(shape, std, gen, device) -> torch.Tensor:
    """fp32 N(0, std^2) drawn in place, in blocks of rows of at most
    2**30 elements each (one call per block)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    flat = t.view(shape[0], -1)
    step = max(1, (1 << 30) // max(flat.shape[1], 1))
    for r in range(0, shape[0], step):
        flat[r:r + step].normal_(0.0, std, generator=gen)
    return t


def make_params(cfg: dict, seed: int, device) -> Dict:
    """Every parameter of the model, drawn from ``seed`` on ``device``
    with one generator, in a fixed order (the scales are the config's
    ``assumed``)."""
    from portbench import counts
    gen = generator.seeded(seed, generator.PARAM_STREAM, device)
    T, R, D = cfg["num_tables"], cfg["rows_per_table"], cfg["embed_dim"]
    bottom, top = counts.mlp_dims(cfg)
    return {
        "embed": _normal((T, R, D), 0.01, gen, device),
        "proj": _normal((T, cfg["interaction_proj"]), 0.05, gen, device),
        "bottom": _layers(bottom, gen, device),
        "top": _layers(top, gen, device),
    }


def port_model(cfg: dict, name: str):
    """The port's DLRM for a config file's sizes."""
    from repro_torch.configs.base import DLRMConfig, ModelConfig
    from repro_torch.models.dlrm import DLRMModel
    keys = ("num_tables", "rows_per_table", "embed_dim", "avg_pooling",
            "num_dense_features", "interaction_proj")
    d = DLRMConfig(bottom_mlp=tuple(cfg["bottom_mlp"]),
                   top_mlp=tuple(cfg["top_mlp"]),
                   **{k: cfg[k] for k in keys})
    return DLRMModel(ModelConfig(
        name=name, family="dlrm", num_layers=0, d_model=cfg["embed_dim"],
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=0, dlrm=d))


class _Phases:
    """Seconds of each set-up phase, each ended by a synchronise."""

    def __init__(self, device: torch.device):
        self.device, self.phases, self.t = device, {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


class Session:
    def __init__(self, name: str, cfg: dict, cell: dict, mix: dict,
                 seed: int, device, trace: bool = False):
        if cfg.get("dtype", "float32") != "float32" or cfg.get("tf32"):
            raise ValueError("the DLRM cells serve float32 with TF32 off")
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.device = torch.device(device)
        B = int(cell["batch_size"])
        self.batch_size = B
        clock = _Phases(self.device)
        from repro_torch.serving.cluster import ClusterConfig, ClusterEngine
        from repro_torch.serving.engine import Request
        self._request = Request
        clock("program_imports")
        self.model = port_model(cfg, name)
        params = make_params(cfg, seed, self.device)
        clock("params")
        self.pool = generator.make_pool(mix, cfg, seed, self.device)
        n_pool = self.pool.dense.shape[0]
        self.chunks = generator.make_chunks(
            mix, seed, int(cell["batches_per_chunk"]) * B, N_CHUNKS, n_pool)
        warm = generator.make_chunks(mix, seed, int(cell["warmup_batches"]) * B,
                                   1, n_pool, generator.WARMUP_STREAM)
        self.requests = [self._requests(c) for c in self.chunks]
        clock("traffic")
        self.engine = ClusterEngine(self.model, params, ClusterConfig(
            n_cn=int(cell["n_cn"]), m_mn=int(cell["m_mn"]), batch_size=B,
            max_wait_s=float(cell["max_wait_s"]),
            n_replicas=int(cell["n_replicas"]),
            use_kernel=bool(cell["use_kernel"]),
            mn_types=list(cell["mn_types"]),
            cache_mb=float(cell["cache_mb"])), device=self.device)
        del params
        clock("engine")
        self.served: List = []          # (chunk id, results) a call
        self.stats: List = []           # the program's ClusterStats a call
        self.exec_s: List[float] = []
        self.bag: Dict[str, Dict] = {}
        self.dense_calls = 0
        if trace:
            self._wrap()
        self.engine.serve(self._requests(warm[0]))
        clock("warmup")
        self.setup_phases = clock.phases
        self.exec_s.clear()
        self.bag.clear()
        self.dense_calls = 0
        self.batches0 = self.engine.batches_seen

    # ------------------------------------------------------------ traffic
    def _requests(self, chunk: generator.Chunk):
        p = self.pool
        return [self._request(rid, {"dense": p.dense[o:o + s],
                              "indices": p.indices[o:o + s]}, s, t)
                for rid, (o, s, t) in enumerate(zip(
                    chunk.offsets, chunk.sizes, chunk.arrivals))]

    def serve(self, i: int) -> tuple:
        """One ``ClusterEngine.serve`` call on chunk ``i`` (cycling):
        (requests sent, samples sent)."""
        k = i % len(self.chunks)
        results, stats = self.engine.serve(self.requests[k])
        self.served.append((k, results))
        self.stats.append(stats)
        return len(self.requests[k]), self.chunks[k].samples

    # -------------------------------------------------------------- spans
    def _wrap(self) -> None:
        eng, model = self.engine, self.model
        execute, mn_pool, dense = eng._execute, eng._mn_pool, model.dense_forward
        rf = torch.profiler.record_function
        kind = eng.mn_nmp

        def _execute(*a, **k):
            with rf(SPAN_EXECUTE):
                t = time.perf_counter()
                out = execute(*a, **k)
                self.exec_s.append(time.perf_counter() - t)
            return out

        def _mn_pool(j, tids, idx_sub):
            name = "nmp" if kind[j] else "ddr"
            with rf(SPAN_POOL + name):
                out = mn_pool(j, tids, idx_sub)
            c = self.bag.setdefault(name, {"calls": 0, "tables": 0,
                                           "index_slots": 0, "bags": 0,
                                           "valid": []})
            Bq, Tj, P = idx_sub.shape
            c["calls"] += 1
            c["tables"] += Tj
            c["bags"] += Bq * Tj
            c["index_slots"] += Bq * Tj * P
            c["valid"].append((idx_sub >= 0).sum())   # no sync here
            return out

        def _dense(*a, **k):
            with rf(SPAN_DENSE):
                self.dense_calls += 1
                return dense(*a, **k)

        eng._execute, eng._mn_pool, model.dense_forward = (
            _execute, _mn_pool, _dense)

    def counters(self) -> dict:
        """What the traced window did, by the program's own batch count
        and the spans' records."""
        bag = {}
        for name, c in self.bag.items():
            bag[name] = dict(c, valid=int(torch.stack(c["valid"]).sum()))
        return {"batches": self.engine.batches_seen - self.batches0,
                "batch_size": self.batch_size,
                "samples": sum(self.chunks[k].samples
                               for k, _ in self.served),
                "execute_s": list(self.exec_s),
                "dense_calls": self.dense_calls,
                "bag": bag}

    # -------------------------------------------------------------- check
    def free_program(self) -> None:
        """Drop the engine, its shards and the parameters it was given."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self) -> List:
        """(chunk id, rid) pairs drawn from the seed among the served
        requests, the largest served request among them."""
        occ = [(k, r.rid) for k, results in self.served for r in results]
        if not occ:
            return []
        g = generator.seeded(self.seed, generator.CHECK_STREAM)
        n = min(int(self.cell["check_requests"]), len(occ))
        pick = [occ[i] for i in torch.randperm(len(occ), generator=g)[:n]]
        big = max(occ, key=lambda o: self.chunks[o[0]].sizes[o[1]])
        return sorted(set(pick) | {big})

    def check(self, control: bool = False) -> dict:
        """Requests sent and failed in the window, and the widest gap
        between a served score and the reference's over the sample
        (``gap``); with ``control``, also the widest gap between the
        reference computed in TF32 and in fp32 (``control_gap``)."""
        sent = failed = 0
        outputs = {}
        for k, results in self.served:
            chunk = self.chunks[k]
            sent += len(chunk.sizes)
            got = {r.rid: r.outputs for r in results}
            for rid, size in enumerate(chunk.sizes):
                res = got.get(rid)
                if res is None or np.shape(res) != (size,):
                    failed += 1
                else:
                    outputs.setdefault((k, rid), []).append(
                        np.asarray(res, np.float64))
        sample = [o for o in self._sample() if o in outputs]
        out = {"attempted": sent, "failed": failed, "gap": math.inf,
               "compared": sum(len(outputs[o]) for o in sample),
               "compared_samples": sum(self.chunks[k].sizes[r]
                                       for k, r in sample)}
        if not sample:
            return out
        t = time.perf_counter()
        sl = [slice(self.chunks[k].offsets[r],
                    self.chunks[k].offsets[r] + self.chunks[k].sizes[r])
              for k, r in sample]
        dense = np.concatenate([self.pool.dense[s] for s in sl])
        idx = np.concatenate([self.pool.indices[s] for s in sl])
        params = make_params(self.cfg, self.seed, self.device)
        ref = reference.scores(params, dense, idx).astype(np.float64)
        gap, o = 0.0, 0
        for key, s in zip(sample, sl):
            n = s.stop - s.start
            for got in outputs[key]:
                d = np.abs(got - ref[o:o + n])
                gap = max(gap, float(d.max()) if np.isfinite(d).all()
                          else math.inf)
            o += n
        out["gap"] = gap
        if control:
            ctl = reference.scores(params, dense, idx, "tf32")
            out["control_gap"] = float(np.abs(ctl - ref).max())
        out["reference_s"] = time.perf_counter() - t
        return out

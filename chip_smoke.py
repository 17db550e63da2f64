#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each failing loudly (an assertion or an exception ends the run
with a non-zero exit and no result line):

1. card: the card's name and power limit, from nvidia-smi;
2. build: nvcc builds the bag kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: both CUDA bag kernels against their plain PyTorch version on
   the card over the kernel test grid (D=13, P=1, padded bags, shuffled
   shard offsets, fp32 and bf16): fp32 bitwise, bf16 within 0.1 (the
   reference's tolerance);
4. serve: RM1 V0 at its published widths, only ``rows_per_table`` cut
   (3,417,969 -> 40,000, so the embedding bank fits one card), through
   ``run_scenario`` on the CLI's cluster (2 CNs, 4 MNs as
   ``2xddr_mn+2xnmp_mn``, 2 replicas, batch 64, 32 requests, a FailMN
   mid-stream).  The launch counters are zeroed just before and read
   just after; the scores are checked against the model's own
   one-reduction path; a second run on an all-DDR pool must give
   bitwise-equal scores;
5. timing: each kernel at the exact inputs one main-path launch gave it,
   beside its bytes bound, its plain version and one
   ``torch.nn.functional.embedding_bag`` call as a library yardstick;
6. trace: the same serve once more under ``torch.profiler``: the
   device's busy time per batch, its idle share of the untraced serve's
   wall time, and the top kernels and host ops;
7. single unit: ``DLRMServingEngine(use_kernel=True)`` over the whole
   (800, 40000, 128) bank, which needs 64-bit row addresses.

All timing lives here, never in ``src/`` (the repo's linter bans host
clocks there).  The line before the last is ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
ROWS = 40_000                  # rows_per_table cut so the bank fits
SCORE_ATOL = 1e-5              # cluster scores vs the one-reduction path
BF16_TOL = 0.1                 # the reference's bf16 tolerance
GRID = [(1, 64, 8, 4, 4), (4, 100, 16, 8, 10), (3, 257, 32, 5, 7),
        (2, 128, 128, 16, 20), (3, 96, 13, 6, 5), (2, 50, 8, 5, 1)]
KERNELS = {
    "embedding_bag_fused_flat": "src/repro/kernels/embedding_bag.py:88",
    "embedding_bag_nmp_flat": "src/repro/kernels/embedding_bag.py:157",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def mixed_idx(rng, R, B, T, P):
    idx = rng.randint(0, R, (B, T, P)).astype(np.int32)
    lens = rng.randint(0, P + 1, (B, T))
    lens[0, 0] = 0                                  # one all-padded bag
    mask = np.arange(P)[None, None, :] < lens[..., None]
    return np.where(mask, idx, -1).astype(np.int32)


def check_grid(dev) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_flat_plain
    n = 0
    for (T, R, D, B, P) in GRID:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(T * 1000 + D)
            flat = torch.from_numpy(
                rng.randn(T * R, D).astype(np.float32)).to(dev, dtype)
            slots = rng.permutation(T).astype(np.int32)   # shuffled shard
            offsets = torch.from_numpy(slots * R).to(dev)
            idx = torch.from_numpy(mixed_idx(rng, R, B, T, P)).to(dev)
            want = embedding_bag_flat_plain(flat, offsets, idx)
            for name in KERNELS:
                got = getattr(ops, name)(flat, offsets, idx)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    assert torch.equal(got, want), (name, T, R, D, B, P)
                else:
                    err = float((got - want).abs().max())
                    assert err <= BF16_TOL, (name, T, R, D, B, P, err)
                n += 1
    log(f"[kernels] {n} grid cases on the card: fp32 bitwise equal to the "
        f"plain version, bf16 within {BF16_TOL}")


def median_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernel(name, flat, offsets, idx, launches, card):
    """Time one kernel at one main-path launch's exact inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_flat_plain
    kernel = getattr(ops, name)
    out = kernel(flat, offsets, idx)
    plain = embedding_bag_flat_plain(flat, offsets, idx)
    err = float((out - plain).abs().max())
    assert torch.equal(out, plain), (name, err)
    B, T, P = idx.shape
    D = flat.shape[1]
    valid = idx >= 0
    n_valid = int(valid.sum())
    # library yardstick: one embedding_bag call over the same flat table
    ids = (offsets.to(torch.int64)[None, :, None]
           + idx.to(torch.int64))[valid]
    counts = valid.sum(dim=2).reshape(-1)
    bag_off = torch.zeros_like(counts)
    bag_off[1:] = torch.cumsum(counts, 0)[:-1]

    def library():
        return torch.nn.functional.embedding_bag(ids, flat, bag_off,
                                                 mode="sum")
    lib_err = float((library().reshape(B, T, D) - out).abs().max())
    ms = median_ms(lambda: kernel(flat, offsets, idx), iters=50)
    plain_ms = median_ms(lambda: embedding_bag_flat_plain(flat, offsets, idx),
                         iters=5, warmup=1)
    library_ms = median_ms(library, iters=50)
    nbytes = (n_valid * D * flat.element_size() + B * T * P * 4 + T * 4
              + B * T * D * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_valid * D / FP32_OPS_PER_S * 1e3
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "replaces": KERNELS[name], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    log("[timing] " + json.dumps(dict(
        row, shape={"B": B, "T": T, "P": P, "D": D,
                    "shard_rows": flat.shape[0], "valid_slots": n_valid},
        bytes=nbytes, library_max_abs_err=lib_err, card=card)))
    return row


class MainPathProbe:
    """Counts ``ClusterEngine._mn_pool`` calls, keeps the first call's
    inputs for each kernel (so the timing phase can replay one real
    main-path launch), times ``serve`` and, with ``profile``, traces it
    with ``torch.profiler``."""

    def __init__(self, profile: bool = False):
        from repro_torch.serving.cluster import ClusterEngine
        self.cls = ClusterEngine
        self.orig_pool = ClusterEngine._mn_pool
        self.orig_serve = ClusterEngine.serve
        self.profile = profile
        self.prof = None
        self.calls = 0
        self.first = {}
        self.serve_s = 0.0

    def __enter__(self):
        probe = self

        def mn_pool(eng, j, tids, idx_sub):
            probe.calls += 1
            name = ("embedding_bag_nmp_flat" if eng.mn_nmp[j]
                    else "embedding_bag_fused_flat")
            if name not in probe.first:
                slots = [eng._shard_slot[j][t] for t in tids]
                offsets = torch.tensor(slots, dtype=torch.int32,
                                       device=idx_sub.device) * eng.R
                probe.first[name] = (eng._shard_flat[j], offsets,
                                     idx_sub.clone())
            return probe.orig_pool(eng, j, tids, idx_sub)

        def serve(eng, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if probe.profile:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    out = probe.orig_serve(eng, *a, **kw)
                    torch.cuda.synchronize()
                probe.prof = prof
            else:
                out = probe.orig_serve(eng, *a, **kw)
                torch.cuda.synchronize()
            probe.serve_s += time.perf_counter() - t0
            return out

        self.cls._mn_pool = mn_pool
        self.cls.serve = serve
        return self

    def __exit__(self, *exc):
        self.cls._mn_pool = self.orig_pool
        self.cls.serve = self.orig_serve
        return False


def profile_summary(prof, traced_s: float, wall_s: float, batches: int,
                    card: str) -> None:
    """Device busy time of a traced serve against the untraced serve's
    wall time ``wall_s`` (tracing slows the host many times over, the
    device work not at all), and the kernels and host ops that take the
    most time.  Busy time sums the device-side events (kernels, copies)
    only: a host op's own device time repeats that of the kernels it
    launched.  The serve loop runs on one stream, so device events do
    not overlap."""
    events = prof.key_averages()
    device = [e for e in events if e.device_type != torch.autograd.DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    log(f"[profile] traced serve of {batches} batches: device busy "
        f"{busy_ms:.3f} ms = {busy_ms / batches:.3f} ms/batch; idle share "
        f"{1 - busy_ms / (wall_s * 1e3):.4f} of the untraced serve's "
        f"{wall_s * 1e3:.1f} ms (traced wall {traced_s * 1e3:.1f} ms); "
        f"{card}")
    for label, evs, key in (
            ("device", device, lambda e: e.self_device_time_total),
            ("host", host, lambda e: e.self_cpu_time_total)):
        top = sorted(evs, key=key, reverse=True)[:8]
        log(f"[profile] top {label} (ms): " + "; ".join(
            f"{e.key[:60]} {key(e) / 1e3:.3f} x{e.count}" for e in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from repro_torch.configs import rm1
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import embedding_bag_seq_ref
    from repro_torch.launch import serve
    from repro_torch.models.dlrm import DLRMModel
    from repro_torch.serving.engine import DLRMServingEngine
    from repro_torch.serving.scenario import plan_workload, run_scenario

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    log(f"[card] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    # -------------------------------------------------------------- build
    t0 = time.perf_counter()
    build.build(["embedding_bag"])
    build.load("embedding_bag")
    log(f"[build] embedding_bag.cu built in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOGS.get("embedding_bag", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ------------------------------------------------------------ kernels
    check_grid(dev)

    # -------------------------------------------------------------- serve
    cfg = rm1.CONFIG.replace(
        name="rm1.v0-rows40k",
        dlrm=dataclasses.replace(rm1.CONFIG.dlrm, rows_per_table=ROWS))
    log(f"[serve] {cfg.name}: RM1 V0 at its published widths "
        f"{dataclasses.asdict(cfg.dlrm)}; cut: rows_per_table "
        f"{rm1.CONFIG.dlrm.rows_per_table} -> {ROWS}")
    model = DLRMModel(cfg)
    params = model.init(0, device=dev)
    assert not torch.backends.cuda.matmul.allow_tf32   # set by the port
    flags = ["--cluster", "--full", "--mns", "4", "--cns", "2",
             "--replicas", "2", "--batch", "64", "--requests", "32",
             "--fail-mn", "1"]
    spec = serve.spec_from_flags(serve.parser().parse_args(
        flags + ["--mn-type", "2xddr_mn+2xnmp_mn"]))
    stream = plan_workload(spec, cfg)
    reqs = stream[0]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with MainPathProbe() as probe:
        rep = run_scenario(spec, model=model, params=params, stream=stream)
    launches = dict(ops.LAUNCHES)
    eng = rep.engine
    log(f"[serve] {rep.completed}/{rep.total} requests in "
        f"{eng.batches_seen} batches; launches {launches}; _mn_pool calls "
        f"{probe.calls}; serve wall {probe.serve_s:.3f} s = "
        f"{probe.serve_s / eng.batches_seen * 1e3:.2f} ms/batch; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{card}")
    for line in rep.summary():
        log(line)
    assert rep.completed == rep.total == len(reqs)
    assert all(v > 0 for v in launches.values()), launches
    assert sum(launches.values()) == probe.calls, (launches, probe.calls)
    assert rep.stats.failures == 1
    scores = {r.rid: r.outputs for r in rep.results}

    # ------------------------------------------------------------- timing
    rows = [time_kernel(name, *probe.first[name], launches[name], card)
            for name in KERNELS]

    serve_s = probe.serve_s
    del rep, eng, probe            # frees the replica shards
    gc.collect()
    torch.cuda.empty_cache()
    for r in reqs:
        s = scores[r.rid]
        assert s.shape == (r.size,) and np.all(np.isfinite(s))
        assert np.all((s >= 0) & (s <= 1))
        for c in range(0, r.size, 64):
            batch = {k: torch.from_numpy(v[c:c + 64]).to(dev)
                     for k, v in r.payload.items()}
            want = model.serve_step(params, batch).cpu().numpy()
            np.testing.assert_allclose(s[c:c + 64], want, rtol=0,
                                       atol=SCORE_ATOL)
    log(f"[serve] every score finite, in [0, 1], and within {SCORE_ATOL} "
        f"of the model's one-reduction path")
    ops.reset_launches()
    spec_ddr = serve.spec_from_flags(serve.parser().parse_args(
        flags + ["--mn-type", "ddr_mn"]))
    rep_ddr = run_scenario(spec_ddr, model=model, params=params,
                           stream=stream)
    assert rep_ddr.completed == rep_ddr.total
    assert ops.LAUNCHES["embedding_bag_nmp_flat"] == 0
    for r in rep_ddr.results:
        assert np.array_equal(r.outputs, scores[r.rid]), r.rid
    log("[serve] all-DDR pool: scores bitwise equal to the mixed pool's")
    del rep_ddr
    gc.collect()
    torch.cuda.empty_cache()
    with MainPathProbe(profile=True) as traced:
        rep = run_scenario(spec, model=model, params=params, stream=stream)
    profile_summary(traced.prof, traced.serve_s, serve_s,
                    rep.engine.batches_seen, card)
    del rep, traced
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------------- single unit
    unit = DLRMServingEngine(model, params, batch_size=64, use_kernel=True)
    ops.reset_launches()
    out = unit.serve(reqs[:8])
    unit_launches = dict(ops.LAUNCHES)
    assert unit_launches["embedding_bag_fused_flat"] > 0, unit_launches
    for r in out:
        np.testing.assert_allclose(r.outputs, scores[r.rid], rtol=0,
                                   atol=SCORE_ATOL)
    idx = torch.from_numpy(np.concatenate(
        [r.payload["indices"] for r in reqs[:8]])[:64]).to(dev)
    whole = ops.embedding_bag_fused(params["embed"], idx)
    assert torch.equal(whole, embedding_bag_seq_ref(params["embed"], idx))
    log(f"[unit] DLRMServingEngine(use_kernel=True): {len(out)} requests, "
        f"launches {unit_launches}; the fused kernel over the whole "
        f"{tuple(params['embed'].shape)} bank (64-bit rows) is bitwise "
        f"equal to the slot-order reference")

    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Which collectives the gloo backend runs on CUDA tensors, with every
rank on one card.

    python3 tools/gloo_probe.py            # 4 ranks on cuda:0
    python3 tools/gloo_probe.py --device cpu
    python3 tools/gloo_probe.py --funcol   # DTensor's full_tensor only

Spawns the ranks (joined by a ``file://`` store in a temp directory),
tries each collective once on a small tensor of the device, checks its
result, and prints one line per collective: ``ok`` or the error's first
words.  Each collective raises (or not) on every rank alike, before any
traffic, so a refusal on one rank never leaves another waiting.  Then
it passes one CUDA tensor to a rank through ``torch.multiprocessing``
(CUDA IPC) and times an all-reduce of 4 KB and of 26 MB, the size of
RM1's pooled partial at batch 64.  ``--funcol`` instead has each rank
gather a DTensor with ``full_tensor()``, which goes through the
functional collectives, and prints the ranks' exit codes: on the H100
with torch 2.11 they die in ``wait_tensor`` (-11), which is why
``distributed.sharding`` moves DTensors with c10d collectives only.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _collectives(dev, rank, world):
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    full = torch.cat([torch.arange(8, dtype=torch.float32, device=dev) + r
                      for r in range(world)])

    def all_reduce_sum():
        y = x.clone()
        dist.all_reduce(y)
        assert torch.equal(y, sum(torch.arange(8, dtype=torch.float32,
                                               device=dev) + r
                                  for r in range(world)))

    def all_reduce_max():
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        assert torch.equal(y, x - rank + world - 1)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        assert torch.equal(torch.cat(parts), full)

    def all_gather_into_tensor():
        out = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        assert torch.equal(out, full)

    def reduce_scatter_tensor():
        out = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(out, x)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        assert torch.equal(y, x - rank)

    def all_to_all_single():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)

    return [all_reduce_sum, all_reduce_max, all_gather,
            all_gather_into_tensor, reduce_scatter_tensor, broadcast,
            all_to_all_single]


def rank_main(rank, world, store, device, shared, q):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        dev = torch.device(device)
        res = {}
        for fn in _collectives(dev, rank, world):
            try:
                fn()
                res[fn.__name__] = "ok"
            except (RuntimeError, ValueError, AssertionError) as e:
                res[fn.__name__] = f"{type(e).__name__}: {str(e)[:100]}"
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = init_device_mesh(dev.type, (2, world // 2),
                                mesh_dim_names=("data", "model"))
        t = DTensor.from_local(torch.ones(2, 3, device=dev), mesh,
                               [Replicate(), Shard(0)])
        res["device_mesh"] = (f"{mesh.device_type} groups "
                              f"{mesh.get_group('model').name()} "
                              f"DTensor {tuple(t.shape)} on "
                              f"{t.to_local().device}")
        res["ipc"] = "ok" if (shared is None or float(shared.sum()) == 28.0) \
            else "wrong"
        for nbytes in (4096, 26_214_400):
            y = torch.ones(nbytes // 4, device=dev)
            dist.all_reduce(y)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                dist.all_reduce(y)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            res[f"all_reduce {nbytes} B ms"] = round(
                (time.perf_counter() - t0) / 5 * 1e3, 3)
        q.put((rank, res))
    finally:
        dist.destroy_process_group()


def funcol_rank(rank, world, store, device):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        mesh = init_device_mesh(device, (world,), mesh_dim_names=("model",))
        t = DTensor.from_local(torch.full((2, 3), float(rank), device=device),
                               mesh, [Shard(0)])
        assert t.full_tensor().shape == (2 * world, 3)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--funcol", action="store_true")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    ctx = mp.get_context("spawn")
    if args.funcol:
        with tempfile.TemporaryDirectory() as d:
            procs = [ctx.Process(target=funcol_rank, args=(
                r, WORLD, os.path.join(d, "store"), args.device))
                for r in range(WORLD)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=120)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        print(f"DTensor.full_tensor on {args.device}: exit codes {codes}")
        return 0
    q = ctx.Queue()
    shared = (torch.arange(8, dtype=torch.float32, device=args.device)
              if args.device == "cuda" else None)
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=rank_main,
                             args=(r, WORLD, store, args.device, shared, q))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        results = dict(q.get(timeout=240) for _ in procs)
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        codes = [p.exitcode for p in procs]
    for k, v in results[0].items():
        print(f"{k}: {v}")
    print(f"exit codes {codes}")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The port's serving outputs, saved so that two source trees can be
held bitwise against each other.

    PYTHONPATH=src python3 tools/serving_outputs.py --out now.npz
    PYTHONPATH=old/src python3 tools/serving_outputs.py --out old.npz
    python3 tools/serving_outputs.py --compare old.npz now.npz

Runs under ``torch.no_grad()``, on the CUDA card unless ``--device cpu``,
with the reduced smollm-135m, qwen2-moe-a2.7b, whisper-large-v3 (seeded
fp32 frames, as the CLI sends them), zamba2-7b and rwkv6-3b (prefill,
then two greedy decode steps) and RM1 (``serve_step`` on its plain and
its kernel pooling path, and the pooled embeddings, the Fsum's result on
a mesh, which the scores of small initial weights barely move with),
each in its own dtype (bf16) and in fp32, where a change of summation
order is not hidden by the rounding; their weights from
``model.init(0)`` and their inputs from ``--seed``:

- on one device, where whisper, zamba2 and rwkv6 also give their loss
  and every gradient leaf (``train_loop.value_and_grad``);
- on the meshes (data 2, model 2) and (data 1, model 4), in 4 gloo rank
  processes (on one card they share it), through ``launch.steps.
  build_program``'s prefill and decode and RM1's mesh ``serve_step``;
  each rank saves its local blocks.  An arch whose model has no
  ``cache_logical`` (no mesh branches in that tree) is left out there.

``repro_torch`` is imported from ``PYTHONPATH``, so the same script runs
against any tree that has the mesh serving path.  ``--compare`` checks
that two such files hold the same keys and the same bits, prints one
line per key that differs, and exits 1 if any does; with ``--common``
it compares the keys that both files hold and prints how many each
holds alone (a tree that serves more archs on a mesh than the other).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

LMS = ("smollm-135m", "qwen2-moe-a2.7b")
#: the encoder-decoder and recurrent families, served and differentiated
ZOO = ("whisper-large-v3", "zamba2-7b", "rwkv6-3b")
MESHES = {"2x2": 2, "1x4": 4}
WORLD = 4
BATCH, SEQ, DLRM_BATCH, DECODES = 4, 16, 8, 2
DTYPES = ("bfloat16", "float32")
TIMEOUT_S = 600


def _np(t):
    """A tensor's values as numpy (bf16 widened to fp32, which is exact)."""
    import torch
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _inputs(seed: int) -> dict:
    from repro_torch import configs
    from repro_torch.data.queries import dlrm_batch, lm_batch

    rng = np.random.RandomState(seed)
    out = {a: lm_batch(configs.get_reduced(a).vocab_size, BATCH, SEQ, rng)
           for a in LMS}
    out["rm1"] = dlrm_batch(configs.get_reduced("rm1"), DLRM_BATCH, rng)
    out.update({a: lm_batch(configs.get_reduced(a).vocab_size, BATCH, SEQ,
                            rng) for a in ZOO})
    enc = configs.get_reduced("whisper-large-v3")
    out["whisper-large-v3"]["frames"] = rng.randn(
        BATCH, enc.encdec.encoder_seq, enc.d_model).astype(np.float32)
    return out


def _batch(inputs, dev, keys=("tokens", "frames")) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()
            if k in keys}


def _configs():
    """(tag, arch, config) of every case."""
    from repro_torch import configs

    for dt in DTYPES:
        for arch in LMS + ZOO + ("rm1",):
            yield (f"{arch}/{dt}", arch,
                   configs.get_reduced(arch).replace(dtype=dt,
                                                     param_dtype=dt))


def one_device(dev, seed: int) -> dict:
    import torch
    from repro_torch.models import registry
    from repro_torch.train.train_loop import value_and_grad

    inputs, out = _inputs(seed), {}
    for tag, arch, cfg in _configs():
        if arch in ZOO:
            model = registry.build(cfg)
            loss, grads = value_and_grad(
                model, model.init(0, device=dev),
                _batch(inputs[arch], dev, ("tokens", "frames", "labels")))
            out[f"one/{tag}/loss"] = _np(loss)
            for path, g in _leaves(grads):
                out[f"one/{tag}/grad/{path}"] = _np(g)
    with torch.no_grad():
        for tag, arch, cfg in _configs():
            model = registry.build(cfg)
            params = model.init(0, device=dev)
            if arch == "rm1":
                batch = {k: torch.from_numpy(inputs[arch][k]).to(dev)
                         for k in ("dense", "indices")}
                for k in (False, True):
                    out[f"one/{tag}/kernel={k}"] = _np(model.serve_step(
                        params, batch, use_kernel=k))
                    out[f"one/{tag}/pooled/kernel={k}"] = _np(
                        model.pool_embeddings(params, batch["indices"], k))
                continue
            lg, cache = model.prefill(params, _batch(inputs[arch], dev),
                                      cache_len=2 * SEQ)
            out[f"one/{tag}/prefill"] = _np(lg)
            for i in range(DECODES):
                tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
                lg, cache = model.decode_step(params, cache, {"tokens": tok})
                out[f"one/{tag}/decode{i}"] = _np(lg)
    return out


def rank_main(rank: int, d: str, device: str, seed: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=WORLD)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import elastic, sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_program
    from repro_torch.models import registry

    dev = torch.device(device)
    inputs, out = _inputs(seed), {}
    try:
        for name, model_axis in MESHES.items():
            mesh = make_host_mesh(model_axis, device=device)
            for tag, arch, cfg in _configs():
                model = registry.build(cfg)
                params = model.init(0, device=dev)
                key = f"{name}/r{rank}/{tag}"
                if arch == "rm1":
                    rules = registry.make_rules(cfg, mesh, "prefill")
                    placed = elastic.reshard_tree(params, model.param_specs(),
                                                  mesh, rules)
                    batch = {k: torch.from_numpy(inputs[arch][k]).to(dev)
                             for k in ("dense", "indices")}
                    with torch.no_grad(), shd.use_mesh(mesh, rules):
                        for k in (False, True):
                            out[f"{key}/kernel={k}"] = _np(model.serve_step(
                                placed, batch, use_kernel=k).to_local())
                            out[f"{key}/pooled/kernel={k}"] = _np(
                                model.pool_embeddings(
                                    placed, batch["indices"], k))
                    continue
                if not hasattr(model, "cache_logical"):
                    continue
                pf, _, pr = build_program(
                    cfg, ShapeConfig("p", SEQ, BATCH, "prefill"), mesh,
                    cache_len=2 * SEQ)
                df, _, dr = build_program(
                    cfg, ShapeConfig("d", 2 * SEQ, BATCH, "decode"), mesh)
                pp = elastic.reshard_tree(params, model.param_specs(), mesh,
                                          pr)
                dp = elastic.reshard_tree(params, model.param_specs(), mesh,
                                          dr)
                lg, cache = pf(pp, _batch(inputs[arch], dev))
                out[f"{key}/prefill"] = _np(lg.to_local())
                for i in range(DECODES):
                    tok = shd.full(lg)[:, -1].argmax(-1)[:, None].to(
                        torch.int32)
                    lg, cache = df(dp, cache, {"tokens": tok})
                    out[f"{key}/decode{i}"] = _np(lg.to_local())
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run(device: str, seed: int, path: str) -> None:
    import torch
    import repro_torch

    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    out = one_device(torch.device(device), seed)
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--dir", d, "--device", device, "--seed", str(seed)])
            for r in range(WORLD)]
        try:
            rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            sys.exit(f"rank exit codes {rcs}")
        for r in range(WORLD):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                out.update({k: z[k] for k in z.files})
    np.savez(path, **out)
    print(f"{len(out)} outputs -> {path}")


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def compare(a: str, b: str, common: bool = False) -> int:
    with np.load(a) as za, np.load(b) as zb:
        ka, kb = sorted(za.files), sorted(zb.files)
        if ka != kb:
            only = (len(set(ka) - set(kb)), len(set(kb) - set(ka)))
            if not common:
                print(f"keys differ: {sorted(set(ka) ^ set(kb))}")
                return 1
            print(f"keys held by one file alone, left out: {only[0]} in "
                  f"{a}, {only[1]} in {b}")
            ka = sorted(set(ka) & set(kb))
        bad = [k for k in ka if za[k].dtype != zb[k].dtype
               or za[k].shape != zb[k].shape
               or za[k].tobytes() != zb[k].tobytes()]
    for k in bad:
        print(f"differs: {k}")
    print(f"{len(ka) - len(bad)} of {len(ka)} outputs bitwise equal")
    return 1 if bad else 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--common", action="store_true",
                    help="with --compare: only the keys both files hold")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--dir")
    args = ap.parse_args()
    if args.compare:
        sys.exit(compare(*args.compare, common=args.common))
    if args.rank is not None:
        rank_main(args.rank, args.dir, args.device, args.seed)
        return
    if not args.out:
        ap.error("--out or --compare is required")
    run(args.device, args.seed, args.out)


if __name__ == "__main__":
    main()

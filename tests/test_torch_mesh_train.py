"""Training on a mesh: the port's ZeRO-1 ``state_specs``, its
differentiable collectives, ``build_program``'s train step,
``checkpoint.save`` from a mesh and ``elastic.elastic_restore`` against
the reference's, and against the port's own single-device results.

- Pure Python: ``optimizer.state_specs`` equals the reference's for
  every arch x mesh shape under the train rules, with and without the
  parameter shapes (mesh shapes as dicts, as ``test_torch_mesh.py``'s
  rule tests do).
- Meshes (data 2, model 2) and (1, 4), run as ``test_torch_mesh.py``
  runs them: the reference in JAX subprocesses with four host devices
  (one per mesh, and one more for (2, 2)'s compress and microbatch
  steps), its meshes built as ``jax.sharding.Mesh(devices.reshape(
  shape), names)`` (Auto axes), the port in 4 gloo rank processes that
  import no JAX.  A second JAX subprocess, after the ranks, restores
  the checkpoint the port saved on (2, 2) with the reference's
  ``elastic_restore``.  Every subprocess has a 120 s timeout.
- Reduced fp32 configs with the reference's weights (plus seeded noise):
  llama3-8b cut to 2 layers and 8/4 heads (head-TP), smollm's
  ``REDUCED`` (FSDP + context parallelism), qwen2-moe's ``REDUCED`` at
  capacity factor 8.0 (head-TP, EP, the aux over every rank's tokens),
  RM1's reduced (the Fsum over ``table_rows``).  Each rank's global loss
  within 1e-5 of the reference's mesh and of one device; every leaf's
  gradient, gathered whole, within rtol 1e-4 and atol 1e-5 of the
  leaf's largest magnitude; after one step of the train program (Adam;
  Adagrad for RM1) the parameters and the state, gathered whole, within
  1e-5.  One step with ``compress_grads=True``, and one with
  ``microbatches=2``, likewise.
- ``run_train_loop(mesh=, rules=)`` on (2, 2) through a fault and a
  restore against one device's loop.
- Each collective's gradient in fp64 on gloo ranks against autograd of
  the whole-tensor function (``psum``, ``all_gather``, ``redistribute``
  from Shard to Replicate and back, ``local`` of a whole tensor,
  ``layers.psum_matmul``), and ``pmax`` refusing a grad-requiring input.
- With grad mode off every serving mesh path (LM prefill and decode
  under head-TP, FSDP + CP and EP; the DLRM's Fsum on both pooling
  paths) is bitwise what the serving-only port's code gives: the ranks
  patch in, for a second run, its versions of everything training
  changed on those paths (the collectives as plain c10d calls with no
  autograd, ``psum_matmul``, the DLRM's mesh pooling).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tshd
from repro_torch.models import registry as tregistry
from repro_torch.train import optimizer as topt

from _torch_zoo import noisy

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5    # atol: of the leaf's largest |g|
MESH_SHAPES = {"1x1": (1, 1), "2x2": (2, 2), "1x4": (1, 4), "16x16": (16, 16)}
RUN_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ["llama3-8b", "smollm-135m", "qwen2-moe-a2.7b", "rm1"]
BATCH, SEQ, DLRM_BATCH = 4, 16, 8
COMPRESS_ARCH = "smollm-135m"        # the compress_grads step, on (2, 2)
#: saved on (2, 2) after the step and restored on the 2 survivors; the
#: reference restores the first too (its ``elastic_restore`` resolves
#: ``state_specs`` outside the mesh, which under smollm's FSDP rules
#: gives a spec with ``data`` twice, and raises)
ELASTIC_ARCHS = ["llama3-8b", "smollm-135m"]
#: run_train_loop on (2, 2): steps, checkpoint period, the faulty step
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_FAULT_AT = 5, 2, 3


class _ShapeMesh:
    """A mesh of a given shape for the reference's rule resolution,
    which reads only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------- state_specs
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_state_specs_match(arch, mesh):
    """ZeRO-1 specs of the Adam state (with ``err``: compress_grads)
    equal the reference's under the train rules, with and without the
    parameter shapes."""
    shape = MESH_SHAPES[mesh]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    jmesh = _ShapeMesh(shape)
    tmesh = dict(zip(("data", "model"), shape))
    jrules = jregistry.make_rules(jcfg, jmesh, "train")
    trules = tregistry.make_rules(tcfg, tmesh, "train")
    for kw in (dict(), dict(compress_grads=True), dict(kind="adagrad")):
        with jshd.use_mesh(jmesh, jrules):
            jspecs = jm.param_specs()
            want = [jopt.state_specs(jopt.OptConfig(**kw), jspecs),
                    jopt.state_specs(jopt.OptConfig(**kw), jspecs,
                                     jm.param_shapes())]
        with tshd.use_mesh(tmesh, trules):
            tspecs = tm.param_specs()
            got = [topt.state_specs(topt.OptConfig(**kw), tspecs),
                   topt.state_specs(topt.OptConfig(**kw), tspecs,
                                    tm.param_shapes())]
        assert got == want, kw
    if shape[0] > 1 and jcfg.family != "dlrm":
        # ZeRO-1 shards something over data that the weights do not
        flat = list(_leaves(got[1]["v"]))
        assert any("opt_shard" in names for _, names in flat)


def test_bind_mesh_carries_the_mesh_to_another_thread():
    """A checkpointed layer recomputes in the backward, which on the card
    runs on autograd's device thread: ``bind_mesh`` gives the function
    the mesh and rules active where it was bound, on any thread."""
    import threading

    mesh, rules = {"data": 2, "model": 2}, {"heads": None}
    seen = {}

    def probe(tag):
        seen[tag] = (tshd.current_mesh(), tshd.resolve(("heads", "ffn")))

    with tshd.use_mesh(mesh, rules):
        bound = tshd.bind_mesh(probe)
    for tag, fn in (("plain", probe), ("bound", bound)):
        t = threading.Thread(target=fn, args=(tag,))
        t.start()
        t.join()
    assert seen["plain"][0] is None
    assert seen["bound"] == (mesh, (None, "model"))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


# ------------------------------------------------------------- meshes
def _cfg(pkg, arch):
    cfg = pkg.get_reduced(arch)
    if cfg.family == "dlrm":
        return cfg
    cfg = cfg.replace(dtype="float32", param_dtype="float32")
    if arch == "llama3-8b":       # as tests/test_multidevice.py cuts it
        cfg = cfg.replace(num_layers=2, d_model=64, num_heads=8,
                          num_kv_heads=4, d_ff=128, vocab_size=256,
                          head_dim=16)
    if cfg.moe is not None:       # no drops, as tests/test_multidevice.py
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


COMMON = r"""
import dataclasses, json, os, sys
import numpy as np

def nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out

def cfg_of(configs, arch):
    cfg = configs.get_reduced(arch)
    if cfg.family == "dlrm":
        return cfg
    cfg = cfg.replace(dtype="float32", param_dtype="float32")
    if arch == "llama3-8b":
        cfg = cfg.replace(num_layers=2, d_model=64, num_heads=8,
                          num_kv_heads=4, d_ff=128, vocab_size=256,
                          head_dim=16)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg

def batch_of(inputs, arch):
    return {k.split("/", 1)[1]: inputs[k] for k in inputs.files
            if k.startswith(arch + "/")}
"""

JAX_SCRIPT = COMMON + r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd
from repro.launch.steps import build_program
from repro.models import registry
from repro.train import optimizer as opt_mod
from repro.train.optimizer import OptConfig
d, name, shape = sys.argv[1], sys.argv[2], tuple(json.loads(sys.argv[3]))
part = sys.argv[4]         # "main": every arch's step; "extra": the others
spec = json.loads(open(os.path.join(d, "spec.json")).read())
mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
inputs = np.load(os.path.join(d, "inputs.npz"))

def tree(arch):
    data = np.load(os.path.join(d, arch + ".npz"))
    return nest({k: jnp.asarray(data[k]) for k in data.files})

def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[prefix + key] = np.asarray(leaf, np.float32)
    return out

out = {}
archs = spec["archs"] if part == "main" else [spec["compress_arch"]]
for arch in archs:
    cfg = cfg_of(configs, arch)
    model = registry.build(cfg)
    batch = {k: jnp.asarray(v) for k, v in batch_of(inputs, arch).items()}
    B = next(iter(batch.values())).shape[0]
    S = batch["tokens"].shape[1] if "tokens" in batch else 1
    if part == "main" and cfg.family == "dlrm":
        # Adagrad's state keeps |g| only: the gradient itself (an Adam
        # step's m is (1 - b1) * clip * g, which the test reads instead)
        rules = registry.make_rules(cfg, mesh, "train")
        with shd.use_mesh(mesh, rules):
            _, grads = jax.jit(jax.value_and_grad(model.loss))(tree(arch),
                                                               batch)
        out.update(flat(grads, f"{arch}/grad/"))
    kinds = ([("step", {}, 1)] if part == "main" else
             [("compress", {"compress_grads": True}, 1), ("micro", {}, 2)])
    for tag, kw, mb in kinds:
        ocfg = OptConfig(kind="adagrad" if cfg.family == "dlrm" else "adam",
                         **kw)
        step, _, _ = build_program(cfg, ShapeConfig("t", S, B, "train"),
                                   mesh, ocfg, microbatches=mb)
        params = tree(arch)        # the step donates its arguments
        p2, s2, met = step(params, opt_mod.init_state(ocfg, params), batch)
        out.update(flat(p2, f"{arch}/{tag}/param/"))
        out.update(flat(s2, f"{arch}/{tag}/state/"))
        out[f"{arch}/{tag}/loss"] = np.asarray(met["loss"])
        out[f"{arch}/{tag}/grad_norm"] = np.asarray(met["grad_norm"])
np.savez(os.path.join(d, f"jax-{name}-{part}.npz"), **out)
"""

JAX_ELASTIC = COMMON + r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro import configs
from repro.distributed import elastic
from repro.models import registry
from repro.train.optimizer import OptConfig
d = sys.argv[1]
spec = json.loads(open(os.path.join(d, "spec.json")).read())
arch = spec["elastic_archs"][0]
cfg = cfg_of(configs, arch)
model = registry.build(cfg)
small = elastic.healthy_mesh({"model": 2}, failed_fraction=0.4)
rules = registry.make_rules(cfg, small, "train")
params, state, step = elastic.elastic_restore(
    os.path.join(d, "ckpt", arch), model, OptConfig(), small, rules)
out = {"step": np.array(step), "devices": np.array(small.devices.size)}
for prefix, t in (("p/", params), ("o/", state)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[prefix + key] = np.asarray(leaf, np.float32)
np.savez(os.path.join(d, "jax-elastic.npz"), **out)
"""

RANK_SCRIPT = COMMON + r"""
import torch
import torch.distributed as dist
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "store"), rank=rank, world_size=world)
from types import SimpleNamespace
from torch.distributed.tensor import DTensor, Replicate
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import elastic, sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_program
from repro_torch.models import layers as L, registry
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import params_from_reference
from repro_torch.train import checkpoint as ckpt, optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig
from repro_torch.data.queries import ShardedLoader, lm_batch
from repro_torch.train.train_loop import (TrainLoopConfig, make_train_step,
                                          run_train_loop, value_and_grad,
                                          value_and_grad_mesh)
spec = json.loads(open(os.path.join(d, "spec.json")).read())
inputs = np.load(os.path.join(d, "inputs.npz"))

def tree(arch):
    data = np.load(os.path.join(d, arch + ".npz"))
    return params_from_reference(nest({k: data[k] for k in data.files}),
                                 device="cpu")

def whole(t, prefix, out):
    # every rank gathers (a collective); the values are rank 0's to keep
    if isinstance(t, dict):
        for k in sorted(t):
            whole(t[k], f"{prefix}{k}/" if isinstance(t[k], dict)
                  else prefix + k, out)
    elif t is not None:
        out[prefix] = shd.full(t).detach().float().numpy().copy()

def entries(x):
    # a DTensor's placements as one entry per tensor dim (mesh axes in
    # mesh order), the form of the reference's PartitionSpec
    names = x.device_mesh.mesh_dim_names
    out = []
    for dim in range(x.dim()):
        axes = [names[i] for i, p in enumerate(x.placements)
                if p.is_shard(dim)]
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return out

def layout(t):
    return json.dumps({p: [list(x.shape), str(x.dtype).split(".")[-1],
                           entries(x), list(x.to_local().shape)]
                       for p, x in _leaves(t)})

def _leaves(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{path}/{k}")
    elif t is not None:
        yield path, t

# ------------------------------------------------ collective gradients
def collective_cases(mesh):
    # fp64: each case's loss and whole gradient on the mesh, and autograd
    # of the whole-tensor function (the same seeded tensors on every rank)
    g = torch.Generator().manual_seed(11)
    f64 = dict(dtype=torch.float64)
    X, C = torch.randn(8, 12, generator=g, **f64), torch.randn(8, 12, generator=g, **f64)
    W, x0 = torch.randn(12, 6, generator=g, **f64), torch.randn(5, 12, generator=g, **f64)
    c6 = torch.randn(5, 6, generator=g, **f64)
    big = "data" if mesh.size(0) > 1 else "model"
    other = "model" if big == "data" else "data"
    rules = {"r": (big,), "c": (other,)}
    out = {}
    with shd.use_mesh(mesh, rules):
        re, ce = shd.resolve(("r",))[0], shd.resolve(("c",))[0]
        every = tuple(mesh.mesh_dim_names)
        cblk = shd.local(C, "r", "c")
        cases = {
            "psum": ({"x": shd.place(X, ("r", None))},
                     lambda p: (torch.sin(shd.psum(shd.local(
                         p["x"], "r", None).sum(0), re)) * C[0]).sum(),
                     lambda p: (torch.sin(p["x"].sum(0)) * C[0]).sum()),
            "all_gather": ({"x": shd.place(X, ("r", "c"))},
                           lambda p: (shd.all_gather(shd.all_gather(
                               shd.local(p["x"], "r", "c"), re, 0), ce, 1)
                               ** 3 * C).sum(),
                           lambda p: (p["x"] ** 3 * C).sum()),
            "redistribute": ({"x": shd.place(X, ("r", "c"))},
                             lambda p: shd.psum((shd.redistribute(
                                 DTensor.from_local(torch.sin(
                                     shd.redistribute(p["x"], [Replicate()] * 2)
                                     .to_local()), mesh, [Replicate()] * 2,
                                     shape=X.shape, stride=X.stride()),
                                 p["x"].placements).to_local() * cblk).sum(),
                                 every),
                             lambda p: (torch.sin(p["x"]) * C).sum()),
            "local": ({"x": X.clone()},
                      lambda p: shd.psum((shd.local(p["x"], "r", "c") ** 2
                                          * cblk).sum(), every),
                      lambda p: (p["x"] ** 2 * C).sum()),
            "psum_matmul": ({"x": x0.clone(), "w": shd.place(W, ("c", None))},
                            lambda p: (torch.tanh(L.psum_matmul(
                                p["x"].narrow(-1, shd.entry_index(ce)[0] * (
                                    12 // shd.entry_index(ce)[1]),
                                    12 // shd.entry_index(ce)[1]),
                                shd.local(p["w"], "c", None), ce)) * c6).sum(),
                            lambda p: (torch.tanh(p["x"] @ p["w"]) * c6).sum()),
        }
        for name, (params, mesh_fn, whole_fn) in cases.items():
            model = SimpleNamespace(loss=lambda p, b, f=mesh_fn: f(p))
            loss, grads = value_and_grad_mesh(model, params, None)
            ref = {k: shd.full(v).detach().clone().requires_grad_()
                   for k, v in params.items()}
            rl = whole_fn(ref)
            rg = torch.autograd.grad(rl, list(ref.values()))
            out[f"coll/{name}/loss"] = np.array([float(loss), float(rl)])
            for (k, gv), r in zip(grads.items(), rg):
                out[f"coll/{name}/{k}"] = np.stack(
                    [shd.full(gv).numpy(), r.numpy()])
        try:
            shd.pmax(X.clone().requires_grad_(), re)
            out["coll/pmax_refused"] = np.array(False)
        except ValueError:
            out["coll/pmax_refused"] = np.array(True)
    return out

# ----------------------------------- serving bitwise with grad mode off
def parent_serving():
    # the serving-only port's code for everything training changed on the
    # serving path: the collectives (plain c10d calls, no autograd),
    # psum_matmul (widening through .float()) and the DLRM's mesh pooling
    # (masked slots gathered from row 0)
    from repro_torch.models import dlrm, moe
    from repro_torch.kernels import ops

    def psum(x, entry):
        mesh, dims = shd._mesh_dims(entry)
        for i in dims:
            x = shd._reduce(x, mesh, i, dist.ReduceOp.SUM)
        return x

    def all_gather(x, entry, dim):
        mesh, dims = shd._mesh_dims(entry)
        for i in reversed(dims):
            x = shd._gather(x, mesh, i, dim)
        return x

    def psum_matmul(x, w, entry):
        if entry is None:
            return L.matmul(x, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        return shd.psum(L.matmul(x.float(), w.float()), entry).to(dt)

    def _pool_mesh(self, emb, idx, use_kernel):
        tspec, rspec, _ = shd.spec(emb, *dlrm.EMBED_LOGICAL)
        blk = shd.local(emb, *dlrm.EMBED_LOGICAL)
        T, R, D = emb.shape
        T_loc, R_loc = blk.shape[:2]
        t0 = shd.entry_index(tspec)[0] * T_loc
        r0 = shd.entry_index(rspec)[0] * R_loc
        idx = shd.full(idx).to(torch.int64)
        tix = torch.arange(T, device=idx.device)[None, :, None]
        if use_kernel:
            g = (tix * R + idx.clamp(min=0)).clamp(max=T * R - 1)
            t, r = g // R, g % R
        else:
            t, r = tix, idx.clamp(max=R - 1)
        mine = ((idx >= 0) & (t >= t0) & (t < t0 + T_loc)
                & (r >= r0) & (r < r0 + R_loc))
        flat = torch.where(mine, (t - t0) * R_loc + (r - r0), -1)
        table = blk.reshape(T_loc * R_loc, D)
        if use_kernel:
            part = ops.embedding_bag_fused_flat(
                table, torch.zeros(T, dtype=torch.int32, device=idx.device),
                flat.to(torch.int32))
        else:
            part = torch.where(mine[..., None], table[flat.clamp(min=0)],
                               0.0).sum(dim=2)
        pooled = shd.psum(shd.psum(part, tspec), rspec)
        if not use_kernel:
            pooled = pooled.masked_fill((idx >= R).any(dim=2, keepdim=True),
                                        float("nan"))
        return pooled.to(emb.dtype)

    return [(shd, "psum", psum), (shd, "all_gather", all_gather),
            (shd, "_gather_ad",
             lambda x, mesh, i, dim: shd._gather(x, mesh, i, dim)),
            (L, "psum_matmul", psum_matmul), (moe, "psum_matmul", psum_matmul),
            (dlrm.DLRMModel, "_pool_mesh", _pool_mesh)]

def serve_outputs(mesh):
    outs = []
    for arch in ("smollm-135m", "qwen2-moe-a2.7b"):
        cfg = cfg_of(configs, arch)
        model = registry.build(cfg)
        params = tree(arch)
        toks = torch.from_numpy(inputs[arch + "/tokens"])
        pf, _, pr = build_program(cfg, ShapeConfig("p", toks.shape[1],
                                                   toks.shape[0], "prefill"),
                                  mesh, cache_len=2 * toks.shape[1])
        df, _, dr = build_program(cfg, ShapeConfig("d", 2 * toks.shape[1],
                                                   toks.shape[0], "decode"),
                                  mesh)
        pp = elastic.reshard_tree(params, model.param_specs(), mesh, pr)
        dp = elastic.reshard_tree(params, model.param_specs(), mesh, dr)
        lg, cache = pf(pp, {"tokens": toks})
        outs.append(lg.to_local())
        for _ in range(2):
            tok = shd.full(lg)[:, -1].argmax(-1)[:, None].to(torch.int32)
            lg, cache = df(dp, cache, {"tokens": tok})
            outs.append(lg.to_local())
    cfg = configs.get_reduced("rm1")
    model = registry.build(cfg)
    params = tree("rm1")
    rules = registry.make_rules(cfg, mesh, "prefill")
    placed = elastic.reshard_tree(params, model.param_specs(), mesh, rules)
    b = batch_of(inputs, "rm1")
    with torch.no_grad(), shd.use_mesh(mesh, rules):
        for k in (False, True):
            outs.append(model.serve_step(
                placed, {"dense": torch.from_numpy(b["dense"]),
                         "indices": torch.from_numpy(b["indices"])},
                use_kernel=k).to_local())
    return outs

def serving_bitwise(mesh):
    now = serve_outputs(mesh)
    patches = parent_serving()
    saved = [(o, k, getattr(o, k)) for o, k, _ in patches]
    for o, k, v in patches:
        setattr(o, k, v)
    try:
        before = serve_outputs(mesh)
    finally:
        for o, k, v in saved:
            setattr(o, k, v)
    return np.array([torch.equal(a, b) and a.grad_fn is None
                     for a, b in zip(now, before)])

try:
    out = {}
    for name, shape in spec["meshes"].items():
        mesh = make_host_mesh(shape[1], device="cpu")
        out[f"{name}/coord"] = np.array(mesh.get_coordinate())
        out.update({f"{name}/{k}": v
                    for k, v in collective_cases(mesh).items()})
        out[f"{name}/serve_bitwise"] = serving_bitwise(mesh)
        for arch in spec["archs"]:
            cfg = cfg_of(configs, arch)
            model = registry.build(cfg)
            batch = {k: torch.from_numpy(v)
                     for k, v in batch_of(inputs, arch).items()}
            B = next(iter(batch.values())).shape[0]
            S = batch["tokens"].shape[1] if "tokens" in batch else 1
            kinds = [("step", {}, 1)]
            if name == spec["compress_mesh"] and arch == spec["compress_arch"]:
                kinds += [("compress", {"compress_grads": True}, 1),
                          ("micro", {}, 2)]
            if name == next(iter(spec["meshes"])) and rank == 0:
                params = tree(arch)           # one device, once
                loss, grads = value_and_grad(model, params, batch)
                out[f"one/{arch}/loss"] = loss.numpy()
                whole(grads, f"one/{arch}/grad/", out)
                for tag, kw, mb in kinds:
                    ocfg = OptConfig(kind="adagrad" if cfg.family == "dlrm"
                                     else "adam", **kw)
                    p = tree(arch)
                    p, s, met = make_train_step(model, ocfg, mb)(
                        p, opt_mod.init_state(ocfg, p), batch)
                    whole(p, f"one/{arch}/{tag}/param/", out)
                    whole(s, f"one/{arch}/{tag}/state/", out)
            for tag, kw, mb in kinds:
                ocfg = OptConfig(kind="adagrad" if cfg.family == "dlrm"
                                 else "adam", **kw)
                step, (pm, om, bm), rules = build_program(
                    cfg, ShapeConfig("t", S, B, "train"), mesh, ocfg,
                    microbatches=mb)
                placed = elastic.reshard_tree(tree(arch), model.param_specs(),
                                              mesh, rules)
                with shd.use_mesh(mesh, rules):
                    sspecs = opt_mod.state_specs(ocfg, model.param_specs(),
                                                 model.param_shapes())
                    state = opt_mod.init_state(ocfg, placed, sspecs)
                    if tag == "step":
                        loss, grads = value_and_grad(model, placed, batch)
                        out[f"{name}/{arch}/loss"] = loss.numpy()
                        whole(grads, f"{name}/{arch}/grad/", out)
                if tag == "step":
                    out[f"{name}/{arch}/layout"] = np.array(
                        [layout(pm), layout(om), layout(bm),
                         layout(placed), layout(state)])
                p2, s2, met = step(placed, state, batch)
                out[f"{name}/{arch}/{tag}/loss"] = met["loss"].numpy()
                out[f"{name}/{arch}/{tag}/grad_norm"] = met["grad_norm"].numpy()
                whole(p2, f"{name}/{arch}/{tag}/param/", out)
                whole(s2, f"{name}/{arch}/{tag}/state/", out)
                if (name == spec["compress_mesh"] and tag == "step"
                        and arch in spec["elastic_archs"]):
                    ckpt.save(os.path.join(d, "ckpt", arch), p2, s2, 1)
        if name == spec["compress_mesh"]:
            # the survivors of a failure restore the checkpoints just saved
            small = elastic.healthy_mesh({"model": 2}, failed_fraction=0.4,
                                         device="cpu")
            out["elastic/devices"] = np.array(small.mesh.numel())
            for arch in spec["elastic_archs"]:
                cfg = cfg_of(configs, arch)
                model = registry.build(cfg)
                rules = registry.make_rules(cfg, small, "train")
                res = elastic.elastic_restore(os.path.join(d, "ckpt", arch),
                                              model, OptConfig(), small, rules)
                out[f"elastic/{arch}/member"] = np.array(res is not None)
                if res is not None:
                    p, s, step_no = res
                    out[f"elastic/{arch}/step"] = np.array(step_no)
                    whole({"p": p, "o": s}, f"elastic/{arch}/", out)
                    out[f"elastic/{arch}/layout"] = np.array(
                        [layout(p), layout(s)])
                    # restore_resharded: the params placed by the new
                    # mesh's shardings, the state as its (whole) template
                    tpl = tree_map(lambda t: torch.empty(
                        t.shape, dtype=t.dtype, device="meta"),
                        model.param_shapes())
                    with shd.use_mesh(small, rules):
                        pl = shd.tree_shardings_for_shapes(
                            model.param_specs(), model.param_shapes())
                        rp, rs, rstep = ckpt.restore_resharded(
                            os.path.join(d, "ckpt", arch), tpl,
                            opt_mod.init_state(OptConfig(), tpl), pl,
                            device="cpu")
                    out[f"elastic/{arch}/resharded"] = np.array(
                        [layout(rp) == layout(p), rstep == step_no]
                        + [torch.equal(shd.full(a), shd.full(b)) for a, b
                           in zip(tree_leaves(rp), tree_leaves(p))]
                        + [torch.equal(a, shd.full(b)) for a, b
                           in zip(tree_leaves(rs), tree_leaves(s))
                           if a is not None])
            # the fault-tolerant loop on the mesh and on one device
            arch = spec["compress_arch"]
            cfg = cfg_of(configs, arch)
            model = registry.build(cfg)
            runs = [("mesh", make_host_mesh(shape[1], device="cpu"))]
            if rank == 0:
                runs.append(("one", None))
            for tag, m in runs:
                fired = []

                def hook(step):
                    if step == spec["loop_fault_at"] and not fired:
                        fired.append(step)
                        raise RuntimeError("injected node failure")

                loader = ShardedLoader(lambda rng: lm_batch(
                    cfg.vocab_size, 4, 16, rng), seed=2)
                loop = TrainLoopConfig(
                    steps=spec["loop_steps"], log_every=1,
                    checkpoint_every=spec["loop_ckpt_every"],
                    checkpoint_dir=os.path.join(d, f"loop-{tag}"))
                rules = None if m is None else registry.make_rules(
                    cfg, m, "train")
                _, _, hist = run_train_loop(
                    model, OptConfig(), loader, loop, mesh=m, rules=rules,
                    params=tree(arch), fault_hook=hook,
                    log_fn=lambda *a: None, device="cpu")
                out[f"loop/{tag}"] = np.array(hist)
                out[f"loop/{tag}/fired"] = np.array(fired)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    np.savez(os.path.join(d, f"rank-{rank}.npz"), **out)
finally:
    dist.destroy_process_group()
"""


def _wait_all(procs):
    """Wait for every process within the timeout; kill any left over."""
    try:
        for what, proc in procs:
            try:
                _, err = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"{what} did not finish in {TIMEOUT_S} s")
            assert proc.returncode == 0, f"{what}:\n{err[-3000:]}"
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _inputs():
    rng = np.random.RandomState(5)
    out = {}
    for arch in ARCHS:
        cfg = _cfg(tconfigs, arch)
        if cfg.family == "dlrm":
            r = cfg.dlrm
            idx = rng.randint(0, r.rows_per_table, (DLRM_BATCH, r.num_tables,
                                                    r.avg_pooling))
            idx[rng.rand(*idx.shape) < 0.2] = -1
            out[f"{arch}/indices"] = idx.astype(np.int32)
            out[f"{arch}/dense"] = rng.randn(
                DLRM_BATCH, r.num_dense_features).astype(np.float32)
            out[f"{arch}/labels"] = rng.randint(0, 2, DLRM_BATCH).astype(
                np.int32)
            continue
        toks = rng.randint(0, cfg.vocab_size, (BATCH, SEQ + 1))
        out[f"{arch}/tokens"] = toks[:, :-1].astype(np.int32)
        out[f"{arch}/labels"] = toks[:, 1:].astype(np.int32)
    return out


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


def _spawn(what, script, *args):
    return (what, subprocess.Popen(
        [sys.executable, "-c", script, *args], env=_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The reference's results on each mesh and every port rank's, from
    one run of the subprocesses in parallel; then the reference's
    elastic restore of the checkpoint the port saved."""
    d = tmp_path_factory.mktemp("mesh_train")
    spec = {"archs": ARCHS, "meshes": {k: list(v)
                                       for k, v in RUN_MESHES.items()},
            "compress_mesh": "2x2", "compress_arch": COMPRESS_ARCH,
            "elastic_archs": ELASTIC_ARCHS, "loop_steps": LOOP_STEPS,
            "loop_ckpt_every": LOOP_CKPT_EVERY, "loop_fault_at": LOOP_FAULT_AT}
    (d / "spec.json").write_text(json.dumps(spec))
    np.savez(d / "inputs.npz", **_inputs())
    for i, arch in enumerate(ARCHS):
        m = jregistry.build(_cfg(jconfigs, arch))
        np.savez(d / f"{arch}.npz", **_flatten(noisy(m.init(0), 3 + i)))
    # all start together and are waited for shortest first, so that each
    # one's timeout runs from the end of the one before it
    runs = [("2x2", RUN_MESHES["2x2"], "extra")]
    runs += [(name, shape, "main") for name, shape in RUN_MESHES.items()]
    jax_procs = [_spawn(f"reference on {name} ({part})", JAX_SCRIPT, str(d),
                        name, json.dumps(shape), part)
                 for name, shape, part in runs]
    rank_procs = [_spawn(f"port rank {r}", RANK_SCRIPT, str(r), "4", str(d))
                  for r in range(4)]
    _wait_all(jax_procs[:1] + rank_procs + jax_procs[1:])
    _wait_all([_spawn("reference elastic_restore", JAX_ELASTIC, str(d))])
    ref = {name: dict(np.load(d / f"jax-{name}-main.npz"))
           for name in RUN_MESHES}
    ref["2x2"].update(np.load(d / "jax-2x2-extra.npz"))
    ref["elastic"] = dict(np.load(d / "jax-elastic.npz"))
    ranks = [dict(np.load(d / f"rank-{r}.npz")) for r in range(4)]
    ckpt = {a: dict(np.load(sorted((d / "ckpt" / a).glob("ckpt_*.npz"))[-1]))
            for a in ELASTIC_ARCHS}
    return ref, ranks, ckpt


CASES = [(a, m) for m in RUN_MESHES for a in ARCHS]


def _group(res, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix)}


def _close_grads(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(want[k]).max()) + 1e-12,
            err_msg=f"{what} {k}")


def _close(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {k}")


def _reference_grads(ref, arch):
    """The reference's gradient on its mesh: its own for RM1, else read
    from its train step's first Adam moment, m = (1 - b1) * clip * g
    from zero (clip from the step's gradient norm)."""
    grads = _group(ref, f"{arch}/grad/")
    if grads:
        return grads
    cfg = jopt.OptConfig()
    gnorm = float(ref[f"{arch}/step/grad_norm"])
    clip = min(1.0, cfg.grad_clip / max(gnorm, 1e-12))
    return {k: m / ((1 - cfg.b1) * clip)
            for k, m in _group(ref, f"{arch}/step/state/m/").items()}


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_grads_on_mesh(train_runs, arch, mesh):
    """Every rank's global loss within 1e-5 of the reference's mesh and
    of one device; every leaf's gradient, gathered whole, within rtol
    1e-4 of both (the reference's LM gradients read from its Adam
    step's first moment, which saves a compile per case)."""
    ref, ranks, _ = train_runs
    want = ref[mesh]
    one = _group(ranks[0], f"one/{arch}/grad/")
    for res in ranks:
        loss = float(res[f"{mesh}/{arch}/loss"])
        np.testing.assert_allclose(loss, float(want[f"{arch}/step/loss"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(loss, float(ranks[0][f"one/{arch}/loss"]),
                                   rtol=TOL, atol=TOL)
    got = _group(ranks[0], f"{mesh}/{arch}/grad/")
    _close_grads(got, _reference_grads(want, arch), "reference mesh")
    _close_grads(got, one, "one device")


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_step_on_mesh(train_runs, arch, mesh):
    """One step of ``build_program``'s train program (Adam; Adagrad for
    RM1, ZeRO-1 state): the params and the state gathered whole within
    1e-5 of the reference's step on its mesh and of one device's step;
    the metrics the same on every rank."""
    ref, ranks, _ = train_runs
    want = ref[mesh]
    for part in ("param", "state"):
        got = _group(ranks[0], f"{mesh}/{arch}/step/{part}/")
        _close(got, _group(want, f"{arch}/step/{part}/"), part)
        _close(got, _group(ranks[0], f"one/{arch}/step/{part}/"), part)
    for key in ("loss", "grad_norm"):
        vals = [float(r[f"{mesh}/{arch}/step/{key}"]) for r in ranks]
        assert len(set(vals)) == 1, (key, vals)
        np.testing.assert_allclose(vals[0], float(want[f"{arch}/step/{key}"]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_build_program_train_layout(train_runs, arch, mesh):
    """``build_program``'s example arguments (params, ZeRO-1 state,
    batch) are placed meta DTensors, laid out as the params
    ``reshard_tree`` places and the state ``init_state(..., specs)``
    makes; the state shards over data where the weights do not."""
    _, ranks, _ = train_runs
    for res in ranks:
        pm, om, bm, placed, state = (json.loads(str(s)) for s in
                                     res[f"{mesh}/{arch}/layout"])
        assert pm == placed and om == state
        assert {tuple(v[2]) for v in bm.values()} <= {
            ("data", None), ("data", None, None), ("data",),
            (None, None), (None, None, None), (None,)}
        if RUN_MESHES[mesh][0] > 1 and arch != "rm1":
            zero = [p for p, v in om.items() if p.startswith("/m/")
                    and "data" in v[2] and "data" not in pm[p[2:]][2]]
            assert zero, om


@pytest.mark.parametrize("tag", ["compress", "micro"])
def test_compress_and_microbatch_steps(train_runs, tag):
    """``compress_grads=True`` (the int8 step, its error-feedback
    residuals included) and ``microbatches=2``: the params and state
    after one step within 1e-5 of the reference's and one device's."""
    ref, ranks, _ = train_runs
    arch, mesh = COMPRESS_ARCH, "2x2"
    for part in ("param", "state"):
        got = _group(ranks[0], f"{mesh}/{arch}/{tag}/{part}/")
        assert (part == "param" or tag == "micro"
                or any(k.startswith("err/") for k in got))
        _close(got, _group(ref[mesh], f"{arch}/{tag}/{part}/"), part)
        _close(got, _group(ranks[0], f"one/{arch}/{tag}/{part}/"), part)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(
            float(ranks[0][f"{mesh}/{arch}/{tag}/{key}"]),
            float(ref[mesh][f"{arch}/{tag}/{key}"]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ELASTIC_ARCHS)
def test_elastic_restore_onto_survivors(train_runs, arch):
    """A checkpoint saved from (2, 2) restored by ``elastic_restore``
    onto ``healthy_mesh({"model": 2}, 0.4)``: the two survivors hold the
    file's arrays bitwise (llama3-8b: as the reference's
    ``elastic_restore`` of the same file does), the state laid out
    ZeRO-1 on the new mesh's ``data`` axis of 1; the other ranks get
    None.  ``checkpoint.restore_resharded`` with the new mesh's
    shardings places the same params and restores the same state."""
    ref, ranks, ckpt = train_runs
    want = ckpt[arch]
    members = [r for r in ranks if bool(r[f"elastic/{arch}/member"])]
    assert len(members) == int(ranks[0]["elastic/devices"]) == 2
    if arch == ELASTIC_ARCHS[0]:
        jel = ref["elastic"]
        assert int(jel["devices"]) == 2 and int(jel["step"]) == 1
        assert sorted(k for k in jel if "/" in k) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(jel[k], v, err_msg=k)
    for res in members:
        assert int(res[f"elastic/{arch}/step"]) == 1
        got = _group(res, f"elastic/{arch}/")
        params, state = (json.loads(str(s)) for s in got.pop("layout"))
        resharded = got.pop("resharded")
        assert resharded.all(), resharded
        got.pop("step"), got.pop("member")
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        # blocks of a (data 1, model 2) mesh: a dim over model halves
        sizes = {"data": 1, "model": 2}
        for shape, _, entries, loc in (list(params.values())
                                       + list(state.values())):
            cut = [int(np.prod([sizes[a] for a in ([e] if isinstance(e, str)
                                                   else e or [])]))
                   for e in entries]
            assert loc == [n // c for n, c in zip(shape, cut)]
        assert any(v[3] != v[0] for v in params.values())
        assert any("data" in json.dumps(v[2]) for p, v in state.items()
                   if p.startswith("/m/"))


def test_run_train_loop_on_mesh(train_runs):
    """``run_train_loop(mesh=, rules=)`` on (2, 2): a fault at step 3
    restores the checkpoint of step 2 on every rank, and every logged
    loss is within 1e-5 of one device's loop through the same fault."""
    _, ranks, _ = train_runs
    want = ranks[0]["loop/one"]
    steps = [0, 1, 2, 2, 3, 4]          # step 2 again after the restore
    assert want[:, 0].tolist() == steps
    for res in ranks:
        assert res["loop/mesh/fired"].tolist() == [LOOP_FAULT_AT]
        got = res["loop/mesh"]
        assert got[:, 0].tolist() == steps
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mesh", list(RUN_MESHES))
@pytest.mark.parametrize("case", ["psum", "all_gather", "redistribute",
                                  "local", "psum_matmul"])
def test_collective_gradients(train_runs, case, mesh):
    """fp64: the collective's loss on the mesh equals the whole-tensor
    function's, and each input's gradient (each rank's, summed over the
    ranks holding a copy, gathered whole) equals autograd's of the whole
    function, on every rank."""
    _, ranks, _ = train_runs
    for res in ranks:
        got = _group(res, f"{mesh}/coll/{case}/")
        loss = got.pop("loss")
        np.testing.assert_allclose(loss[0], loss[1], rtol=1e-12, atol=1e-12)
        assert got
        for k, (g, want) in got.items():
            np.testing.assert_allclose(g, want, rtol=1e-12, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_pmax_refuses_grad(train_runs, mesh):
    """``pmax`` has no gradient: a grad-requiring input raises."""
    _, ranks, _ = train_runs
    assert all(bool(r[f"{mesh}/coll/pmax_refused"]) for r in ranks)


@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_serving_paths_bitwise_with_grad_off(train_runs, mesh):
    """With grad mode off, smollm's and qwen2-moe's mesh prefill and
    decode and RM1's mesh scores (both pooling paths) are bitwise what
    the serving-only port's collectives, ``psum_matmul`` and mesh
    pooling give, with no autograd graph."""
    _, ranks, _ = train_runs
    for res in ranks:
        ok = res[f"{mesh}/serve_bitwise"]
        assert ok.size == 8 and ok.all(), ok

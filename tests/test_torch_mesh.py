"""Serving on a mesh: the port's ``distributed.sharding`` rules, the mesh
branches of its models and ``launch.steps.build_program`` against the
reference's, and against the port's own single-device results.

- Pure Python: ``registry.make_rules`` equals the reference's for every
  arch x mode x mesh shape, and ``resolve_for_shape`` equals the
  reference's ``PartitionSpec`` for every parameter leaf, every
  ``input_logical`` leaf and every ``cache_logical`` leaf of every arch
  (mesh shapes as dicts; the reference reads only the mesh's ``shape``
  there).
- Meshes (data 2, model 2) and (1, 4): the reference runs in one JAX
  subprocess per mesh with four host devices (``XLA_FLAGS``), its meshes
  built as ``jax.sharding.Mesh(devices.reshape(shape), names)``, whose
  axes are Auto (``jax.make_mesh`` in JAX 0.9 builds Explicit axes, on
  which the reference's ``with_sharding_constraint`` raises).  The port
  runs in 4 gloo rank processes that import no JAX, joined by a
  ``file://`` store.  Every subprocess has a 120 s timeout.
- Reduced fp32 configs with the reference's weights (plus seeded noise,
  so that zero-initialised leaves act): llama3-8b cut to 2 layers and
  8/4 heads (head-TP with GQA), smollm's and qwen2-moe's ``REDUCED``
  (FSDP + context parallelism at model 4 and FSDP at model 2; head-TP
  and EP), RM1's reduced.  The LM runs give qwen2-moe capacity factor
  8.0, as ``test_multidevice.py`` does, so that no pair is dropped:
  with drops a mesh keeps what its per-shard capacity keeps (rounded up
  to a multiple of 8, as the reference rounds it), which one device
  does not.  The MoE FFN alone keeps the config's 1.25, drops and all,
  against the reference's mesh.  Each rank's prefill logits and cache block
  (prefill rules), 4 greedy decode steps (decode rules: the cache
  sequence-sharded), the MoE FFN's route ids and output, DLRM scores
  through ``DLRMServingEngine(mesh, rules)`` with replicated and
  ``reshard_tree``-placed params and after ``healthy_mesh``: within
  1e-5 of the reference's mesh result and of the port's single-device
  result, greedy tokens equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tshd
from repro_torch.models import registry as tregistry

from _torch_zoo import noisy

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TOL = 1e-5
MESH_SHAPES = {"1x1": (1, 1), "2x2": (2, 2), "1x4": (1, 4), "16x16": (16, 16)}
MODES = ["train", "prefill", "decode"]
#: the meshes the subprocesses run, (data, model)
RUN_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
LM_ARCHS = ["llama3-8b", "smollm-135m", "qwen2-moe-a2.7b"]
BATCH, PROMPT, CACHE, STEPS = 4, 16, 32, 4


class _ShapeMesh:
    """A mesh of a given shape for the reference's rule resolution,
    which reads only ``mesh.shape`` (no 256 devices exist here)."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------- rules
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_make_rules_match(arch, mode, mesh):
    shape = MESH_SHAPES[mesh]
    want = jregistry.make_rules(jconfigs.get_config(arch), _ShapeMesh(shape),
                                mode)
    got = tregistry.make_rules(tconfigs.get_config(arch),
                               dict(zip(("data", "model"), shape)), mode)
    assert got == want


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


SPEC_ARCHS = [a for a in tconfigs.list_archs()
              if tconfigs.get_config(a).family in ("dense", "moe", "vlm",
                                                   "dlrm", "audio", "hybrid",
                                                   "ssm")]


@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_resolve_for_shape_matches(arch, mode, mesh):
    """Every parameter leaf's spec, resolved for its shape, equals the
    reference's ``PartitionSpec`` entry for entry."""
    shape = MESH_SHAPES[mesh]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    jmesh = _ShapeMesh(shape)
    tmesh = dict(zip(("data", "model"), shape))
    jrules = jregistry.make_rules(jcfg, jmesh, mode)
    trules = tregistry.make_rules(tcfg, tmesh, mode)
    jspecs = jax.tree.map(lambda x: x, jm.param_specs(),
                          is_leaf=lambda x: isinstance(x, tuple))
    jshapes = jax.tree.map(lambda s: s.shape, jm.param_shapes())
    want, got = {}, {}
    with jshd.use_mesh(jmesh, jrules):
        for (path, names), (_, shp) in zip(
                _leaves(jspecs), _leaves(jshapes)):
            want[path] = tuple(jshd.resolve_for_shape(names, shp))
    with tshd.use_mesh(tmesh, trules):
        for (path, names), (_, s) in zip(
                _leaves(tm.param_specs()), _leaves(tm.param_shapes())):
            got[path] = tshd.resolve_for_shape(names, s.shape)
    assert got == want
    assert any(e is not None for spec in got.values() for e in spec) or \
        shape == (1, 1)


@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_input_and_cache_specs_match(arch, mode, mesh):
    """Every ``input_logical`` leaf of a ``mode`` cell (batch 32, 2048
    positions) and every ``cache_logical`` leaf, resolved for its shape
    under the mode's rules, equals the reference's ``PartitionSpec``
    entry for entry (an input without logical names is unsharded in
    both)."""
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig as TShape

    shape = MESH_SHAPES[mesh]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    jmesh = _ShapeMesh(shape)
    tmesh = dict(zip(("data", "model"), shape))
    jshape, tshape = JShape("s", 2048, 32, mode), TShape("s", 2048, 32, mode)
    jrules = jregistry.make_rules(jcfg, jmesh, mode)
    trules = tregistry.make_rules(tcfg, tmesh, mode)

    def resolved(shd, model, cell, sizes):
        logical = model.input_logical(cell)
        out = {f"/input/{k}": tuple(shd.resolve_for_shape(
            logical.get(k) or (None,) * len(v.shape), tuple(v.shape)))
            for k, v in model.input_specs(cell).items()}
        if hasattr(model, "cache_logical"):
            specs = model.cache_specs(cell)
            leaves = dict(_leaves(sizes(specs)))
            for path, names in _leaves(model.cache_logical(cell)):
                out["/cache" + path] = tuple(shd.resolve_for_shape(
                    names, leaves[path]))
        return out

    def jsizes(specs):
        return jax.tree.map(lambda s: tuple(s.shape), specs)

    def tsizes(specs):
        from repro_torch.models.params import tree_map
        return tree_map(lambda s: tuple(s.shape), specs)

    with jshd.use_mesh(jmesh, jrules):
        want = resolved(jshd, jm, jshape, jsizes)
    with tshd.use_mesh(tmesh, trules):
        got = resolved(tshd, tm, tshape, tsizes)
    assert got == want
    assert any(e is not None for spec in got.values() for e in spec) or \
        shape == (1, 1)


# ------------------------------------------------------------- meshes
def _lm_cfg(pkg, arch):
    cfg = pkg.get_reduced(arch).replace(dtype="float32",
                                        param_dtype="float32")
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


JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ShapeConfig
from repro.distributed import elastic, sharding as shd
from repro.launch.steps import build_program
from repro.models import moe as moe_mod, registry
from repro.models.transformer import pad_cache
from repro.serving.engine import DLRMServingEngine, Request
d, name, shape = sys.argv[1], sys.argv[2], tuple(json.loads(sys.argv[3]))
spec = json.loads(open(os.path.join(d, "spec.json")).read())
mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))

def tree(prefix):
    data = np.load(os.path.join(d, prefix + ".npz"))
    out = {}
    for k in data.files:
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(data[k])
    return out

def lm_cfg(arch):
    cfg = configs.get_reduced(arch).replace(dtype="float32",
                                            param_dtype="float32")
    if arch == "llama3-8b":
        cfg = cfg.replace(num_layers=2, d_model=64, num_heads=8,
                          num_kv_heads=4, d_ff=128, vocab_size=256,
                          head_dim=16)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg

inputs = np.load(os.path.join(d, "inputs.npz"))
out = {}
B, S, T, steps = spec["batch"], spec["prompt"], spec["cache"], spec["steps"]
for arch in spec["lm_archs"]:
    cfg = lm_cfg(arch)
    params = tree(arch)
    pf, _, _ = build_program(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    df, _, _ = build_program(cfg, ShapeConfig("d", T, B, "decode"), mesh)
    logits, cache = pf(params, {"tokens": jnp.asarray(inputs[arch])})
    out[f"{arch}/prefill"] = np.asarray(logits)
    cache = {"k": pad_cache(cache["k"], T), "v": pad_cache(cache["v"], T),
             "pos": cache["pos"]}
    out[f"{arch}/cache_k"] = np.asarray(cache["k"])
    out[f"{arch}/cache_v"] = np.asarray(cache["v"])
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    toks, dl = [np.asarray(tok)], []
    for _ in range(steps):
        logits, cache = df(params, cache, {"tokens": tok})
        dl.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    out[f"{arch}/decode"] = np.stack(dl)
    out[f"{arch}/tokens"] = np.concatenate(toks, 1)
    out[f"{arch}/decode_k"] = np.asarray(cache["k"])

# the MoE FFN alone: route ids and output under prefill rules
mcfg = configs.get_reduced("qwen2-moe-a2.7b").replace(
    dtype="float32", param_dtype="float32")
mp = jax.tree.map(lambda a: a[0], tree("qwen2-moe-a2.7b")["layers"]["moe"])
x = jnp.asarray(inputs["moe_x"])
rules = registry.make_rules(mcfg, mesh, "prefill")
with shd.use_mesh(mesh, rules):
    y, _ = jax.jit(lambda p, x: moe_mod.moe_apply(p, x, mcfg))(mp, x)
    _, ids, _ = jax.jit(lambda x, r: moe_mod._route(x, r, mcfg))(
        x.reshape(-1, x.shape[-1]), mp["router"])
out["moe/y"], out["moe/ids"] = np.asarray(y), np.asarray(ids)

# DLRM through the engine: replicated, resharded, then a healthy mesh
cfg = configs.get_reduced("rm1")
model = registry.build(cfg)
params = tree("rm1")
reqs = [Request(i, {"dense": inputs[f"rm1/dense{i}"],
                    "indices": inputs[f"rm1/idx{i}"]},
                inputs[f"rm1/idx{i}"].shape[0], 0.0)
        for i in range(spec["dlrm_requests"])]
rules = registry.make_rules(cfg, mesh, "prefill")

def scores(p, m):
    eng = DLRMServingEngine(model, p, batch_size=spec["dlrm_batch"], mesh=m,
                            rules=rules)
    return np.concatenate([r.outputs for r in eng.serve(reqs)])

out["dlrm/replicated"] = scores(params, mesh)
out["dlrm/resharded"] = scores(
    elastic.reshard_tree(params, model.param_specs(), mesh, rules), mesh)
small = elastic.healthy_mesh({"model": shape[1]}, failed_fraction=0.4,
                             devices=list(mesh.devices.flat))
out["dlrm/healthy_devices"] = np.array(small.devices.size)
out["dlrm/healthy"] = scores(
    elastic.reshard_tree(params, model.param_specs(), small, rules), small)
np.savez(os.path.join(d, f"jax-{name}.npz"), **out)
"""

RANK_SCRIPT = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "store"), rank=rank, world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import elastic, sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_program
from repro_torch.models import moe as moe_mod, registry
from repro_torch.models.layers import batch_pspec_entry
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import params_from_reference
from repro_torch.serving.engine import DLRMServingEngine, Request
spec = json.loads(open(os.path.join(d, "spec.json")).read())
inputs = np.load(os.path.join(d, "inputs.npz"))
B, S, T, steps = spec["batch"], spec["prompt"], spec["cache"], spec["steps"]

def tree(prefix):
    data = np.load(os.path.join(d, prefix + ".npz"))
    out = {}
    for k in data.files:
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = data[k]
    return params_from_reference(out, device="cpu")

def lm_cfg(arch):
    cfg = configs.get_reduced(arch).replace(dtype="float32",
                                            param_dtype="float32")
    if arch == "llama3-8b":
        cfg = cfg.replace(num_layers=2, d_model=64, num_heads=8,
                          num_kv_heads=4, d_ff=128, vocab_size=256,
                          head_dim=16)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg

def layout(tree):
    # every leaf of a placed tree: [shape, dtype, one entry per dim (the
    # mesh axes sharding it, in mesh order), local shape, local device]
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif t is not None:
            dims = t.device_mesh.mesh_dim_names
            ent = []
            for dim in range(t.dim()):
                axes = [dims[i] for i, p in enumerate(t.placements)
                        if p.is_shard(dim)]
                ent.append(None if not axes else axes[0] if len(axes) == 1
                           else axes)
            out[path] = [list(t.shape), str(t.dtype).split(".")[-1], ent,
                         list(t.to_local().shape), t.to_local().device.type]
    walk(tree, "")
    return json.dumps(out)

def greedy(logits):
    return logits[:, -1].argmax(-1)[:, None].to(torch.int32)

def refused(mesh):
    # each kernel wrapper, given a DTensor operand, raises TypeError
    # naming its kernel (before any launch or plain version runs)
    from repro_torch.kernels import ops
    with shd.use_mesh(mesh, None):
        dt = lambda t: shd.place(t, (None,) * t.dim())
        f32 = lambda *s: torch.zeros(s)
        i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
        calls = {
            "embedding_bag": lambda: ops.embedding_bag(dt(f32(2, 5, 4)),
                                                       i32(3, 2, 2)),
            "embedding_bag_fused_flat": lambda: ops.embedding_bag_fused_flat(
                f32(10, 4), i32(2), dt(i32(3, 2, 2))),
            "embedding_bag_nmp_flat": lambda: ops.embedding_bag_nmp_flat(
                dt(f32(10, 4)), i32(2), i32(3, 2, 2)),
            "flash_attention": lambda: ops.flash_attention(
                f32(1, 2, 8, 16), dt(f32(1, 2, 8, 16)), f32(1, 2, 8, 16)),
            "flash_decode_partial": lambda: ops.flash_decode_partial(
                f32(1, 2, 16), f32(1, 8, 2, 16), dt(f32(1, 8, 2, 16)),
                torch.tensor(3)),
        }
        ok = []
        for kernel, call in calls.items():
            try:
                call()
                ok.append(False)
            except TypeError as e:
                ok.append(kernel in str(e) and "DTensor" in str(e))
    return np.array(ok)

try:
    out = {}
    for name, shape in spec["meshes"].items():
        mesh = make_host_mesh(shape[1], device="cpu")
        out[f"{name}/coord"] = np.array(mesh.get_coordinate())
        out[f"{name}/refused"] = refused(mesh)
        for arch in spec["lm_archs"]:
            cfg = lm_cfg(arch)
            model = registry.build(cfg)
            params = tree(arch)
            toks = torch.from_numpy(inputs[arch])
            if name == next(iter(spec["meshes"])):   # one device, once
                lg, c = model.prefill(params, {"tokens": toks}, cache_len=T)
                out[f"one/{arch}/prefill"] = lg.numpy()
                out[f"one/{arch}/cache_k"] = c["k"].numpy().copy()
                tok, tl, dl = greedy(lg), [greedy(lg)], []
                for _ in range(steps):
                    lg, c = model.decode_step(params, c, {"tokens": tok})
                    dl.append(lg.numpy())
                    tok = greedy(lg)
                    tl.append(tok)
                out[f"one/{arch}/decode"] = np.stack(dl)
                out[f"one/{arch}/tokens"] = torch.cat(tl, 1).numpy()
            pf, pargs, prules = build_program(
                cfg, ShapeConfig("p", S, B, "prefill"), mesh, cache_len=T)
            df, dargs, drules = build_program(
                cfg, ShapeConfig("d", T, B, "decode"), mesh)
            placed = elastic.reshard_tree(params, model.param_specs(), mesh,
                                          prules)
            same = all(tree_leaves(tree_map(
                lambda a, b: a.placements == b.placements
                and a.shape == b.shape and a.dtype == b.dtype
                and a.to_local().shape == b.to_local().shape,
                pargs[0], placed)))
            out[f"{name}/{arch}/example_args_match"] = np.array(same)
            logits, cache = pf(placed, {"tokens": toks})
            out[f"{name}/{arch}/prefill"] = logits.to_local().numpy()
            # copies: decode writes the cache in place
            out[f"{name}/{arch}/cache_k"] = cache["k"].to_local().numpy().copy()
            out[f"{name}/{arch}/cache_v"] = cache["v"].to_local().numpy().copy()
            dparams = elastic.reshard_tree(placed, model.param_specs(), mesh,
                                           drules)
            tok = greedy(shd.full(logits))
            tl, dl = [tok], []
            for _ in range(steps):
                logits, cache = df(dparams, cache, {"tokens": tok})
                dl.append(logits.to_local().numpy())
                tok = greedy(shd.full(logits))
                tl.append(tok)
            out[f"{name}/{arch}/decode"] = np.stack(dl)
            out[f"{name}/{arch}/tokens"] = torch.cat(tl, 1).numpy()
            out[f"{name}/{arch}/decode_k"] = cache["k"].to_local().numpy()
            _, targs, _ = build_program(cfg, ShapeConfig("t", S, B, "train"),
                                        mesh)
            out[f"{name}/{arch}/train_layout"] = np.array(
                [layout(t) for t in targs])

        mcfg = configs.get_reduced("qwen2-moe-a2.7b").replace(
            dtype="float32", param_dtype="float32")
        mp = tree_map(lambda t: t[0],
                      tree("qwen2-moe-a2.7b")["layers"]["moe"])
        x = torch.from_numpy(inputs["moe_x"])
        rules = registry.make_rules(mcfg, mesh, "prefill")
        # the ids the EP branch dispatches on this rank, and the experts
        # it computes, recorded where moe_apply uses them
        dispatch, compute, seen = (moe_mod.dispatch, moe_mod._expert_compute,
                                   {})

        def recorded_dispatch(ids, Ep, capacity):
            seen["ids"] = ids
            return dispatch(ids, Ep, capacity)

        def recorded_compute(xbuf, wg, wu, wo):
            seen["experts"] = xbuf.shape[0]
            return compute(xbuf, wg, wu, wo)

        moe_mod.dispatch = recorded_dispatch
        moe_mod._expert_compute = recorded_compute
        try:
            with shd.use_mesh(mesh, rules):
                be = batch_pspec_entry(x.shape[0], mesh)
                y, _ = moe_mod.moe_apply(
                    mp, shd.local(x, "batch", None, None), mcfg,
                    batch_entry=be)
        finally:
            moe_mod.dispatch, moe_mod._expert_compute = dispatch, compute
        out[f"{name}/moe/y"] = y.numpy()
        out[f"{name}/moe/ids"] = seen["ids"].numpy()
        out[f"{name}/moe/experts"] = np.array(seen["experts"])

        cfg = configs.get_reduced("rm1")
        model = registry.build(cfg)
        params = tree("rm1")
        _, targs, _ = build_program(cfg, ShapeConfig("t", 1, spec["dlrm_batch"],
                                                     "train"), mesh)
        out[f"{name}/rm1/train_layout"] = np.array([layout(t) for t in targs])
        reqs = [Request(i, {"dense": inputs[f"rm1/dense{i}"],
                            "indices": inputs[f"rm1/idx{i}"]},
                        inputs[f"rm1/idx{i}"].shape[0], 0.0)
                for i in range(spec["dlrm_requests"])]
        rules = registry.make_rules(cfg, mesh, "prefill")

        def scores(p, m, k=False):
            eng = DLRMServingEngine(model, p, batch_size=spec["dlrm_batch"],
                                    device="cpu", mesh=m, rules=rules,
                                    use_kernel=k)
            return np.concatenate([r.outputs for r in eng.serve(reqs)])

        for k in (False, True):
            out[f"one/dlrm/{k}"] = scores(params, None, k)
            out[f"{name}/dlrm/replicated/{k}"] = scores(params, mesh, k)
            placed = elastic.reshard_tree(params, model.param_specs(), mesh,
                                          rules)
            out[f"{name}/dlrm/resharded/{k}"] = scores(placed, mesh, k)
            small = elastic.healthy_mesh({"model": shape[1]},
                                         failed_fraction=0.4, device="cpu")
            out[f"{name}/dlrm/healthy_devices"] = np.array(small.mesh.numel())
            sp = elastic.reshard_tree(placed, model.param_specs(), small, rules)
            if sp is not None:
                out[f"{name}/dlrm/healthy/{k}"] = scores(sp, small, k)
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
    rng = np.random.RandomState(7)
    out = {}
    for arch in LM_ARCHS:
        vocab = _lm_cfg(tconfigs, arch).vocab_size
        out[arch] = rng.randint(0, vocab, (BATCH, PROMPT)).astype(np.int32)
    d = _lm_cfg(tconfigs, "qwen2-moe-a2.7b").d_model
    out["moe_x"] = rng.randn(BATCH, PROMPT, d).astype(np.float32)
    r = tconfigs.get_reduced("rm1").dlrm
    for i in range(5):                     # 3..7 rows each, -1 padded
        n = 3 + i
        idx = rng.randint(0, r.rows_per_table, (n, r.num_tables,
                                                r.avg_pooling))
        idx[rng.rand(*idx.shape) < 0.2] = -1
        out[f"rm1/idx{i}"] = idx.astype(np.int32)
        out[f"rm1/dense{i}"] = rng.randn(n, r.num_dense_features).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's results on each mesh and every port rank's, from
    one run of the subprocesses in parallel."""
    d = tmp_path_factory.mktemp("mesh")
    spec = {"batch": BATCH, "prompt": PROMPT, "cache": CACHE,
            "steps": STEPS, "lm_archs": LM_ARCHS, "dlrm_requests": 5,
            "dlrm_batch": 8, "meshes": {k: list(v)
                                        for k, v in RUN_MESHES.items()}}
    (d / "spec.json").write_text(json.dumps(spec))
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    for arch in LM_ARCHS:
        m = jregistry.build(_lm_cfg(jconfigs, arch))
        np.savez(d / f"{arch}.npz", **_flatten(noisy(m.init(0), 3)))
    rm = jregistry.build(jconfigs.get_reduced("rm1"))
    np.savez(d / "rm1.npz", **_flatten(noisy(rm.init(0), 5)))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [(f"reference on {name}", subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d), name, json.dumps(shape)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for name, shape in RUN_MESHES.items()]
    for rank in range(4):
        procs.append((f"port rank {rank}", subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(rank), "4", str(d)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    _wait_all(procs)
    ref = {name: dict(np.load(d / f"jax-{name}.npz")) for name in RUN_MESHES}
    ranks = [dict(np.load(d / f"rank-{r}.npz")) for r in range(4)]
    return ref, ranks


def _block(x, coord, shape, dims):
    """The block of ``x`` at mesh ``coord`` with ``dims`` = {tensor dim:
    mesh dim} sharded (even splits)."""
    for td, md in dims.items():
        n = shape[md]
        step = x.shape[td] // n
        x = np.take(x, range(coord[md] * step, (coord[md] + 1) * step), td)
    return x


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


CASES = [(a, m) for m in RUN_MESHES for a in LM_ARCHS]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_logits_and_cache_blocks(mesh_runs, arch, mesh):
    """Each rank's logits block (batch over data, vocab over model) and
    its block of the cache (batch over data, sequence over model)."""
    ref, ranks = mesh_runs
    shape = RUN_MESHES[mesh]
    for res in ranks:
        coord = res[f"{mesh}/coord"]
        logits = res[f"{mesh}/{arch}/prefill"]
        _close(logits, _block(ref[mesh][f"{arch}/prefill"], coord, shape,
                              {0: 0, 2: 1}))
        _close(logits, _block(ranks[0][f"one/{arch}/prefill"], coord, shape,
                              {0: 0, 2: 1}))
        for kv in ("k", "v"):
            _close(res[f"{mesh}/{arch}/cache_{kv}"],
                   _block(ref[mesh][f"{arch}/cache_{kv}"], coord, shape,
                          {1: 0, 2: 1}))
        _close(res[f"{mesh}/{arch}/cache_k"],
               _block(ranks[0][f"one/{arch}/cache_k"], coord, shape,
                      {1: 0, 2: 1}))
        assert bool(res[f"{mesh}/{arch}/example_args_match"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_decode_steps_seq_sharded(mesh_runs, arch, mesh):
    """4 greedy steps under the decode rules: tokens equal to the
    reference's mesh run and to one device; each step's logits block and
    the written cache block within 1e-5."""
    ref, ranks = mesh_runs
    shape = RUN_MESHES[mesh]
    want_tokens = ref[mesh][f"{arch}/tokens"]
    np.testing.assert_array_equal(ranks[0][f"one/{arch}/tokens"], want_tokens)
    for res in ranks:
        coord = res[f"{mesh}/coord"]
        np.testing.assert_array_equal(res[f"{mesh}/{arch}/tokens"],
                                      want_tokens)
        got = res[f"{mesh}/{arch}/decode"]
        _close(got, _block(ref[mesh][f"{arch}/decode"], coord, shape,
                           {1: 0, 3: 1}))
        _close(got, _block(ranks[0][f"one/{arch}/decode"], coord, shape,
                           {1: 0, 3: 1}))
        _close(res[f"{mesh}/{arch}/decode_k"],
               _block(ref[mesh][f"{arch}/decode_k"], coord, shape,
                      {1: 0, 2: 1}))


@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_moe_expert_parallel_routes(mesh_runs, mesh):
    """The MoE FFN under prefill rules (EP over model, tokens over
    data): the ids each rank's EP dispatch routes are the reference's
    for its block of tokens, it computes its E_pad/ep experts, and each
    rank's token block of the output is within 1e-5."""
    ref, ranks = mesh_runs
    shape = RUN_MESHES[mesh]
    experts = tconfigs.get_reduced("qwen2-moe-a2.7b").moe.padded_experts
    for res in ranks:
        coord = res[f"{mesh}/coord"]
        np.testing.assert_array_equal(
            res[f"{mesh}/moe/ids"],
            _block(ref[mesh]["moe/ids"], coord, shape, {0: 0}))
        assert int(res[f"{mesh}/moe/experts"]) == experts // shape[1]
        _close(res[f"{mesh}/moe/y"], _block(ref[mesh]["moe/y"], coord,
                                            shape, {0: 0}))


@pytest.mark.parametrize("placement", ["replicated", "resharded"])
@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_dlrm_scores_on_mesh(mesh_runs, mesh, placement):
    """``DLRMServingEngine(mesh, rules)``: the reference's mesh scores
    (its jnp path) within 1e-5, and the port's single-device scores
    within 1e-5 with and without the bag kernel, on every rank."""
    ref, ranks = mesh_runs
    for res in ranks:
        _close(res[f"{mesh}/dlrm/{placement}/False"],
               ref[mesh][f"dlrm/{placement}"])
        for k in (False, True):
            _close(res[f"{mesh}/dlrm/{placement}/{k}"], res[f"one/dlrm/{k}"])


@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_healthy_mesh_reshard_and_serve(mesh_runs, mesh):
    """``healthy_mesh({"model": m}, 0.4)`` keeps int(4 * 0.6) // m * m
    ranks, as the reference keeps devices; the survivors serve the
    resharded params with the same scores."""
    ref, ranks = mesh_runs
    assert int(ranks[0][f"{mesh}/dlrm/healthy_devices"]) == int(
        ref[mesh]["dlrm/healthy_devices"])
    served = [res for res in ranks if f"{mesh}/dlrm/healthy/False" in res]
    assert len(served) == int(ref[mesh]["dlrm/healthy_devices"])
    for res in served:
        _close(res[f"{mesh}/dlrm/healthy/False"], ref[mesh]["dlrm/healthy"])
        _close(res[f"{mesh}/dlrm/healthy/True"], res["one/dlrm/True"])


@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_kernel_wrappers_refuse_dtensor(mesh_runs, mesh):
    """``kernels.ops``: every wrapper raises on a DTensor operand, naming
    its kernel, on every rank (the CPU branch included)."""
    _, ranks = mesh_runs
    for res in ranks:
        assert res[f"{mesh}/refused"].tolist() == [True] * 5


def _entries(spec, ndim):
    """A PartitionSpec's entries as JSON-like lists, padded to ``ndim``."""
    out = [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]
    return out + [None] * (ndim - len(out))


def _reference_train_layout(arch, shape):
    """The reference's ``build_program(train)`` example args and their
    resolved specs, in pure Python (its rule resolution reads only the
    mesh's shape): params resolved for their shapes, the ZeRO-1 state
    by ``tree_shardings`` (as its ``build_program`` resolves it), the
    batch for its shapes."""
    from repro.configs.base import ShapeConfig
    from repro.train import optimizer as jopt

    cfg = (jconfigs.get_reduced("rm1") if arch == "rm1"
           else _lm_cfg(jconfigs, arch))
    model = jregistry.build(cfg)
    mesh = _ShapeMesh(shape)
    rules = jregistry.make_rules(cfg, mesh, "train")
    sc = (ShapeConfig("t", 1, 8, "train") if arch == "rm1"
          else ShapeConfig("t", PROMPT, BATCH, "train"))
    opt_cfg = jopt.OptConfig()
    with jshd.use_mesh(mesh, rules):
        pshapes = model.param_shapes()
        specs = model.param_specs()
        sspecs = jopt.state_specs(opt_cfg, specs, pshapes)
        oshapes = jax.eval_shape(lambda: jopt.init_state(opt_cfg, jax.tree.map(
            lambda s: jax.numpy.zeros(s.shape, s.dtype), pshapes)))
        params = {p: [list(s.shape), str(s.dtype), _entries(
            jshd.resolve_for_shape(n, s.shape), len(s.shape))]
            for (p, n), (_, s) in zip(_leaves(jax.tree.map(
                lambda x: x, specs, is_leaf=lambda x: isinstance(x, tuple))),
                _leaves(pshapes))}
        state = {}
        for key, names in sspecs.items():
            if names is None:
                continue
            flat = ([("", names)] if isinstance(names, tuple)
                    else list(_leaves(names)))
            shp = oshapes[key]
            shp = ([("", shp)] if not isinstance(shp, dict)
                   else list(_leaves(shp)))
            for (p, n), (_, s) in zip(flat, shp):
                state[f"/{key}{p}"] = [list(s.shape), str(s.dtype), _entries(
                    jshd.resolve(n), len(s.shape))]
        in_logical = model.input_logical(sc)
        batch = {f"/{k}": [list(v.shape), str(v.dtype), _entries(
            jshd.resolve_for_shape(in_logical.get(k) or (None,) * len(
                v.shape), v.shape), len(v.shape))]
            for k, v in model.input_specs(sc).items()}
    return params, state, batch


@pytest.mark.parametrize("arch", LM_ARCHS + ["rm1"])
@pytest.mark.parametrize("mesh", list(RUN_MESHES))
def test_build_program_train_mode(mesh_runs, mesh, arch):
    """``build_program``'s train mode returns placed meta DTensors for
    the params, the ZeRO-1 optimizer state and the batch: the shapes,
    dtypes and resolved specs of the reference's ``build_program(train)``
    (its ``ShapeDtypeStruct`` trees and ``in_shardings``), each rank's
    local block the block of its coordinate."""
    shape = RUN_MESHES[mesh]
    want = _reference_train_layout(arch, shape)
    sizes = dict(zip(("data", "model"), shape))
    for res in mesh_runs[1]:
        got = [json.loads(str(t)) for t in res[f"{mesh}/{arch}/train_layout"]]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for path, (shp, dt, ent, loc, dev) in g.items():
                assert [shp, dt, ent] == w[path], path
                cut = [int(np.prod([sizes[a] for a in (
                    [e] if isinstance(e, str) else e or [])])) for e in ent]
                assert loc == [n // c for n, c in zip(shp, cut)], path
                assert dev == "meta", path

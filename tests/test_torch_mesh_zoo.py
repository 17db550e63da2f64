"""The encoder-decoder and recurrent families on a mesh: whisper, zamba2
and rwkv6 served (prefill, then greedy decode) and trained through the
port's ``launch.steps.build_program`` on a ``DeviceMesh``, against the
reference's ``build_program`` on its mesh and the port's one device.

- Meshes (data 2, model 2) and (1, 4), run as ``test_torch_mesh.py``
  runs them: the reference in JAX subprocesses with four host devices
  (one per mesh for serving and one per mesh for training), its meshes
  built as ``jax.sharding.Mesh(devices.reshape(shape), names)`` (Auto
  axes), the port in 4 gloo rank processes that import no JAX.  Every
  subprocess has a 120 s timeout.
- Reduced fp32 configs with the reference's weights (plus seeded noise):
  whisper's, zamba2's and rwkv6's ``REDUCED`` (head-TP on both meshes;
  zamba2's Mamba heads on ``model``).  On (1, 4) two more copies: whisper
  with 6 heads (FSDP rules: context parallelism in the encoder, the
  decoder's self- and its cross-attention) and zamba2 with
  ``ssm.head_dim`` 64 (2 Mamba heads: ``mamba_heads`` whole while
  ``ffn`` shards d_inner, so a rank's columns cut through heads).
- Serving: each rank's prefill logits block and its block of every cache
  leaf, then 4 greedy decode steps (tokens equal, each step's logits
  block and the written cache blocks) within 1e-5 of the reference's
  mesh and of one device (``SERVE_TOL``).  The reference's prefill cache
  is put onto its decode program's shardings before its decode: whisper's
  decode refuses its own prefill's cross cache otherwise (its kv heads
  lie on ``model`` under the prefill rules and whole under the decode
  rules).  The port's prefill emits the decode layout: its cache's
  placements equal the decode program's example arguments'.
- Training: every rank's loss within 1e-5 (relative) of the reference's
  ``build_program(train)`` step on its mesh and of one device; every
  leaf's gradient, gathered whole, within rtol 1e-4 and atol 1e-5 (the
  reference's read from its Adam step's first moment); after one ZeRO-1
  step of the port's train program the parameters and the state within
  1e-5 of both.
- Where the reference's own mesh lies further from its one device at a
  leaf, that leaf's tolerance is ``WITNESS`` times the reference's gap
  there, capped (``SERVE_GAP_CAP``, ``TRAIN_GAP_CAP``);
  ``test_reference_gaps_under_cap`` prints each case's gaps.
- ``checkpoint.save`` of zamba2's stepped tree on (2, 2) and
  ``elastic.elastic_restore`` onto ``healthy_mesh({"model": 2}, 0.4)``:
  the survivors hold the saved values bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs

from _torch_zoo import noisy

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
SERVE_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_TOL = 1e-5
#: the recurrent families' fp32 states run to |x| ~ 50, and the
#: reference's own mesh lies up to some 1e-4 from its one device there
#: (a different summation order through the SSD and WKV chains).  A
#: leaf's tolerance is therefore the larger of the base above and
#: ``WITNESS`` times that gap of the reference's at the same leaf,
#: measured in the same run and case, at the leaf's magnitude: two
#: independent orders (the port's and the reference's) each as far as
#: the reference's own, and twice that for margin.  A leaf whose gap is
#: under a quarter of the base keeps the base.
WITNESS = 4.0
#: the largest reference gap a leaf may widen its tolerance by
#: (relative, as ``_rel_gap`` measures it), so that no leaf's tolerance
#: passes 4e-4 of its magnitude in serving and 4e-3 in training: past
#: it the reference itself is at fault, and the case fails rather than
#: loosen.  Serving's gaps are a forward pass's rounding (at most
#: 3.2e-5, zamba2's SSM state on (1, 4)); training's add the backward
#: and Adam's division by sqrt(v), which lifts an element's rounding to
#: the step size where |g| is small (at most 5.7e-4, zamba2's gradient
#: of the embedding and its step of ``in_z``; ``pytest -rP`` prints
#: every case's, ``test_reference_gaps_under_cap``).
SERVE_GAP_CAP, TRAIN_GAP_CAP = 1e-4, 1e-3
RUN_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: case -> (arch, what the case changes in its reduced config)
CASES = {"whisper": ("whisper-large-v3", {}),
         "zamba2": ("zamba2-7b", {}),
         "rwkv6": ("rwkv6-3b", {}),
         "whisper-6h": ("whisper-large-v3", {"num_heads": 6,
                                              "num_kv_heads": 6}),
         "zamba2-hd64": ("zamba2-7b", {"ssm_head_dim": 64})}
MESH_CASES = {"2x2": ["whisper", "zamba2", "rwkv6"],
              "1x4": list(CASES)}
#: the self-attention cache leaves that decode extends past the prompt
SEQ_CACHE = {"whisper-large-v3": ["k", "v"],
             "zamba2-7b": ["attn_k", "attn_v"], "rwkv6-3b": []}
BATCH, PROMPT, CACHE, STEPS = 4, 16, 32, 4
ELASTIC_CASE = "zamba2"              # saved on (2, 2), restored on 2


def _cfg(pkg, case):
    arch, kw = CASES[case]
    cfg = pkg.get_reduced(arch).replace(dtype="float32",
                                        param_dtype="float32")
    kw = dict(kw)
    if "ssm_head_dim" in kw:
        cfg = cfg.replace(ssm=dataclasses.replace(
            cfg.ssm, head_dim=kw.pop("ssm_head_dim")))
    return cfg.replace(**kw)


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
d = sys.argv[1]
spec = json.loads(open(os.path.join(d, "spec.json")).read())
inputs = np.load(os.path.join(d, "inputs.npz"))
B, S, T, steps = spec["batch"], spec["prompt"], spec["cache"], spec["steps"]

def nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out

def cfg_of(configs, case):
    arch, kw = spec["cases"][case]
    cfg = configs.get_reduced(arch).replace(dtype="float32",
                                            param_dtype="float32")
    kw = dict(kw)
    if "ssm_head_dim" in kw:
        cfg = cfg.replace(ssm=dataclasses.replace(
            cfg.ssm, head_dim=kw.pop("ssm_head_dim")))
    return cfg.replace(**kw)

def batch_of(case, kind):
    # the prompt's inputs (prefill) or the training batch
    out = {"tokens": inputs[case + "/tokens"]}
    if case + "/frames" in inputs.files:
        out["frames"] = inputs[case + "/frames"]
    if kind == "train":
        out["labels"] = inputs[case + "/labels"]
    return out
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
from repro.models.transformer import pad_cache
from repro.train import optimizer as opt_mod
from repro.train.optimizer import OptConfig
from repro.train.train_loop import make_train_step
name, shape, part = sys.argv[2], tuple(json.loads(sys.argv[3])), sys.argv[4]
mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))

def tree(case):
    data = np.load(os.path.join(d, case + ".npz"))
    return nest({k: jnp.asarray(data[k]) for k in data.files})

def flat(tree, prefix, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[prefix + key] = np.asarray(leaf, np.float32)

def greedy(logits):
    return jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)

out = {}
for case in spec["mesh_cases"][name]:
    cfg = cfg_of(configs, case)
    model = registry.build(cfg)
    if part == "one":
        # one device: the witness of the reference's own mesh-to-one gap
        batch = {k: jnp.asarray(v) for k, v in batch_of(case, "p").items()}
        logits, cache = jax.jit(model.prefill)(tree(case), batch)
        out[f"{case}/prefill"] = np.asarray(logits)
        for k in spec["seq_cache"][spec["cases"][case][0]]:
            cache[k] = pad_cache(cache[k], T)
        flat(cache, f"{case}/cache/", out)
        decode, tok, dl = jax.jit(model.decode_step), greedy(logits), []
        for _ in range(steps):
            logits, cache = decode(tree(case), cache, {"tokens": tok})
            dl.append(np.asarray(logits))
            tok = greedy(logits)
        out[f"{case}/decode"] = np.stack(dl)
        flat(cache, f"{case}/decode_cache/", out)
        batch = {k: jnp.asarray(v) for k, v in batch_of(case, "train").items()}
        _, grads = jax.jit(jax.value_and_grad(model.loss))(tree(case), batch)
        flat(grads, f"{case}/grad/", out)
        ocfg, params = OptConfig(), tree(case)
        p2, s2, _ = jax.jit(make_train_step(model, ocfg))(
            params, opt_mod.init_state(ocfg, params), batch)
        flat(p2, f"{case}/step/param/", out)
        flat(s2, f"{case}/step/state/", out)
    elif part == "serve":
        pf, _, _ = build_program(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
        dshape = ShapeConfig("d", T, B, "decode")
        df, _, drules = build_program(cfg, dshape, mesh)
        batch = {k: jnp.asarray(v) for k, v in batch_of(case, "p").items()}
        logits, cache = pf(tree(case), batch)
        out[f"{case}/prefill"] = np.asarray(logits)
        for k in spec["seq_cache"][spec["cases"][case][0]]:
            cache[k] = pad_cache(cache[k], T)
        # onto the decode program's shardings: whisper's decode refuses
        # its prefill's cross cache (kv heads on model) otherwise
        with shd.use_mesh(mesh, drules):
            cshard = shd.tree_shardings_for_shapes(
                model.cache_logical(dshape), model.cache_specs(dshape))
        cache = jax.device_put(cache, cshard)
        flat(cache, f"{case}/cache/", out)
        params, tok = tree(case), greedy(logits)
        toks, dl = [np.asarray(tok)], []
        for _ in range(steps):
            logits, cache = df(params, cache, {"tokens": tok})
            dl.append(np.asarray(logits))
            tok = greedy(logits)
            toks.append(np.asarray(tok))
        out[f"{case}/decode"] = np.stack(dl)
        out[f"{case}/tokens"] = np.concatenate(toks, 1)
        flat(cache, f"{case}/decode_cache/", out)
    else:
        ocfg = OptConfig()
        step, _, _ = build_program(cfg, ShapeConfig("t", S, B, "train"),
                                   mesh, ocfg)
        params = tree(case)            # the step donates its arguments
        batch = {k: jnp.asarray(v) for k, v in batch_of(case, "train").items()}
        p2, s2, met = step(params, opt_mod.init_state(ocfg, params), batch)
        flat(p2, f"{case}/step/param/", out)
        flat(s2, f"{case}/step/state/", out)
        out[f"{case}/step/loss"] = np.asarray(met["loss"])
        out[f"{case}/step/grad_norm"] = np.asarray(met["grad_norm"])
np.savez(os.path.join(d, f"jax-{name}-{part}.npz"), **out)
"""

RANK_SCRIPT = COMMON + r"""
import torch
import torch.distributed as dist
rank, world = int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "store"), rank=rank, world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import elastic, sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_program
from repro_torch.models import registry
from repro_torch.models.transformer import params_from_reference
from repro_torch.train import checkpoint as ckpt, optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import (make_train_step,
                                          place_for_training, value_and_grad)

def tree(case):
    data = np.load(os.path.join(d, case + ".npz"))
    return params_from_reference(nest({k: data[k] for k in data.files}),
                                 device="cpu")

def items(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from items(t[k], f"{path}/{k}" if path else k)
    elif t is not None:
        yield path, t

def entries(x):
    # a DTensor's placements as one entry per dim (mesh axes in mesh
    # order), the form of the reference's PartitionSpec
    names = x.device_mesh.mesh_dim_names
    return [[names[i] for i, p in enumerate(x.placements)
             if p.is_shard(dim)] for dim in range(x.dim())]

def blocks(t, prefix, out):
    # each placed leaf's local block and its entries
    for path, x in items(t):
        out[prefix + path] = x.to_local().float().numpy().copy()
        out[prefix + path + "@spec"] = np.array(json.dumps(entries(x)))

def whole(t, prefix, out):
    # every rank gathers (a collective); the values are rank 0's to keep
    for path, x in items(t):
        full = shd.full(x).detach().float().numpy().copy()
        if rank == 0:
            out[prefix + path] = full

def greedy(logits):
    return logits[:, -1].argmax(-1)[:, None].to(torch.int32)

def placements(t):
    return [(p, tuple(x.placements), tuple(x.shape)) for p, x in items(t)]

try:
    out, one_done = {}, set()
    for name, shape in spec["meshes"].items():
        mesh = make_host_mesh(shape[1], device="cpu")
        out[f"{name}/coord"] = np.array(mesh.get_coordinate())
        for case in spec["mesh_cases"][name]:
            cfg = cfg_of(configs, case)
            model = registry.build(cfg)
            pb = {k: torch.from_numpy(v) for k, v in batch_of(case, "p").items()}
            tb = {k: torch.from_numpy(v)
                  for k, v in batch_of(case, "train").items()}
            if case not in one_done and rank == 0:     # one device, once
                one_done.add(case)
                params = tree(case)
                with torch.no_grad():
                    lg, c = model.prefill(params, pb, cache_len=T)
                    out[f"one/{case}/prefill"] = lg.numpy()
                    for path, x in items(c):
                        out[f"one/{case}/cache/{path}"] = x.float().numpy().copy()
                    tok, tl, dl = greedy(lg), [greedy(lg)], []
                    for _ in range(steps):
                        lg, c = model.decode_step(params, c, {"tokens": tok})
                        dl.append(lg.numpy())
                        tok = greedy(lg)
                        tl.append(tok)
                out[f"one/{case}/decode"] = np.stack(dl)
                out[f"one/{case}/tokens"] = torch.cat(tl, 1).numpy()
                for path, x in items(c):
                    out[f"one/{case}/decode_cache/{path}"] = x.float().numpy()
                loss, grads = value_and_grad(model, tree(case), tb)
                out[f"one/{case}/loss"] = loss.numpy()
                whole(grads, f"one/{case}/grad/", out)
                p = tree(case)
                p, s, _ = make_train_step(model, OptConfig())(
                    p, opt_mod.init_state(OptConfig(), p), tb)
                whole(p, f"one/{case}/step/param/", out)
                whole(s, f"one/{case}/step/state/", out)

            # serving: prefill, then greedy decode from its cache as it is
            pf, pargs, prules = build_program(
                cfg, ShapeConfig("p", S, B, "prefill"), mesh, cache_len=T)
            df, dargs, drules = build_program(
                cfg, ShapeConfig("d", T, B, "decode"), mesh)
            placed = elastic.reshard_tree(tree(case), model.param_specs(),
                                          mesh, prules)
            logits, cache = pf(placed, pb)
            out[f"{name}/{case}/args_match"] = np.array([
                placements(pargs[0]) == placements(placed),
                # the prefill's cache is in the decode program's layout
                placements(dargs[1]) == placements(cache)])
            blocks({"logits": logits}, f"{name}/{case}/prefill/", out)
            blocks(cache, f"{name}/{case}/cache/", out)
            dparams = elastic.reshard_tree(placed, model.param_specs(), mesh,
                                           drules)
            tok = greedy(shd.full(logits))
            tl, dl = [tok], []
            for _ in range(steps):
                logits, cache = df(dparams, cache, {"tokens": tok})
                dl.append(logits.to_local().numpy())
                tok = greedy(shd.full(logits))
                tl.append(tok)
            out[f"{name}/{case}/decode"] = np.stack(dl)
            out[f"{name}/{case}/decode@spec"] = np.array(json.dumps(
                [[]] + entries(logits)))
            out[f"{name}/{case}/tokens"] = torch.cat(tl, 1).numpy()
            blocks(cache, f"{name}/{case}/decode_cache/", out)

            # training: the loss and gradients, then one ZeRO-1 step
            step, _, trules = build_program(
                cfg, ShapeConfig("t", S, B, "train"), mesh)
            p, s = place_for_training(model, OptConfig(), tree(case), mesh,
                                      trules)
            with shd.use_mesh(mesh, trules):
                loss, grads = value_and_grad(model, p, tb)
            out[f"{name}/{case}/loss"] = loss.numpy()
            whole(grads, f"{name}/{case}/grad/", out)
            p2, s2, met = step(p, s, tb)
            out[f"{name}/{case}/step/loss"] = met["loss"].numpy()
            whole(p2, f"{name}/{case}/step/param/", out)
            whole(s2, f"{name}/{case}/step/state/", out)
            if name == spec["elastic_mesh"] and case == spec["elastic_case"]:
                ckpt.save(os.path.join(d, "ckpt"), p2, s2, 1)
                saved = {k: shd.full(x) for k, x in items({"p": p2, "s": s2})}
                small = elastic.healthy_mesh({"model": 2},
                                             failed_fraction=0.4, device="cpu")
                res = elastic.elastic_restore(os.path.join(d, "ckpt"), model,
                                              OptConfig(), small, trules)
                out["elastic/member"] = np.array(res is not None)
                if res is not None:     # the survivors gather among them
                    rp, rs, rstep = res
                    out["elastic/step"] = np.array(rstep)
                    got = dict(items({"p": rp, "s": rs}))
                    out["elastic/equal"] = np.array(
                        [sorted(got) == sorted(saved)]
                        + [torch.equal(shd.full(got[k]), x)
                           for k, x in saved.items()])
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    np.savez(os.path.join(d, f"rank-{rank}.npz"), **out)
finally:
    dist.destroy_process_group()
"""


def _wait_all(procs, t0):
    """Wait for every process within the timeout; kill any left over.
    Prints, for each, the seconds since ``t0`` by which it had ended."""
    try:
        for what, proc in procs:
            try:
                _, err = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"{what} did not finish in {TIMEOUT_S} s")
            assert proc.returncode == 0, f"{what}:\n{err[-3000:]}"
            print(f"{what}: ended by {time.perf_counter() - t0:.1f} s")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _inputs():
    rng = np.random.RandomState(11)
    out = {}
    for case in CASES:
        cfg = _cfg(tconfigs, case)
        toks = rng.randint(0, cfg.vocab_size, (BATCH, PROMPT + 1))
        out[f"{case}/tokens"] = toks[:, :-1].astype(np.int32)
        out[f"{case}/labels"] = toks[:, 1:].astype(np.int32)
        if cfg.encdec is not None:
            out[f"{case}/frames"] = rng.randn(
                BATCH, cfg.encdec.encoder_seq, cfg.d_model).astype(np.float32)
    return out


def _spawn(what, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return (what, subprocess.Popen(
        [sys.executable, "-c", *args], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


@pytest.fixture(scope="module")
def zoo_runs(tmp_path_factory):
    """The reference's results on each mesh and every port rank's, from
    one run of the subprocesses in parallel (``pytest -rP`` shows when
    each ended)."""
    d = tmp_path_factory.mktemp("mesh_zoo")
    spec = {"batch": BATCH, "prompt": PROMPT, "cache": CACHE, "steps": STEPS,
            "cases": CASES, "mesh_cases": MESH_CASES, "seq_cache": SEQ_CACHE,
            "meshes": {k: list(v) for k, v in RUN_MESHES.items()},
            "elastic_mesh": "2x2", "elastic_case": ELASTIC_CASE}
    (d / "spec.json").write_text(json.dumps(spec))
    np.savez(d / "inputs.npz", **_inputs())
    t0 = time.perf_counter()
    for i, case in enumerate(CASES):
        m = jregistry.build(_cfg(jconfigs, case))
        np.savez(d / f"{case}.npz", **_flatten(noisy(m.init(0), 3 + i)))
    procs = [_spawn(f"reference on {name} ({part})", JAX_SCRIPT, str(d),
                    name, json.dumps(shape), part)
             for name, shape in RUN_MESHES.items()
             for part in ("serve", "train")]
    # one device, every case (the cases of the mesh that runs them all)
    procs.append(_spawn("reference on one device", JAX_SCRIPT, str(d), "1x4",
                        json.dumps(RUN_MESHES["1x4"]), "one"))
    procs += [_spawn(f"port rank {r}", RANK_SCRIPT, str(d), str(r), "4")
              for r in range(4)]
    print(f"subprocesses started {time.perf_counter() - t0:.1f} s after "
          f"the fixture")
    _wait_all(procs, t0)
    ref = {name: {**np.load(d / f"jax-{name}-serve.npz"),
                  **np.load(d / f"jax-{name}-train.npz")}
           for name in RUN_MESHES}
    ref["one"] = dict(np.load(d / "jax-1x4-one.npz"))
    ranks = [dict(np.load(d / f"rank-{r}.npz")) for r in range(4)]
    return ref, ranks


def _block(x, coord, shape, spec):
    """The block of ``x`` at mesh ``coord`` (of a (data, model) mesh of
    ``shape``) under ``spec``: per dim, the mesh axes sharding it, in
    mesh order (even splits)."""
    sizes = dict(zip(("data", "model"), shape))
    idx = dict(zip(("data", "model"), coord))
    for dim, axes in enumerate(spec):
        i, n = 0, 1
        for a in axes:
            i, n = i * sizes[a] + idx[a], n * sizes[a]
        step = x.shape[dim] // n
        x = np.take(x, range(i * step, (i + 1) * step), dim)
    return x


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _group(res, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in res.items()
            if k.startswith(prefix) and not k.endswith("@spec")}


def _rel_gap(got, one, floor, what, cap):
    """``max|got - one|`` over ``max(floor, max|one|)`` (``floor`` 0:
    relative to the leaf's magnitude; an all-zero leaf has gap 0).  It
    must stay under ``cap``: a larger gap of the reference's is an
    anomaly there, not a tolerance to widen."""
    scale = max(floor, float(np.abs(one).max()))
    gap = float(np.abs(got - one).max()) / scale if scale else 0.0
    assert gap <= cap, f"{what}: the reference's own gap {gap:.3g}"
    return gap


def _gap(ref, mesh, key, floor=1.0):
    """The reference's own gap between its mesh and its one device at
    the leaf ``key`` (:func:`_rel_gap`; a train step's leaves under
    ``TRAIN_GAP_CAP``, the rest under ``SERVE_GAP_CAP``)."""
    cap = TRAIN_GAP_CAP if "/step/" in key else SERVE_GAP_CAP
    return _rel_gap(ref[mesh][key], ref["one"][key], floor, key, cap)


def _tol(base, gap, want, floor=1.0):
    """A leaf's tolerance: the larger of ``base`` and ``WITNESS`` times
    the reference's own gap at that leaf (:func:`_gap`), at the leaf's
    magnitude."""
    return max(base, WITNESS * gap * max(floor, float(np.abs(want).max())))


RUNS = [(c, m) for m in RUN_MESHES for c in MESH_CASES[m]]


@pytest.mark.parametrize("case,mesh", RUNS)
def test_prefill_logits_and_cache_blocks(zoo_runs, case, mesh):
    """Each rank's logits block and its block of every cache leaf after
    the prefill (the reference's put onto its decode shardings, padded
    to the decode slots) against the reference's mesh and one device;
    the example arguments' placements are the placed params', and the
    prefill's cache comes out in the decode program's layout."""
    ref, ranks = zoo_runs
    shape = RUN_MESHES[mesh]
    for res in ranks:
        coord = res[f"{mesh}/coord"]
        pre = f"{mesh}/{case}/prefill/logits"
        spec = json.loads(str(res[pre + "@spec"]))
        gap = _gap(ref, mesh, f"{case}/prefill")
        for want in (ref[mesh][f"{case}/prefill"],
                     ranks[0][f"one/{case}/prefill"]):
            want = _block(want, coord, shape, spec)
            _close(res[pre], want, _tol(SERVE_TOL, gap, want),
                   f"prefill logits (reference's gap {gap:.3g})")
        got = _group(res, f"{mesh}/{case}/cache/")
        assert sorted(got) == sorted(_group(ref[mesh], f"{case}/cache/"))
        for key, blk in got.items():
            spec = json.loads(str(res[f"{mesh}/{case}/cache/{key}@spec"]))
            gap = _gap(ref, mesh, f"{case}/cache/{key}")
            for want in (ref[mesh][f"{case}/cache/{key}"],
                         ranks[0][f"one/{case}/cache/{key}"]):
                want = _block(want, coord, shape, spec)
                _close(blk, want, _tol(SERVE_TOL, gap, want),
                       f"{key} (reference's gap {gap:.3g})")
        assert res[f"{mesh}/{case}/args_match"].tolist() == [True, True]


@pytest.mark.parametrize("case,mesh", RUNS)
def test_greedy_decode(zoo_runs, case, mesh):
    """4 greedy steps under the decode rules from the prefill's cache:
    tokens equal to the reference's mesh run and to one device; each
    step's logits block and every cache leaf's block after the steps."""
    ref, ranks = zoo_runs
    shape = RUN_MESHES[mesh]
    want_tokens = ref[mesh][f"{case}/tokens"]
    np.testing.assert_array_equal(ranks[0][f"one/{case}/tokens"], want_tokens)
    for res in ranks:
        coord = res[f"{mesh}/coord"]
        np.testing.assert_array_equal(res[f"{mesh}/{case}/tokens"],
                                      want_tokens)
        spec = json.loads(str(res[f"{mesh}/{case}/decode@spec"]))
        gap = _gap(ref, mesh, f"{case}/decode")
        for want in (ref[mesh][f"{case}/decode"],
                     ranks[0][f"one/{case}/decode"]):
            want = _block(want, coord, shape, spec)
            _close(res[f"{mesh}/{case}/decode"], want,
                   _tol(SERVE_TOL, gap, want),
                   f"decode (reference's gap {gap:.3g})")
        for key, blk in _group(res, f"{mesh}/{case}/decode_cache/").items():
            spec = json.loads(str(res[f"{mesh}/{case}/decode_cache/{key}@spec"]))
            gap = _gap(ref, mesh, f"{case}/decode_cache/{key}")
            for want in (ref[mesh][f"{case}/decode_cache/{key}"],
                         ranks[0][f"one/{case}/decode_cache/{key}"]):
                want = _block(want, coord, shape, spec)
                _close(blk, want, _tol(SERVE_TOL, gap, want),
                       f"{key} (reference's gap {gap:.3g})")


def _reference_grads(ref, case):
    """The reference's gradient on its mesh, read from its train step's
    first Adam moment, m = (1 - b1) * clip * g from zero (clip from the
    step's gradient norm)."""
    cfg = jopt.OptConfig()
    gnorm = float(ref[f"{case}/step/grad_norm"])
    clip = min(1.0, cfg.grad_clip / max(gnorm, 1e-12))
    return {k: m / ((1 - cfg.b1) * clip)
            for k, m in _group(ref, f"{case}/step/state/m/").items()}


@pytest.mark.parametrize("case,mesh", RUNS)
def test_loss_and_grads(zoo_runs, case, mesh):
    """Every rank's global loss within 1e-5 (relative) of the
    reference's mesh step and of one device; every leaf's gradient,
    gathered whole, within rtol 1e-4 of both, and atol 1e-5 (or, at a
    leaf where it is larger, ``WITNESS`` times the reference's own gap
    between its mesh's and its one device's gradient of that leaf, at
    the leaf's largest magnitude)."""
    ref, ranks = zoo_runs
    want = ref[mesh]
    for res in ranks:
        loss = float(res[f"{mesh}/{case}/loss"])
        for w in (float(want[f"{case}/step/loss"]),
                  float(ranks[0][f"one/{case}/loss"])):
            assert abs(loss - w) <= LOSS_RTOL * abs(w), (loss, w)
    mesh_grads = _reference_grads(want, case)
    one = _group(ref["one"], f"{case}/grad/")
    assert sorted(one) == sorted(mesh_grads)
    gaps = {k: _rel_gap(mesh_grads[k], g, 0.0, f"{case} grad {k}",
                        TRAIN_GAP_CAP) for k, g in one.items()}
    got = _group(ranks[0], f"{mesh}/{case}/grad/")
    for what, grads in (("reference mesh", mesh_grads),
                        ("one device", _group(ranks[0], f"one/{case}/grad/"))):
        assert sorted(got) == sorted(grads), what
        for k, w in grads.items():
            np.testing.assert_allclose(
                got[k], w, rtol=GRAD_RTOL,
                atol=_tol(GRAD_ATOL, gaps[k], w, floor=0.0) + 1e-12,
                err_msg=f"{what} {k} (reference's gap {gaps[k]:.3g})")


@pytest.mark.parametrize("case,mesh", RUNS)
def test_zero1_train_step(zoo_runs, case, mesh):
    """One step of ``build_program``'s train program (Adam, the ZeRO-1
    state): the parameters and the state, gathered whole, within 1e-5
    (or, at a leaf where it is larger, ``WITNESS`` times the reference's
    own gap between its mesh's step and its one device's at that leaf)
    of the reference's step on its mesh and of one device's step; the
    loss the same on every rank."""
    ref, ranks = zoo_runs
    for part in ("param", "state"):
        got = _group(ranks[0], f"{mesh}/{case}/step/{part}/")
        for want in (_group(ref[mesh], f"{case}/step/{part}/"),
                     _group(ranks[0], f"one/{case}/step/{part}/")):
            assert sorted(got) == sorted(want), part
            for k, w in want.items():
                gap = _gap(ref, mesh, f"{case}/step/{part}/{k}")
                _close(got[k], w, _tol(STEP_TOL, gap, w),
                       f"{part} {k} (reference's gap {gap:.3g})")
    losses = {float(r[f"{mesh}/{case}/step/loss"]) for r in ranks}
    assert len(losses) == 1, losses


def test_elastic_restore_of_a_zamba2_step(zoo_runs):
    """zamba2's tree after the (2, 2) step, saved by ``checkpoint.save``
    from the mesh and restored by ``elastic_restore`` onto the 2
    survivors of ``healthy_mesh({"model": 2}, 0.4)``: every parameter
    and state leaf bitwise the saved one, at the saved step."""
    _, ranks = zoo_runs
    members = [r for r in ranks if bool(r["elastic/member"])]
    assert len(members) == 2
    for r in members:
        assert int(r["elastic/step"]) == 1
        assert r["elastic/equal"].all()


@pytest.mark.parametrize("case,mesh", RUNS)
def test_reference_gaps_under_cap(zoo_runs, case, mesh):
    """The reference's own gap between its mesh and its one device at
    every leaf that the tests above compare, each under its cap
    (``SERVE_GAP_CAP``, ``TRAIN_GAP_CAP``); each part's largest gap, its
    leaf, the tolerance it gives there and the count of leaves whose
    tolerance it widens are printed (``pytest -rP`` shows them)."""
    ref, _ = zoo_runs
    mesh_grads = _reference_grads(ref[mesh], case)
    parts = {}
    for key in sorted(ref["one"]):
        if not key.startswith(f"{case}/") or key.endswith("/loss"):
            continue
        sub = key[len(case) + 1:]
        part = sub.split("/")[0] if "/" in sub else sub
        if part == "step":
            part = "/".join(sub.split("/")[:2])
        if part == "grad":
            leaf = sub[len("grad/"):]
            gap = _rel_gap(mesh_grads[leaf], ref["one"][key], 0.0, key,
                           TRAIN_GAP_CAP)
            tol = _tol(GRAD_ATOL, gap, ref["one"][key], floor=0.0)
        else:
            gap = _gap(ref, mesh, key)
            base = STEP_TOL if part.startswith("step") else SERVE_TOL
            tol = _tol(base, gap, ref["one"][key])
        parts.setdefault(part, []).append((gap, sub, tol))
    assert set(parts) == {"prefill", "decode", "cache", "decode_cache",
                          "grad", "step/param", "step/state"}, sorted(parts)
    for part, rows in sorted(parts.items()):
        gap, leaf, tol = max(rows)
        base = GRAD_ATOL if part == "grad" else SERVE_TOL
        print(f"{case} on {mesh}: {part}: the reference's largest gap "
              f"{gap:.3g} ({leaf}; its tolerance {tol:.3g}); "
              f"{sum(t > base for _, _, t in rows)} of {len(rows)} leaves "
              f"widened")

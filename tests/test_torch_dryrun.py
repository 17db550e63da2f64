"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's: the production meshes and each rank's argument bytes.

- ``MeshConfig``, ``SINGLE_POD`` and ``MULTI_POD`` equal the reference's
  field for field; ``make_production_mesh`` builds them over a fake world.
- Every arch x shape x production mesh (256 and 512 ranks): rank 0's
  ``argument_bytes`` (its local blocks of the parameters, the optimizer
  state, the batch and the cache, from ``build_program``'s example
  arguments on the dry run's mesh, no trace) equals the reference's
  per-device bytes, the sum
  of ``NamedSharding.shard_shape`` over the shardings its
  ``build_program`` hands to ``jax.jit``; skipped cells match with the
  reference's reason.  The reference runs in one JAX subprocess with 512
  host devices and meshes of Auto axes
  (``jax.sharding.Mesh(devices.reshape(shape), names)``: ``jax.make_mesh``
  builds Explicit axes, on which the reference's sharding constraints
  raise), the port in one subprocess under the fake process group.
- Reduced fp32 configs, one arch per family (dense, MoE, whisper, zamba2,
  rwkv6), on an Auto (2, 4) mesh of 8 host devices: the port's
  ``argument_bytes`` equals the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` for prefill, decode and
  train (whisper's decode: the compiled size of the arguments jit keeps,
  and the port's the shard bytes of every argument).

Each subprocess has a 240 s timeout; the two of a fixture run together.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import base as jbase
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
FAMILY_ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "whisper-large-v3",
                "zamba2-7b", "rwkv6-3b"]
#: the reduced cells: (name, seq_len, global batch, kind)
REDUCED_SHAPES = [("prefill", 32, 8, "prefill"), ("decode", 32, 8, "decode"),
                  ("train", 32, 8, "train")]


def test_mesh_configs_match():
    for name in ("SINGLE_POD", "MULTI_POD"):
        j, t = getattr(jbase, name), getattr(tbase, name)
        assert (t.shape, t.axes, t.num_devices) == (j.shape, j.axes,
                                                    j.num_devices)
    assert tbase.MeshConfig((2, 3), ("a", "b")).num_devices == 6
    assert tconfigs.MULTI_POD is tbase.MULTI_POD


def test_make_production_mesh_over_a_fake_world():
    code = """
import torch.distributed as dist
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.distributed import sharding as shd
from repro_torch import configs
from repro_torch.models import registry
for multi, n in ((False, 256), (True, 512)):
    with fake_world(n):
        m = make_production_mesh(multi_pod=multi, device="cpu")
        print(dict(zip(m.mesh_dim_names, m.mesh.shape)), dist.get_world_size())
        rules = registry.make_rules(configs.get_config("llama3-8b"), m, "train")
        with shd.use_mesh(m, rules):
            print(shd.resolve(("batch", "heads")))
print(dist.is_initialized())
"""
    out = _run([sys.executable, "-c", code])
    assert out.splitlines() == [
        "{'data': 16, 'model': 16} 256", "('data', 'model')",
        "{'pod': 2, 'data': 16, 'model': 16} 512",
        "(('pod', 'data'), 'model')", "False"]


def _env(devices: int = 0):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices}")
    return env


def _run(cmd, devices: int = 0) -> str:
    proc = subprocess.run(cmd, cwd=REPO, env=_env(devices),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _run_all(cmds):
    """Run ``(cmd, devices)`` subprocesses together -> their stdouts."""
    procs = [subprocess.Popen(cmd, cwd=REPO, env=_env(dev),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd, dev in cmds]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


JAX_BYTES = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro import configs
from repro.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro.distributed import sharding as shd
from repro.models import registry
from repro.train import optimizer as opt_mod
from repro.train.optimizer import OptConfig

def leaf_bytes(shapes, shardings):
    leaves = jax.tree.leaves(shapes)
    shards = jax.tree.leaves(shardings)
    assert len(leaves) == len(shards), (len(leaves), len(shards))
    return [int(np.prod(sh.shard_shape(s.shape))) * np.dtype(s.dtype).itemsize
            for s, sh in zip(leaves, shards)]

def cell_bytes(cfg, sh, mesh):
    # per-device bytes of each argument leaf, in build_program's order:
    # (params, opt_state, batch), (params, batch) or (params, cache, batch)
    model = registry.build(cfg)
    mode = registry.mode_for_shape(sh)
    rules = registry.make_rules(cfg, mesh, mode)
    with shd.use_mesh(mesh, rules):
        pshapes = model.param_shapes()
        parts = [leaf_bytes(pshapes, shd.tree_shardings_for_shapes(
            model.param_specs(), pshapes))]
        in_specs = model.input_specs(sh)
        in_logical = model.input_logical(sh)
        if mode == "train":
            oc = OptConfig()
            ospecs = opt_mod.state_specs(oc, model.param_specs(), pshapes)
            oshapes = jax.eval_shape(lambda: opt_mod.init_state(
                oc, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                 pshapes)))
            parts.append(leaf_bytes(oshapes, shd.tree_shardings(ospecs)))
        if mode == "decode":
            cshapes = model.cache_specs(sh)
            parts.append(leaf_bytes(cshapes, shd.tree_shardings_for_shapes(
                model.cache_logical(sh), cshapes)))
        parts.append(leaf_bytes(in_specs, {k: NamedSharding(
            mesh, shd.resolve_for_shape(in_logical.get(k) or (None,) * len(
                v.shape), v.shape)) for k, v in in_specs.items()}))
    return [b for part in parts for b in part]

devs = np.array(jax.devices())
out = {}
if sys.argv[1] == "production":
    for multi in (False, True):
        shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi
                        else ((16, 16), ("data", "model")))
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
        for arch in configs.ASSIGNED_ARCHS:
            cfg = configs.get_config(arch)
            for name, sh in SHAPES.items():
                key = f"{arch}|{name}|{'multi' if multi else 'single'}"
                ok, why = shape_applicable(cfg, sh)
                out[key] = (sum(cell_bytes(cfg, sh, mesh)) if ok
                            else "skip: " + why)
else:
    from benchmarks.roofline import (collective_bytes_from_hlo,
                                     hlo_cost_scaled)
    from repro.launch.steps import build_program
    mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
    for arch in json.loads(sys.argv[2]):
        cfg = configs.get_reduced(arch).replace(dtype="float32",
                                                param_dtype="float32")
        for name, seq, batch, kind in json.loads(sys.argv[3]):
            sh = ShapeConfig(name, seq, batch, kind)
            jitted, args, _ = build_program(cfg, sh, mesh)
            with mesh:
                lowered = jitted.lower(*args)
                compiled = lowered.compile()
            mem = compiled.memory_analysis()
            hlo = compiled.as_text()
            # jit drops the arguments the program never reads
            kept = lowered._lowering.compile_args["kept_var_idx"]
            leaves = cell_bytes(cfg, sh, mesh)
            out[f"{arch}|{name}"] = {
                "args": [int(mem.argument_size_in_bytes),
                         sum(leaves[i] for i in kept), sum(leaves)],
                # dots' FLOPs with while bodies scaled by their trips
                "flops": hlo_cost_scaled(hlo)["flops"],
                "temp_bytes": int(mem.temp_size_in_bytes),
                "output_bytes": int(mem.output_size_in_bytes),
                "alias_bytes": int(mem.alias_size_in_bytes),
                "collective_bytes": collective_bytes_from_hlo(hlo)["total"]}
print(json.dumps(out))
"""

PORT_BYTES = r"""
import json, sys
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_program

def arg_bytes(cfg, shape, multi, mesh_shape=None):
    # build_program's placed meta examples on the dry run's mesh: no trace
    mc = dryrun.mesh_config(multi, mesh_shape)
    with dryrun.fake_world(mc.num_devices):
        _, args, _ = build_program(cfg, shape, dryrun.fake_mesh(
            multi, mesh_shape))
        return dryrun.argument_bytes(args)

out = {}
if sys.argv[1] == "production":
    with dryrun.fake_world(512):
        for multi in (False, True):
            for arch in configs.ASSIGNED_ARCHS:
                cfg = configs.get_config(arch)
                for name, sh in SHAPES.items():
                    key = f"{arch}|{name}|{'multi' if multi else 'single'}"
                    ok, why = shape_applicable(cfg, sh)
                    out[key] = (arg_bytes(cfg, sh, multi) if ok
                                else "skip: " + why)
else:
    for arch in json.loads(sys.argv[2]):
        cfg = configs.get_reduced(arch).replace(dtype="float32",
                                                param_dtype="float32")
        for name, seq, batch, kind in json.loads(sys.argv[3]):
            sh = ShapeConfig(name, seq, batch, kind)
            rec = dryrun.run_cell(arch, name, False, mesh_shape=(2, 4),
                                  shape=sh, cfg=cfg)
            out[f"{arch}|{name}"] = dict(
                rec["memory"], args=arg_bytes(cfg, sh, False, (2, 4)),
                flops=rec["cost"]["flops"],
                collective_bytes=rec["collectives"]["total"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_bytes():
    ref, port = _run_all([
        ([sys.executable, "-c", JAX_BYTES, "production"], 512),
        ([sys.executable, "-c", PORT_BYTES, "production"], 0)])
    return json.loads(ref.splitlines()[-1]), json.loads(port.splitlines()[-1])


CELLS = [f"{a}|{s}|{m}" for a in tconfigs.ASSIGNED_ARCHS
         for s in tbase.SHAPES for m in ("single", "multi")]


@pytest.mark.parametrize("cell", CELLS)
def test_production_argument_bytes(production_bytes, cell):
    ref, port = production_bytes
    assert port[cell] == ref[cell]


@pytest.fixture(scope="module")
def reduced_bytes():
    args = [json.dumps(FAMILY_ARCHS), json.dumps(REDUCED_SHAPES)]
    ref, port = _run_all([
        ([sys.executable, "-c", JAX_BYTES, "reduced", *args], 8),
        ([sys.executable, "-c", PORT_BYTES, "reduced", *args], 0)])
    return json.loads(ref.splitlines()[-1]), json.loads(port.splitlines()[-1])


@pytest.mark.parametrize("kind", [s[0] for s in REDUCED_SHAPES])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_argument_bytes_match_compiled(reduced_bytes, arch, kind):
    """The port's bytes equal the reference's shard bytes of every
    argument, and the compiled size equals those of the arguments jit
    keeps: all of them but in whisper's decode, whose compiled program
    drops the encoder's weights (it never reads them); the port's rank
    holds them, as the reference's device does."""
    ref, port = reduced_bytes
    compiled, kept, every = ref[f"{arch}|{kind}"]["args"]
    assert port[f"{arch}|{kind}"]["args"] == every
    assert port[f"{arch}|{kind}"]["argument_bytes"] == every
    assert compiled == kept
    if (arch, kind) != ("whisper-large-v3", "decode"):
        assert kept == every


#: the reduced cells whose FLOPs equal the reference's exactly: every
#: matmul both programs run is one the other counts too
EXACT_FLOPS = {("smollm-135m", "decode"), ("whisper-large-v3", "decode"),
               ("whisper-large-v3", "train")}
#: the port's figure over the reference's compiled one on the reduced
#: cells: each band is the measured range of the 15 cells, widened by a
#: few percent (PERF.md lists each cell's ratio).  FLOPs: the
#: reference's dots, while bodies scaled by their trips
#: (``benchmarks.roofline.hlo_cost_scaled``), against ``FlopCounterMode``
#: plus the kernels' formula; temp: XLA's buffer assignment against the
#: peak of the eager program's live storage; collectives: the HLO's
#: collectives against the port's c10d calls, by the same moved-bytes
#: convention.
RATIO_BANDS = {"flops": (0.97, 2.9), "temp_bytes": (0.14, 3.2),
               "output_bytes": (0.99, 2.3), "collective_bytes": (0.38, 1.65)}


@pytest.mark.parametrize("field", sorted(RATIO_BANDS))
@pytest.mark.parametrize("kind", [s[0] for s in REDUCED_SHAPES])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_costs_against_compiled(reduced_bytes, arch, kind, field):
    """The traced dry run on the (2, 4) mesh against the reference's
    compiled cell: FLOPs equal in ``EXACT_FLOPS``, each figure within its
    ``RATIO_BANDS`` band."""
    ref, port = reduced_bytes
    got, want = port[f"{arch}|{kind}"][field], ref[f"{arch}|{kind}"][field]
    if field == "flops" and (arch, kind) in EXACT_FLOPS:
        assert got == want
    lo, hi = RATIO_BANDS[field]
    assert want > 0 and lo <= got / want <= hi, (got, want, got / want)


@pytest.mark.parametrize("kind", [s[0] for s in REDUCED_SHAPES])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_alias_bytes_match_compiled(reduced_bytes, arch, kind):
    """Bytes written in place: in train the parameters and optimizer
    state, equal to the reference's donated bytes; in decode the cache,
    4 bytes short of the reference's, which donates its int32 ``pos``
    too (the port returns a new one); none in prefill.  rwkv6's decode
    writes its recurrent state anew (the reference donates it): none."""
    ref, port = reduced_bytes
    got = port[f"{arch}|{kind}"]["alias_bytes"]
    want = ref[f"{arch}|{kind}"]["alias_bytes"]
    if kind == "decode":
        want = 0 if arch == "rwkv6-3b" else want - 4
    assert got == want

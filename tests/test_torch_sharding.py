"""The port's table-sharded lookup (``core/sharding``) and its stacked
embedding-bag kernel against the JAX package's.

Same numpy inputs, made from a seed, through ``repro`` (Pallas in
interpret mode, as its own tests run it) and ``repro_torch`` (the plain
PyTorch version the wrappers take for CPU tensors; the CUDA kernel is
held against that version on the card by ``tests/test_torch_cuda.py``).

- The stacked bag (``ops.embedding_bag``) is bitwise equal to the
  reference's, fp32 and bf16, with -1 and deeper negative padding and
  rows past a table's end (which read that table's last row).
- The single-host lookup with ``use_kernel=True`` is bitwise equal; with
  ``use_kernel=False`` both sum in one reduction that may reassociate,
  so it is held to 1e-6, with NaN exactly where the reference has NaN
  (a row past a table's end, ``jnp.take``'s fill).
- On meshes the reference runs in a subprocess with four host devices
  (``XLA_FLAGS``, as ``tests/test_multidevice.py`` does); the port runs
  in gloo rank processes that import no JAX, joined by a ``file://``
  store.  Each rank's output is held to the matching rows of the
  reference's mesh result as above, and bitwise to the port's own
  single-host result.  Every subprocess has a 120 s timeout.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sharding as jshd
from repro.kernels import ops as jops
from repro.models.dlrm import embedding_bag_ref as jbag_ref
from repro_torch import configs as tconfigs
from repro_torch.core import sharding as tshd
from repro_torch.kernels import cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
DTYPES = ["float32", "bfloat16"]
#: name -> (mesh shape, axis names); the port's world size is the product
MESHES = {"model2": ((2,), ("model",)), "model4": ((4,), ("model",)),
          "data2xmodel2": ((2, 2), ("data", "model"))}


def _stack_case(T, R, D, B, P, past_end, seed=0):
    rng = np.random.RandomState(seed + 31 * T + D)
    tables = rng.randn(T, R, D).astype(np.float32)
    return tables, cases.bag_idx(rng, R, B, T, P, past_end)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------ the stacked bag
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,R,D,B,P,past_end", cases.STACKED_GRID)
def test_embedding_bag_bitwise(T, R, D, B, P, past_end, dtype):
    tables, idx = _stack_case(T, R, D, B, P, past_end)
    want = jops.embedding_bag(jnp.asarray(tables, getattr(jnp, dtype)),
                              jnp.asarray(idx))
    got = tops.embedding_bag(torch.from_numpy(tables).to(
        getattr(torch, dtype)), torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    assert str(want.dtype) == dtype
    assert got.shape == (B, T, D)
    assert np.array_equal(_np32(got), _np32(want))


def test_row_past_the_end_reads_its_tables_last_row():
    """Index 12 of a 10-row table 0 reads table 0's row 9, not a row of
    table 1 (what flat offsets t*R would give)."""
    tables = np.arange(2 * 10 * 4, dtype=np.float32).reshape(2, 10, 4)
    idx = np.array([[[12, -1], [3, -5]]], np.int32)
    want = np.asarray(jops.embedding_bag(jnp.asarray(tables),
                                         jnp.asarray(idx)))
    np.testing.assert_array_equal(want[0, 0], tables[0, 9])
    np.testing.assert_array_equal(want[0, 1], tables[1, 3])
    got = tops.embedding_bag(torch.from_numpy(tables), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_bag_ref_nan_past_the_end(dtype):
    """The one-reduction oracle (the ``use_kernel=False`` branch of the
    model and of the lookup) gives NaN for a bag with a row past its
    table's end, as ``repro.models.dlrm.embedding_bag_ref`` does, and
    never indexes out of bounds."""
    tables, idx = _stack_case(4, 10, 12, 6, 5, past_end=3, seed=5)
    want = _np32(jbag_ref(jnp.asarray(tables, getattr(jnp, dtype)),
                          jnp.asarray(idx)))
    got = tref.embedding_bag_ref(
        torch.from_numpy(tables).to(getattr(torch, dtype)),
        torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    got = _np32(got)
    nan = np.isnan(want)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    tol = 1e-6 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=tol, atol=tol)


def test_embedding_bag_launches_or_raises():
    tops.reset_launches()
    tables, idx = _stack_case(2, 20, 8, 3, 4, 0)
    tops.embedding_bag(torch.from_numpy(tables), torch.from_numpy(idx))
    assert tops.LAUNCHES["embedding_bag"] == 0       # the CPU counts none
    meta = torch.empty(2, 20, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.embedding_bag(meta, torch.zeros(3, 2, 4, dtype=torch.int32,
                                             device="meta"))


# ------------------------------------------------------- single host
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_single_host_lookup(use_kernel, dtype):
    tables, idx = _stack_case(6, 24, 16, 5, 7, past_end=2, seed=9)
    want = _np32(jshd.disagg_embedding_lookup(
        jnp.asarray(tables, getattr(jnp, dtype)), jnp.asarray(idx),
        use_kernel=use_kernel))
    got = tshd.disagg_embedding_lookup(
        torch.from_numpy(tables).to(getattr(torch, dtype)),
        torch.from_numpy(idx), use_kernel=use_kernel)
    assert got.dtype == getattr(torch, dtype)
    got = _np32(got)
    if use_kernel:
        assert np.array_equal(got, want)
        return
    nan = np.isnan(want)
    assert nan.any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    tol = 1e-6 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=tol, atol=tol)


# -------------------------------------------------------------- meshes
JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.core import sharding as cs
from repro.distributed import sharding as shd
d, meshes = sys.argv[1], json.loads(sys.argv[2])
data = np.load(os.path.join(d, "inputs.npz"))
tables, idx = jnp.asarray(data["tables"]), jnp.asarray(data["idx"])
out = {}
for name, (shape, names) in meshes.items():
    devices = jax.devices()[:int(np.prod(shape))]
    mesh = jax.make_mesh(tuple(shape), tuple(names), devices=devices)
    for k in (True, False):
        with shd.use_mesh(mesh, None):     # batch -> the data axis
            out[f"{name}-{k}"] = np.asarray(cs.disagg_embedding_lookup(
                tables, idx, mesh=mesh, use_kernel=k))
np.savez(os.path.join(d, "jax.npz"), **out)
"""

RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core.sharding import disagg_embedding_lookup
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
meshes = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, f"store-{world}"), rank=rank, world_size=world)
try:
    data = np.load(os.path.join(d, "inputs.npz"))
    tables = torch.from_numpy(data["tables"])
    idx = torch.from_numpy(data["idx"])
    out = {}
    for name, (shape, names) in meshes.items():
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=tuple(names))
        n = mesh.size(names.index("model"))
        t_loc = tables.shape[0] // n
        m = mesh.get_local_rank("model")
        lo, hi = 0, idx.shape[0]
        if "data" in names:                       # this rank's batch slice
            b = idx.shape[0] // mesh.size(names.index("data"))
            lo = mesh.get_local_rank("data") * b
            hi = lo + b
        shard = tables[m * t_loc:(m + 1) * t_loc].contiguous()
        out[f"{name}-rows"] = np.array([lo, hi])
        for k in (True, False):
            got = disagg_embedding_lookup(shard, idx[lo:hi], mesh=mesh,
                                          use_kernel=k)
            out[f"{name}-{k}"] = got.numpy()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    np.savez(os.path.join(d, f"rank-{world}-{rank}.npz"), **out)
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


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """Inputs (8 tables, so every mesh divides them; 8 bags, so the 2x2
    mesh splits the batch), the reference's mesh results and each port
    rank's results, all from one run of the subprocesses in parallel."""
    d = tmp_path_factory.mktemp("mesh")
    tables, idx = _stack_case(8, 20, 12, 8, 6, past_end=2, seed=4)
    np.savez(d / "inputs.npz", tables=tables, idx=idx)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    spec = {k: [list(s), list(n)] for k, (s, n) in MESHES.items()}
    procs = [("reference mesh run", subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d), json.dumps(spec)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))]
    worlds = {}
    for name, (shape, _) in MESHES.items():
        worlds.setdefault(int(np.prod(shape)), {})[name] = spec[name]
    for world, meshes in worlds.items():
        for rank in range(world):
            procs.append((f"port rank {rank} of {world}", subprocess.Popen(
                [sys.executable, "-c", RANK_SCRIPT, str(rank), str(world),
                 str(d), json.dumps(meshes)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    _wait_all(procs)
    ranks = {}
    for world, meshes in worlds.items():
        for rank in range(world):
            res = dict(np.load(d / f"rank-{world}-{rank}.npz"))
            for name in meshes:
                ranks.setdefault(name, []).append(res)
    return tables, idx, dict(np.load(d / "jax.npz")), ranks


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_lookup(mesh_results, mesh, use_kernel):
    tables, idx, jax_out, ranks = mesh_results
    want = jax_out[f"{mesh}-{use_kernel}"]
    single = tshd.disagg_embedding_lookup(
        torch.from_numpy(tables), torch.from_numpy(idx),
        use_kernel=use_kernel).numpy()
    assert want.shape == single.shape == (8, 8, 12)
    covered = np.zeros(idx.shape[0], bool)
    for res in ranks[mesh]:
        lo, hi = res[f"{mesh}-rows"]
        got = res[f"{mesh}-{use_kernel}"]
        assert got.shape == (hi - lo,) + want.shape[1:]
        covered[lo:hi] = True
        assert np.array_equal(got, single[lo:hi], equal_nan=True)
        if use_kernel:
            assert np.array_equal(got, want[lo:hi])
        else:
            nan = np.isnan(want[lo:hi])
            np.testing.assert_array_equal(np.isnan(got), nan)
            np.testing.assert_allclose(got[~nan], want[lo:hi][~nan],
                                       rtol=1e-6, atol=1e-6)
    assert covered.all()
    if not use_kernel:
        assert np.isnan(want).any()      # the inputs reach past an end


def test_mesh_axis_of_one_is_single_host():
    """A mesh without the axis, or with the axis of size 1, takes the
    single-host path and needs no process group."""
    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (4, 1)[dim]
    tables, idx = _stack_case(4, 20, 8, 3, 4, 0)
    tt, ti = torch.from_numpy(tables), torch.from_numpy(idx)
    want = tshd.disagg_embedding_lookup(tt, ti, use_kernel=True)
    for kw in ({"mesh": Mesh()}, {"mesh": Mesh(), "axis": "pod"}):
        assert torch.equal(tshd.disagg_embedding_lookup(
            tt, ti, use_kernel=True, **kw), want)


# -------------------------------------------------------------- layout
@pytest.mark.parametrize("m,seed", [(2, None), (4, None), (4, 3)])
def test_greedy_table_layout_equal(m, seed):
    want = jshd.greedy_table_layout(jconfigs.get_reduced("rm1"), m,
                                    heterogeneous_seed=seed)
    got = tshd.greedy_table_layout(tconfigs.get_reduced("rm1"), m,
                                   heterogeneous_seed=seed)
    for g, w in zip(got[:2], want[:2]):                  # perm, inv
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(got[2:], want[2:]):                  # alloc, routing
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    perm, inv = got[:2]
    assert np.array_equal(perm[inv], np.arange(len(perm)))


def test_permutation_from_assignment():
    perm, inv = tshd.permutation_from_assignment([[2, 0], [3, 1]], 4)
    wperm, winv = jshd.permutation_from_assignment([[2, 0], [3, 1]], 4)
    assert np.array_equal(perm, wperm) and np.array_equal(inv, winv)
    for shards in ([[0, 1], [1, 2]], [[0, 1], [2]], [[0, 1, 2, 3, 4]]):
        with pytest.raises(AssertionError):
            jshd.permutation_from_assignment(shards, 4)
        with pytest.raises(ValueError, match="not a permutation"):
            tshd.permutation_from_assignment(shards, 4)

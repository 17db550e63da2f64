"""The port's embedding-bag layer against the JAX package's.

Same numpy inputs through ``repro.kernels`` (Pallas in interpret mode,
and the jnp oracles) and ``repro_torch.kernels`` (the plain PyTorch
versions the wrappers take for CPU tensors).  fp32 pooled outputs are
bitwise equal; bf16 agrees within the reference's 0.1; the one-reduction
``embedding_bag_ref`` reassociates its sum, so it is held to 1e-6.
The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

GRID = [(1, 64, 8, 4, 4), (4, 100, 16, 8, 10), (3, 257, 32, 5, 7),
        (2, 128, 128, 16, 20),
        (3, 96, 13, 6, 5),        # D not a multiple of the vector width
        (2, 50, 8, 5, 1)]         # single-slot bags


def _mixed_pooling_idx(rng, R, B, T, P):
    """Per-bag pooling factors from 0..P: -1 padding tails of mixed
    length, including some fully-padded bags."""
    idx = rng.randint(0, R, (B, T, P)).astype(np.int32)
    lens = rng.randint(0, P + 1, (B, T))
    mask = np.arange(P)[None, None, :] < lens[..., None]
    return np.where(mask, idx, -1).astype(np.int32)


def _case(T, R, D, B, P, seed=0):
    rng = np.random.RandomState(seed)
    tables = rng.randn(T, R, D).astype(np.float32)
    return tables, _mixed_pooling_idx(rng, R, B, T, P)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("T,R,D,B,P", GRID)
def test_bag_wrappers_bitwise_fp32(T, R, D, B, P):
    """Both (T, R, D) wrappers and the slot-order oracle: bitwise equal
    to the JAX kernels and to ``repro.kernels.ref.embedding_bag_seq_ref``."""
    tables, idx = _case(T, R, D, B, P)
    want = np.asarray(jref.embedding_bag_seq_ref(jnp.asarray(tables),
                                                 jnp.asarray(idx)))
    jt, ji = jnp.asarray(tables), jnp.asarray(idx)
    tt, ti = torch.from_numpy(tables), torch.from_numpy(idx)
    assert np.array_equal(want, np.asarray(jops.embedding_bag_fused(jt, ji)))
    assert np.array_equal(want, np.asarray(jops.embedding_bag_nmp(jt, ji)))
    for got in (tops.embedding_bag_fused(tt, ti),
                tops.embedding_bag_nmp(tt, ti),
                tref.embedding_bag_seq_ref(tt, ti)):
        assert got.dtype == torch.float32
        assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("T,R,D,B,P", GRID)
def test_embedding_bag_ref_close(T, R, D, B, P):
    tables, idx = _case(T, R, D, B, P, seed=3)
    want = np.asarray(jref.embedding_bag_ref(jnp.asarray(tables),
                                             jnp.asarray(idx)))
    got = tref.embedding_bag_ref(torch.from_numpy(tables),
                                 torch.from_numpy(idx)).numpy()
    # one reduction over P: the summation order is the library's, so
    # equal to within fp32 rounding (atol for sums that cancel to ~0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_flat_shard_offsets_shuffled():
    """The MN-shard entry points: a flat shard addressed through per-
    table offsets in non-contiguous slot order, as a shard assignment
    routes a subset of its tables."""
    rng = np.random.RandomState(2)
    T, R, D, B, P = 5, 40, 16, 6, 6
    tables = rng.randn(T, R, D).astype(np.float32)
    flat = tables.reshape(T * R, D)
    idx = _mixed_pooling_idx(rng, R, B, T, P)
    slots = np.array([3, 0, 4], np.int32)
    sub = np.ascontiguousarray(idx[:, slots, :])
    want = np.asarray(jops.embedding_bag_fused_flat(
        jnp.asarray(flat), jnp.asarray(slots * R), jnp.asarray(sub)))
    assert np.array_equal(want, np.asarray(jops.embedding_bag_nmp_flat(
        jnp.asarray(flat), jnp.asarray(slots * R), jnp.asarray(sub))))
    args = (torch.from_numpy(flat), torch.from_numpy(slots * R),
            torch.from_numpy(sub))
    assert np.array_equal(want, tops.embedding_bag_fused_flat(*args).numpy())
    assert np.array_equal(want, tops.embedding_bag_nmp_flat(*args).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wrapper", ["embedding_bag_fused",
                                     "embedding_bag_nmp"])
def test_bag_dtypes(dtype, wrapper):
    """bf16 tables: fp32 accumulation, the result cast back to the
    table dtype, within the reference's tolerance."""
    rng = np.random.RandomState(1)
    tables = rng.randn(4, 64, 16).astype(np.float32)
    idx = _mixed_pooling_idx(rng, 64, 6, 4, 8)
    jt = jnp.asarray(tables, getattr(jnp, dtype))
    tt = torch.from_numpy(tables).to(getattr(torch, dtype))
    want = np.asarray(getattr(jops, wrapper)(jt, jnp.asarray(idx)),
                      np.float32)
    got = getattr(tops, wrapper)(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype
    tol = 1e-5 if dtype == "float32" else 0.1
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("wrapper", ["embedding_bag_fused",
                                     "embedding_bag_nmp"])
def test_all_padded(wrapper):
    out = getattr(tops, wrapper)(torch.ones(3, 10, 8),
                                 -torch.ones(4, 3, 5, dtype=torch.int32))
    assert out.shape == (4, 3, 8)
    assert float(out.abs().max()) == 0.0


def test_cpu_path_counts_no_launch():
    tops.reset_launches()
    tables, idx = _case(2, 20, 8, 3, 4)
    tops.embedding_bag_fused(torch.from_numpy(tables), torch.from_numpy(idx))
    tops.embedding_bag_nmp(torch.from_numpy(tables), torch.from_numpy(idx))
    assert tops.LAUNCHES == {"embedding_bag_fused_flat": 0,
                             "embedding_bag_nmp_flat": 0}


@pytest.mark.parametrize("wrapper", ["embedding_bag_fused_flat",
                                     "embedding_bag_nmp_flat"])
def test_non_cpu_tensor_launches_or_raises(wrapper):
    """Off the CPU a wrapper never takes the plain version: a tensor on
    a device the kernels do not serve is refused before any launch."""
    flat = torch.empty(40, 8, device="meta")
    offsets = torch.zeros(2, dtype=torch.int32, device="meta")
    idx = torch.zeros(3, 2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tops, wrapper)(flat, offsets, idx)

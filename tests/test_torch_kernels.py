"""The port's embedding-bag layer against the JAX package's.

Same numpy inputs through ``repro.kernels`` (Pallas in interpret mode,
and the jnp oracles) and ``repro_torch.kernels`` (the plain PyTorch
versions the wrappers take for CPU tensors).  fp32 pooled outputs are
bitwise equal; bf16 agrees within the reference's 0.1; the one-reduction
``embedding_bag_ref`` reassociates its sum, so it is held to 1e-6.
The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.  For the tensor-core attention
kernel, which no CPU can run, its arithmetic is emulated in torch here
and held to the card tolerance against the plain version; so is the
split-KV decode kernel's cut and merge, against the reference's Pallas
decode kernel in interpret mode, and the NMP bag kernel's schedule (one
warp per bag, K rows in flight), bitwise against the reference's Pallas
NMP kernel in interpret mode.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import embedding_bag as jeb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_partial as jfd_partial
from repro_torch.kernels import cases as tcases
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
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
    tops.embedding_bag(torch.from_numpy(tables), torch.from_numpy(idx))
    q = torch.zeros(1, 2, 8, 16)
    tops.flash_attention(q, q, q)
    tops.flash_decode_partial(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2),
                              3)
    assert tops.LAUNCHES == {"embedding_bag": 0,
                             "embedding_bag_fused_flat": 0,
                             "embedding_bag_nmp_flat": 0,
                             "flash_attention": 0,
                             "flash_decode_partial": 0}


@pytest.mark.parametrize("wrapper", ["embedding_bag_fused_flat",
                                     "embedding_bag_nmp_flat"])
def test_out_of_range_rows_read_the_last_row(wrapper):
    """A row past the flat table's end reads its last row, as the
    reference's kernels do in interpret mode."""
    flat = np.arange(40, dtype=np.float32).reshape(10, 4)
    offsets = np.array([0, 5], np.int32)
    idx = np.array([[[1, 7, -1], [2, 9, -1]]], np.int32)
    want = np.asarray(getattr(jops, wrapper)(
        jnp.asarray(flat), jnp.asarray(offsets), jnp.asarray(idx)))
    np.testing.assert_array_equal(
        want, [[[32, 34, 36, 38], [64, 66, 68, 70]]])
    got = getattr(tops, wrapper)(torch.from_numpy(flat),
                                 torch.from_numpy(offsets),
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


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


@pytest.mark.parametrize("wrapper", ["flash_attention",
                                     "flash_decode_partial"])
def test_attention_off_cpu_launches_or_raises(wrapper):
    q = torch.empty(1, 2, 8, 16, device="meta")
    args = ((q, q, q) if wrapper == "flash_attention"
            else (q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2), 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tops, wrapper)(*args)


# ----------------------------------------------- the NMP kernel's schedule

def _nmp_recipe(flat, offsets, idx):
    """The NMP kernel's schedule (``nmp_flat_kernel``) in numpy: warp w
    of the grid pools bag w = t * B + b (table-major) and writes out[b,
    t]; lane l owns the float4 columns l, l + 32, ... < D / 4 (the
    elements l, l + 32, ... on the scalar path); each 32-slot chunk's
    indices come in one load, their ballot marks the valid slots, and the
    warp takes these K at a time in slot order, loading all K rows
    (clamped into the flat table) before adding them, predicated, in
    slot order to an fp32 accumulator that starts at +0.0.  The chunk
    count and K come from D (``cases.nmp_schedule``); the scalar path
    (``pool_bag``) is K = 1.  flat is fp32 (bf16 rows widened)."""
    n_rows, D = flat.shape
    B, T, P = idx.shape
    chunks, K = tcases.nmp_schedule(D, flat.itemsize, vec=D % 4 == 0)
    # every column is one lane's (pool_bag's lanes own up to 32 elements)
    per, n_chunks = (4, chunks) if chunks else (1, 32)
    owned = sorted(per * (l + 32 * c) + e for c in range(n_chunks)
                   for l in range(32) if per * (l + 32 * c) < D
                   for e in range(per))
    assert owned == list(range(D))
    W = tcases.NMP_WARPS_PER_BLOCK
    warps = np.arange(-(-B * T // W) * W)
    bag = warps[warps < B * T]                    # the rest leave at once
    t, b = bag // B, bag % B
    bag_idx, row_off = idx[b, t].astype(np.int64), offsets[t].astype(np.int64)
    acc = np.zeros((len(bag), D), np.float32)
    for p0 in range(0, P, 32):
        mine = np.full((len(bag), 32), -1, np.int64)    # one index load
        n = min(32, P - p0)
        mine[:, :n] = bag_idx[:, p0:p0 + n]
        live = mine >= 0                                # the ballot
        lanes = np.argsort(~live, axis=1, kind="stable")  # valid first
        count = live.sum(axis=1)
        for g in range(0, 32, K):
            loads = []
            for k in range(K):                          # the loads first
                ok = count > g + k
                ix = mine[np.arange(len(bag)), lanes[:, g + k]]
                row = np.clip(row_off + ix, 0, n_rows - 1)
                loads.append((ok, flat[row]))
            for ok, x in loads:                         # adds in slot order
                acc = np.where(ok[:, None], acc + x, acc)
    out = np.zeros((B, T, D), np.float32)
    out[b, t] = acc
    return out


def _nmp_inputs(T, R, D, dtype, seed):
    """A flat shard (T * R, D) in ``dtype``, as fp32 for the recipe and
    as the reference's operand, with shuffled table offsets."""
    rng = np.random.RandomState(seed)
    flat = torch.from_numpy(rng.randn(T * R, D).astype(np.float32)).to(
        getattr(torch, dtype)).float().numpy()        # bf16 rows, widened
    offsets = (rng.permutation(T) * R).astype(np.int32)
    return rng, flat, offsets


def _nmp_pallas(flat, offsets, idx, dtype):
    return np.asarray(jeb.embedding_bag_nmp_flat(
        jnp.asarray(flat, getattr(jnp, dtype)), jnp.asarray(offsets),
        jnp.asarray(idx), interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,R,D,B,P,fill,holes", tcases.NMP_GRID)
def test_nmp_recipe_vs_pallas(T, R, D, B, P, fill, holes, dtype):
    """The NMP kernel's schedule, emulated, is bitwise equal to the
    reference's Pallas NMP kernel (interpret mode) on every edge row of
    the card grid, in fp32 and on bf16 tables."""
    rng, flat, offsets = _nmp_inputs(T, R, D, dtype, T * 1000 + D + P)
    idx = tcases.nmp_idx(rng, R, B, T, P, fill, holes)
    want = _nmp_pallas(flat, offsets, idx, dtype)
    assert np.array_equal(_nmp_recipe(flat, offsets, idx), want)
    assert np.array_equal(tops.embedding_bag_nmp_flat(
        torch.from_numpy(flat), torch.from_numpy(offsets),
        torch.from_numpy(idx)).numpy(), want)


def _group_edge_idx(rng, R, B, T, P, K):
    """Bags with padding on the edges of K-slot groups: by b mod 5, all
    slots valid; slots p % K == K - 1 padding; p % K == 0 padding; a
    padded tail; random holes.  Bag (0, 0) is all padding."""
    idx = rng.randint(0, R, (B, T, P)).astype(np.int32)
    p = np.arange(P)
    pad = [np.zeros(P, bool), p % K == K - 1, p % K == 0,
           p >= rng.randint(0, P + 1), rng.rand(P) < 0.3]
    for b in range(B):
        idx[b, :, pad[b % 5]] = -1 - b % 7
    idx[0, 0] = -1
    return idx


def _slot_count_edges():
    """(D, dtype, P) at P = 1, K - 1, K, K + 1, 32, 33 and 80 for the
    K that D = 128 and 256 fp32 and D = 1024 bf16 take (8, 4, 2)."""
    for D, dtype, itemsize in ((128, "float32", 4), (256, "float32", 4),
                               (1024, "bfloat16", 2)):
        K = tcases.nmp_schedule(D, itemsize)[1]
        for P in sorted({1, K - 1, K, K + 1, 32, 33, 80}):
            yield D, dtype, P


@pytest.mark.parametrize("D,dtype,P", list(_slot_count_edges()))
def test_nmp_recipe_slot_counts(D, dtype, P):
    """Slot counts at the groups' edges, with padding on them: the
    emulated schedule is bitwise equal to the reference's Pallas NMP
    kernel."""
    T, R, B = 2, 30, 10
    K = tcases.nmp_schedule(D, 4 if dtype == "float32" else 2)[1]
    rng, flat, offsets = _nmp_inputs(T, R, D, dtype, D + P)
    idx = _group_edge_idx(rng, R, B, T, P, K)
    assert np.array_equal(_nmp_recipe(flat, offsets, idx),
                          _nmp_pallas(flat, offsets, idx, dtype))


@pytest.mark.parametrize("D,itemsize,vec,want", [
    (128, 4, True, (1, 8)),        # RM1: one float4 a lane, 8 rows
    (4, 4, True, (1, 8)), (64, 2, True, (1, 8)), (256, 2, True, (2, 8)),
    (256, 4, True, (2, 4)), (512, 4, True, (4, 2)), (512, 2, True, (4, 4)),
    (1024, 4, True, (8, 2)), (1024, 2, True, (8, 2)),
    (13, 4, False, (0, 1))])       # the scalar path: pool_bag
def test_nmp_schedule_from_d(D, itemsize, vec, want):
    assert tcases.nmp_schedule(D, itemsize, vec) == want


# ------------------------------------------- flash attention's tensor cores

def _tc_recipe(q, k, v, causal, split=True, tile=128):
    """The tensor-core kernel's arithmetic (``fa_forward_wgmma``) in
    torch: S = Q K^T from bf16 inputs summed in fp32, an online softmax
    per 128-key tile with ``exp2`` and ``scale * log2(e)`` folded in,
    P = P_hi + P_lo in two bf16 terms (or, with ``split=False``, P
    rounded once to bf16), each P term times V summed in fp32, the
    output rounded to bf16 once.  A head dim that is no multiple of 64
    (zamba2's 112) runs padded to whole 64-column atoms with zero
    columns, as TMA fills them, at the true D's scale; the columns past
    D are dropped, as the kernel's epilogue does not store them."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    c = (torch.tensor(1.0 / math.sqrt(D))
         * torch.tensor(1.4426950408889634))             # fp32, as the card
    pad = (0, -D % 64)
    qf = F.pad(q.float(), pad).reshape(B, Hkv, H // Hkv, S, D + pad[1])
    kf, vf = F.pad(k.float(), pad), F.pad(v.float(), pad)
    out = torch.empty_like(qf)
    for q0 in range(0, S, tile):
        q1 = min(q0 + tile, S)
        rows = torch.arange(q0, q1)[:, None]
        m = torch.full(qf[:, :, :, q0:q1, :1].shape, -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf[:, :, :, q0:q1])
        for n0 in range(0, min(T, q1) if causal else T, tile):
            n1 = min(n0 + tile, T)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, q0:q1],
                             kf[:, :, n0:n1])
            if causal:
                s = torch.where(rows >= torch.arange(n0, n1), s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            hi = p.bfloat16().float()
            terms = [hi, (p - hi).bfloat16().float()] if split else [hi]
            acc = acc * corr + sum(torch.einsum("bhgqk,bhkd->bhgqd", t,
                                                vf[:, :, n0:n1])
                                   for t in terms)
        out[:, :, :, q0:q1] = acc / l.clamp(min=1e-37)
    assert not out[..., D:].any()               # P V's padded columns
    return out[..., :D].reshape(B, H, S, D).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,S,T,D", [
    c for c in tcases.ATTN_GRID if c[5] in tfa.WGMMA_HEAD_DIMS])
def test_tensor_core_recipe_needs_p_split(B, H, Hkv, S, T, D, causal):
    """Why the tensor-core kernel runs P V twice: with P in two bf16
    terms its arithmetic stays within the card tolerance of the plain
    version on every bf16 case it takes; with P rounded once to bf16 it
    misses that tolerance on every one of them but S = 1 under the causal
    mask, whose one live key has p = 1, exact in bf16."""
    rng = np.random.RandomState(S + T + D)
    q = tcases.randn(rng, (B, H, S, D), "cpu", torch.bfloat16)
    k = tcases.randn(rng, (B, Hkv, T, D), "cpu", torch.bfloat16)
    v = tcases.randn(rng, (B, Hkv, T, D), "cpu", torch.bfloat16)
    want = tfa.flash_attention_plain(q, k, v, causal=causal).float()
    atol, rtol = tcases.ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(_tc_recipe(q, k, v, causal).float(), want,
                               atol=atol, rtol=rtol)
    once = _tc_recipe(q, k, v, causal, split=False).float()
    missed = bool(((once - want).abs() > atol + rtol * want.abs()).any())
    assert missed == (S > 1 or not causal)


@pytest.mark.parametrize("dtype,D,kind", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "scalar"), (torch.bfloat16, 16, "scalar"),
    (torch.bfloat16, 112, "wgmma"),           # zamba2-7b's shared block
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar")])
def test_attention_variant_by_dtype_and_head_dim(dtype, D, kind):
    assert tfa.variant(dtype, D) == kind


def test_tma_strides_in_place_or_refused():
    """The layers' (B, S, H, D) -> (B, H, S, D) view goes to TMA as it
    is; an axis of size 1 takes any stride; a misaligned pointer or a
    stride TMA cannot take is refused, never copied."""
    x = torch.zeros(2, 16, 9, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert tfa.tma_strides("q", x) == [16 * 9 * 64, 64, 9 * 64]
    one = torch.zeros(1, 3, 5, 64, dtype=torch.bfloat16)[:, :1]
    assert tfa.tma_strides("k", one) == [64, 64, 64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.tma_strides("q", torch.zeros(2, 2, 8, 65,
                                         dtype=torch.bfloat16)[..., 1:])
    with pytest.raises(ValueError, match="stride 65"):
        tfa.tma_strides("v", torch.zeros(2, 2, 8, 65,
                                         dtype=torch.bfloat16)[..., :64])


def test_reset_zeroes_variant_counts():
    tfa.VARIANT_LAUNCHES["wgmma"] += 3
    tops.reset_launches()
    assert tfa.VARIANT_LAUNCHES == {"wgmma": 0, "scalar": 0}


# ------------------------------------------------- flash decode's split-KV

H100_SMS = 132


def _split_bounds(pos, off, T, splits):
    """The rows ``[r0, r1)`` of each split, as the kernel cuts them on
    the device: the live rows ``n = clamp(pos - off + 1, 0, T)`` in
    ``splits`` near-equal ranges (empty ones where ``n < splits``)."""
    n = min(max(pos - off + 1, 0), T)
    return [(n * s // splits, n * (s + 1) // splits) for s in range(splits)]


def _split_recipe(q, kc, vc, pos, off, splits):
    """The split-KV decode kernel's arithmetic (``fd_partial``) in torch:
    q times 1/sqrt(D) in fp32, the live rows cut by ``_split_bounds``,
    each split's partial (o, l, m) over its rows with m starting at
    -1e30, then the splits merged in split order: m = max m_s,
    l = sum l_s e^(m_s - m), o = sum o_s e^(m_s - m)."""
    B, H, D = q.shape
    T, Hkv = kc.shape[1], kc.shape[2]
    qf = (q.float().reshape(B, Hkv, H // Hkv, D)
          * torch.tensor(1.0 / math.sqrt(D)))
    parts = []
    for r0, r1 in _split_bounds(pos, off, T, splits):
        s = torch.einsum("bhgd,bthd->bhgt", qf, kc[:, r0:r1].float())
        m = torch.full(s.shape[:-1], -1e30)
        if r1 > r0:
            m = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m[..., None])
        parts.append((torch.einsum("bhgt,bthd->bhgd", p,
                                   vc[:, r0:r1].float()), p.sum(-1), m))
    m = torch.full_like(parts[0][2], -1e30)
    for _, _, m_s in parts:
        m = torch.maximum(m, m_s)
    o, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for o_s, l_s, m_s in parts:
        c = torch.exp(m_s - m)
        o, l = o + o_s * c[..., None], l + l_s * c
    return o.reshape(B, H, D), l.reshape(B, H), m.reshape(B, H)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,pos,off", tcases.DECODE_GRID)
def test_split_kv_recipe_vs_pallas(B, H, Hkv, T, D, pos, off, dtype):
    """The kernel's cut of the live rows and merge of the splits, at the
    split count it takes on an H100, within ``DECODE_TOL`` of the
    reference's Pallas decode kernel on every card case; a slice wholly
    after pos gives exactly m = -1e30, l = o = 0."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.RandomState(T + D + pos)
    q, kc, vc = (tcases.randn(rng, shape, "cpu", td) for shape in
                 ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    splits = tfd.num_splits(B, Hkv, T, H100_SMS)
    got = _split_recipe(q, kc, vc, pos, off, splits)
    want = jfd_partial(*(jnp.asarray(t.float().numpy(), jd)
                         for t in (q, kc, vc)),
                       jnp.asarray(pos, jnp.int32), kv_offset=off,
                       kv_block=T, interpret=True)
    for g, w, tol in zip(got, want, tcases.DECODE_TOL):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=tol, rtol=tol)
    if off > pos:
        o, l, m = got
        assert not o.any() and not l.any() and bool((m == -1e30).all())


@pytest.mark.parametrize("B,Hkv,T,splits", [
    (8, 3, 2048, 11),        # smollm-135m's decode: 264 CTAs, two waves
    (96, 3, 128, 1),         # B * Hkv = 288 fills the card alone
    (1, 1, 4096, 16),        # one group: capped at MAX_SPLITS
    (2, 3, 96, 3),           # short cache: at least 32 rows a split
    (1, 1, 8, 1)])
def test_num_splits_from_shapes_alone(B, Hkv, T, splits):
    assert tfd.num_splits(B, Hkv, T, H100_SMS) == splits


@pytest.mark.parametrize("pos,off,T,splits", [
    (1087, 0, 2048, 11), (0, 0, 256, 8), (1000, 0, 256, 8),
    (100, 256, 256, 8), (700, 512, 512, 5), (2, 0, 64, 7)])
def test_split_bounds_cut_the_live_rows(pos, off, T, splits):
    """The splits tile [0, n) in order, n = clamp(pos - off + 1, 0, T),
    each within one row of the others."""
    bounds = _split_bounds(pos, off, T, splits)
    n = min(max(pos - off + 1, 0), T)
    assert len(bounds) == splits and bounds[0][0] == 0
    assert bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [r1 - r0 for r0, r1 in bounds]
    assert max(sizes) - min(sizes) <= 1

"""The port's CUDA kernels and device path on the card (marker ``cuda``).

Every test here needs a CUDA card and skips without one; the file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The bag kernels are held against their plain PyTorch version: fp32
(and bf16, whose rows widen to fp32 exactly and add in the same order)
is bitwise equal; the stacked bag's bf16 output, its fp32 sum rounded
once, is bitwise equal too.  The attention kernels are held against theirs at the
shapes and tolerances of ``repro_torch.kernels.cases`` (which
``chip_smoke.py`` uses too; its docstring gives the reasons): fp32
within 2e-5 and bf16 within two bf16 steps of each element for flash
attention (bf16 at D 64, 112 and 128 on the tensor-core kernel, zamba2's
112 padded to 128 in shared memory, also on a slice of local heads and
bitwise across launches; the rest on the scalar one), 1e-4 on o and l and 1e-5
on m for the decode partials, whose two launches on the same inputs are
bitwise equal.  The cluster on
the card is held against the same cluster on the CPU: equal stats,
scores within rtol=1e-5, atol=1e-6; the RM1 + RM2 fleet on the card
against itself with the plain pooling: scores within 1e-5, and against
the same fleet on the CPU: an equal report; the LM on the
card against the LM on the CPU: fp32 logits within 1e-4, equal tokens,
for smollm and for the zoo's reduced MoE, VLM, whisper and recurrent
(zamba2, rwkv6) models; an MoE decode step and a recurrent one are
sync-free and bitwise repeatable in bf16.  Every kernel wrapper refuses
an operand that requires grad (the kernels have no backward) and
launches under ``torch.no_grad``; a reduced fp32 train step on the card
against the CPU: loss and gradient norm within 1e-5 relative,
parameters within 1e-5 after an SGD step at lr 1, no kernel launch.
Two gloo ranks on the card hold ``sharded_decode_attention`` against
``decode_attention_unsharded`` on the same cache (D 64 and 112, fp32
and bf16, ``pos`` in each shard and past T): the new row written on its
owner only, bitwise; the output within 1e-4 in fp32 and two bf16 steps
in bf16.
"""
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced, rm1, smollm_135m
from repro_torch.core.sharding import disagg_embedding_lookup
from repro_torch.data.queries import dlrm_request_stream
from repro_torch.kernels import build, cases, common
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.dlrm import DLRMModel
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import DecoderLM
from repro_torch.serving.cluster import ClusterConfig, ClusterEngine
from repro_torch.serving.engine import LMServingEngine, Request
from repro_torch.serving.fleet import build_fleet, run_fleet
from repro_torch.serving.scenario import FailMN, ScenarioSpec

KERNELS = ["embedding_bag_fused_flat", "embedding_bag_nmp_flat"]
SCENARIOS = Path(__file__).resolve().parents[1] / "examples" / "scenarios"
SCORE_ATOL = 1e-5      # cluster scores, as in chip_smoke.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(T, R, D, B, P, dev, dtype=torch.float32):
    rng = np.random.RandomState(T * 100 + D)
    flat = torch.from_numpy(rng.randn(T * R, D).astype(np.float32))
    idx = rng.randint(0, R, (B, T, P)).astype(np.int32)
    lens = rng.randint(0, P + 1, (B, T))
    lens[0, 0] = 0                                   # an all-padded bag
    idx = np.where(np.arange(P)[None, None, :] < lens[..., None], idx, -1)
    slots = rng.permutation(T).astype(np.int32)      # shuffled shard
    return (flat.to(dev, dtype), torch.from_numpy(slots * R).to(dev),
            torch.from_numpy(idx.astype(np.int32)).to(dev))


def _nmp_case(T, R, D, B, P, fill, holes, dev, dtype):
    rng = np.random.RandomState(T * 1000 + D + P)
    flat = cases.randn(rng, (T * R, D), dev, dtype)
    slots = rng.permutation(T).astype(np.int32)      # shuffled shard
    idx = cases.nmp_idx(rng, R, B, T, P, fill, holes)
    return (flat, torch.from_numpy(slots * R).to(dev),
            torch.from_numpy(idx).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,D,B,P,fill,holes", [
    row + (None, None) for row in cases.BAG_GRID] + cases.NMP_GRID)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_bitwise_vs_plain(cuda, kernel, T, R, D, B, P, fill, holes,
                                 dtype):
    """Both flat kernels on the bag grid and at the NMP kernel's edges
    (``cases.NMP_GRID``: D from 4 to 1024, the scalar path, B = 1 and 13,
    T = 1, P > 32 and P % K != 0, holes between valid slots): bitwise
    equal to the plain version."""
    flat, offsets, idx = (
        _case(T, R, D, B, P, cuda, dtype) if fill is None
        else _nmp_case(T, R, D, B, P, fill, holes, cuda, dtype))
    before = ops.LAUNCHES[kernel]
    got = getattr(ops, kernel)(flat, offsets, idx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    assert torch.equal(got, teb.embedding_bag_flat_plain(flat, offsets, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,D,B,P,fill,holes", cases.NMP_GRID[:6])
def test_nmp_kernel_deterministic(cuda, T, R, D, B, P, fill, holes, dtype):
    """Two NMP launches on the same inputs are bitwise equal."""
    flat, offsets, idx = _nmp_case(T, R, D, B, P, fill, holes, cuda, dtype)
    first = ops.embedding_bag_nmp_flat(flat, offsets, idx)
    second = ops.embedding_bag_nmp_flat(flat, offsets, idx)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vec", [True, False])
def test_nmp_schedule_matches_cases(cuda, dtype, vec):
    """The library launches the schedule that ``cases.nmp_schedule``
    (which the CPU emulation runs) says: one warp per bag, the float4
    columns a lane and the rows in flight from D alone."""
    lib = build.load("embedding_bag")
    lib.eb_nmp_schedule.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sched = (ctypes.c_int * 4)()
    itemsize = torch.tensor([], dtype=dtype).element_size()
    for T, _, D, B, *_ in cases.NMP_GRID:
        assert lib.eb_nmp_schedule(common.DTYPE_CODES[dtype], B, T, D,
                                   int(vec), sched) == 0
        bags = B * T
        chunks, k = cases.nmp_schedule(D, itemsize, vec)
        assert list(sched) == [-(-bags // cases.NMP_WARPS_PER_BLOCK),
                               cases.NMP_WARPS_PER_BLOCK, chunks, k]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_refuses_bad_input(cuda, kernel):
    flat, offsets, idx = _case(2, 50, 8, 5, 3, cuda)
    with pytest.raises(ValueError, match="int32"):
        getattr(ops, kernel)(flat, offsets, idx.long())
    with pytest.raises(ValueError, match="lies on"):
        getattr(ops, kernel)(flat, offsets, idx.cpu())
    with pytest.raises(ValueError, match="D <= 1024"):
        getattr(ops, kernel)(torch.zeros(8, 2048, device=cuda), offsets,
                             idx)


@pytest.mark.cuda
def test_cluster_on_card_matches_cpu(cuda):
    model = DLRMModel(rm1.REDUCED)
    params = model.init(0, device="cpu")
    reqs = [Request(*t) for t in dlrm_request_stream(rm1.REDUCED, 16)]
    cfg = ClusterConfig(batch_size=32, inflight_depth=2,
                        mn_types=["ddr_mn", "ddr_mn", "nmp_mn", "nmp_mn"])
    events = [FailMN(0.02, mn=2)]
    cpu_res, cpu_stats = ClusterEngine(model, params, cfg,
                                       device="cpu").serve(reqs,
                                                           events=events)
    dev_params = {k: (v.to(cuda) if isinstance(v, torch.Tensor)
                      else {n: w.to(cuda) for n, w in v.items()})
                  for k, v in params.items()}
    ops.reset_launches()
    res, stats = ClusterEngine(model, dev_params, cfg).serve(reqs,
                                                             events=events)
    assert all(ops.LAUNCHES[k] > 0 for k in KERNELS), ops.LAUNCHES
    assert dataclasses.asdict(stats) == dataclasses.asdict(cpu_stats)
    want = {r.rid: r.outputs for r in cpu_res}
    for r in res:
        np.testing.assert_allclose(r.outputs, want[r.rid], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
def test_fleet_on_card_kernels_match_plain(cuda):
    """RM1 + RM2 (reduced, 8 x 1000 x 16 each) on one mixed DDR/NMP pool
    under ``fleet_shift``'s traffic: both flat kernels launch, the
    scores are within SCORE_ATOL of the same fleet served with the plain
    pooling (``use_kernel=False``) on the card, and the report equals the
    same fleet's on the CPU field for field (the virtual clock reads only
    indices and bytes)."""
    spec = ScenarioSpec.load(str(SCENARIOS / "fleet_shift.json"))
    mixed = dataclasses.replace(spec.topology, mn_types=(
        "ddr_mn", "ddr_mn", "nmp_mn", "nmp_mn"))
    members = build_fleet(spec, device=cuda)
    assert [m.model.cfg.name for m in members] == ["rm1-reduced",
                                                   "rm2-reduced"]
    ops.reset_launches()
    rep = run_fleet(dataclasses.replace(spec, topology=mixed),
                    fleet=members, device="cuda")
    assert all(ops.LAUNCHES[k] > 0 for k in KERNELS), ops.LAUNCHES
    assert rep.completed == rep.total == spec.workload.requests
    assert all(m.completed > 0 for m in rep.stats.per_model.values())
    plain = run_fleet(dataclasses.replace(spec, topology=dataclasses.replace(
        mixed, use_kernel=False)), fleet=members, device="cuda")
    want = {r.rid: r.outputs for r in plain.results}
    for r in rep.results:
        assert np.all(np.isfinite(r.outputs))
        np.testing.assert_allclose(r.outputs, want[r.rid], rtol=0,
                                   atol=SCORE_ATOL)
    host = run_fleet(dataclasses.replace(spec, topology=mixed),
                     fleet=build_fleet(spec, device="cpu"), device="cpu")
    assert (json.dumps(rep.to_dict(), sort_keys=True, default=repr)
            == json.dumps(host.to_dict(), sort_keys=True, default=repr))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_out_of_range_rows_read_last_row(cuda, kernel):
    """A row past the shard's end reads its last row, as the reference's
    kernels and the plain version do."""
    flat = torch.arange(40, dtype=torch.float32, device=cuda).reshape(10, 4)
    offsets = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    idx = torch.tensor([[[1, 7, -1], [2, 9, -1]]], dtype=torch.int32,
                       device=cuda)
    got = getattr(ops, kernel)(flat, offsets, idx)
    torch.cuda.synchronize()
    want = torch.tensor([[[32., 34, 36, 38], [64, 66, 68, 70]]], device=cuda)
    assert torch.equal(got, want)
    assert torch.equal(got, teb.embedding_bag_flat_plain(flat, offsets, idx))


def _stacked_case(T, R, D, B, P, past_end, dev, dtype):
    rng = np.random.RandomState(T * 100 + D + past_end)
    tables = cases.randn(rng, (T, R, D), dev, dtype)
    idx = cases.bag_idx(rng, R, B, T, P, past_end)
    return tables, torch.from_numpy(idx).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,D,B,P,past_end", cases.STACKED_GRID)
def test_stacked_kernel_bitwise_vs_plain(cuda, T, R, D, B, P, past_end,
                                         dtype):
    tables, idx = _stacked_case(T, R, D, B, P, past_end, cuda, dtype)
    before = ops.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(tables, idx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["embedding_bag"] == before + 1
    assert got.dtype == dtype and got.shape == (B, T, D)
    assert torch.equal(got, teb.embedding_bag_stacked_plain(tables, idx))


@pytest.mark.cuda
def test_stacked_kernel_row_past_the_end(cuda):
    """Index 12 of a 10-row table 0 reads table 0's row 9."""
    tables = torch.arange(80, dtype=torch.float32,
                          device=cuda).reshape(2, 10, 4)
    idx = torch.tensor([[[12, -1], [3, -5]]], dtype=torch.int32, device=cuda)
    got = ops.embedding_bag(tables, idx)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.stack([tables[0, 9], tables[1, 3]]))


@pytest.mark.cuda
def test_stacked_kernel_refuses_bad_input(cuda):
    tables, idx = _stacked_case(2, 50, 8, 5, 3, 0, cuda, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        ops.embedding_bag(tables, idx.long())
    with pytest.raises(ValueError, match="lies on"):
        ops.embedding_bag(tables, idx.cpu())
    with pytest.raises(ValueError, match=r"\(B, T, P\)"):
        ops.embedding_bag(tables, idx[:, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(tables, idx.transpose(0, 1))
    with pytest.raises(ValueError, match="D <= 1024"):
        ops.embedding_bag(torch.zeros(2, 4, 2048, device=cuda), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False])
def test_single_host_lookup_on_card_matches_cpu(cuda, use_kernel):
    tables, idx = _stacked_case(6, 24, 16, 5, 7, 2, torch.device("cpu"),
                                torch.float32)
    want = disagg_embedding_lookup(tables, idx, use_kernel=use_kernel)
    ops.reset_launches()
    got = disagg_embedding_lookup(tables.to(cuda), idx.to(cuda),
                                  use_kernel=use_kernel).cpu()
    assert ops.LAUNCHES["embedding_bag"] == int(use_kernel)
    if use_kernel:
        assert torch.equal(got, want)
    else:      # NaN in the same bags; one reduction in another order
        assert torch.equal(got.isnan(), want.isnan())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,S,T,D", cases.ATTN_GRID)
def test_flash_attention_vs_plain(cuda, B, H, Hkv, S, T, D, causal, dtype):
    rng = np.random.RandomState(S + T + D)
    q = cases.randn(rng, (B, H, S, D), cuda, dtype)
    k = cases.randn(rng, (B, Hkv, T, D), cuda, dtype)
    v = cases.randn(rng, (B, Hkv, T, D), cuda, dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    atol, rtol = cases.ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_flash_attention_strided_views(cuda):
    """(B, S, H, D) tensors permuted to (B, H, S, D) at smollm-135m's
    full-width prefill shape: read in place (by TMA on the tensor-core
    kernel), and the output keeps the permuted layout."""
    rng = np.random.RandomState(3)
    B, S, H, Hkv, D = 8, 1024, 9, 3, 64
    q = cases.randn(rng, (B, S, H, D), cuda, torch.bfloat16).transpose(1, 2)
    k = cases.randn(rng, (B, S, Hkv, D), cuda, torch.bfloat16).transpose(1, 2)
    v = cases.randn(rng, (B, S, Hkv, D), cuda, torch.bfloat16).transpose(1, 2)
    before = tfa.VARIANT_LAUNCHES["wgmma"]
    got = ops.flash_attention(q, k, v)
    assert tfa.VARIANT_LAUNCHES["wgmma"] == before + 1
    assert got.stride() == q.stride()
    want = tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous())
    atol, rtol = cases.ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128])
def test_flash_attention_single_tile(cuda, D):
    """One CTA on one 128 x 128 tile, not causal: the first check of the
    tensor-core kernel's TMA swizzle and wgmma descriptors, which give
    plausible wrong numbers when they disagree."""
    rng = np.random.RandomState(D)
    q, k, v = (cases.randn(rng, (1, 1, 128, D), cuda, torch.bfloat16)
               for _ in range(3))
    before = tfa.VARIANT_LAUNCHES["wgmma"]
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES["wgmma"] == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=False)
    atol, rtol = cases.ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,kind", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "scalar"), (torch.bfloat16, 112, "wgmma"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar")])
def test_flash_attention_variant_launched(cuda, dtype, D, kind):
    """bf16 at D in {64, 112, 128} launches the tensor-core kernel,
    anything else the scalar one: one launch, counted once, on the right
    kernel."""
    q = torch.randn(1, 2, 40, D, device=cuda).to(dtype)
    ops.reset_launches()
    ops.flash_attention(q, q[:, :1], q[:, :1])
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES == {"wgmma": int(kind == "wgmma"),
                                    "scalar": int(kind == "scalar")}
    assert ops.LAUNCHES["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [slice(None), slice(8, 16)])
def test_flash_attention_d112_in_place_repeatable(cuda, heads):
    """zamba2-7b's prefill attention (B 4, S 512, 32 heads of 112) on the
    tensor-core kernel, read in place from the layers' (B, S, H, D)
    tensors: all 32 heads, whose output rows run on into the next head's
    (an epilogue that stored the padded columns 112-127 would overwrite
    them, racing that head's CTA), and a rank's 8 local heads of
    ``[mesh]`` (pointer offset 8 * 112 * 2 = 1792 bytes).  Each of three
    launches holds the plain version within ``ATTN_TOL``, and all three
    are bitwise equal."""
    rng = np.random.RandomState(112)
    B, S, H, D = 4, 512, 32, 112
    q, k, v = (cases.randn(rng, (B, S, H, D), cuda, torch.bfloat16)[
        :, :, heads].transpose(1, 2) for _ in range(3))
    Hl = q.shape[1]
    assert tfa.tma_strides("q", q) == [S * H * D, D, H * D]
    assert q.data_ptr() - q.untyped_storage().data_ptr() == (
        2 * D * (heads.start or 0))
    want = tfa.flash_attention_plain(q, k, v).float()
    atol, rtol = cases.ATTN_TOL[torch.bfloat16]
    ops.reset_launches()
    outs = []
    for _ in range(3):
        outs.append(ops.flash_attention(q, k, v))
        torch.cuda.synchronize()
        assert outs[-1].shape == (B, Hl, S, D)
        torch.testing.assert_close(outs[-1].float(), want, atol=atol,
                                   rtol=rtol)
    assert tfa.VARIANT_LAUNCHES == {"wgmma": 3, "scalar": 0}
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_flash_attention_refuses_tma_unfit_views(cuda):
    """The tensor-core kernel reads through TMA and never copies: a view
    TMA cannot take is refused before any launch."""
    x = torch.zeros(1, 2, 8, 68, device=cuda, dtype=torch.bfloat16)
    ops.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(x[..., 1:65], x[..., :64], x[..., :64])
    with pytest.raises(ValueError, match="stride 68"):
        ops.flash_attention(x[..., :64], x[..., :64], x[..., :64])
    assert sum(tfa.VARIANT_LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,D,pos,off", cases.DECODE_GRID)
def test_flash_decode_vs_plain(cuda, B, H, Hkv, T, D, pos, off, dtype):
    rng = np.random.RandomState(T + D + pos)
    q = cases.randn(rng, (B, H, D), cuda, dtype)
    kc = cases.randn(rng, (B, T, Hkv, D), cuda, dtype)
    vc = cases.randn(rng, (B, T, Hkv, D), cuda, dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["flash_decode_partial"]
    got = ops.flash_decode_partial(q, kc, vc, pos_t, kv_offset=off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode_partial"] == before + 1
    want = tfd.flash_decode_plain(q, kc, vc, pos_t, kv_offset=off)
    for g, w, tol in zip(got, want, cases.DECODE_TOL):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    if off > pos:
        o, l, m = got
        assert not o.any() and not l.any() and bool((m == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,D,pos,off", [
    (8, 9, 3, 2048, 64, 1087, 0), (1, 2, 1, 4096, 128, 4095, 0),
    (96, 9, 3, 128, 64, 100, 0),
    (4, 32, 32, 1024, 112, 527, 0)])      # zamba2-7b: spare lanes a row
def test_flash_decode_deterministic(cuda, B, H, Hkv, T, D, pos, off, dtype):
    """The splits merge in a fixed order: two launches on the same inputs
    are bitwise equal (many splits, and one; head dim 112, whose row
    groups carry spare lanes)."""
    rng = np.random.RandomState(T + D + pos)
    q = cases.randn(rng, (B, H, D), cuda, dtype)
    kc = cases.randn(rng, (B, T, Hkv, D), cuda, dtype)
    vc = cases.randn(rng, (B, T, Hkv, D), cuda, dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    first = ops.flash_decode_partial(q, kc, vc, pos_t, kv_offset=off)
    second = ops.flash_decode_partial(q, kc, vc, pos_t, kv_offset=off)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_decode_refuses_misaligned(cuda):
    """The kernel reads 16 bytes a load and never copies: an operand
    offset by one element from an aligned buffer is refused before any
    launch."""
    B, H, Hkv, T, D = 2, 9, 3, 64, 64
    n = B * T * Hkv * D
    buf = torch.zeros(n + B * H * D + 1, device=cuda, dtype=torch.bfloat16)
    q, kc = buf[:B * H * D].view(B, H, D), buf[:n].view(B, T, Hkv, D)
    ops.reset_launches()
    for args in ((buf[1:1 + B * H * D].view(B, H, D), kc, kc),
                 (q, buf[1:1 + n].view(B, T, Hkv, D), kc),
                 (q, kc, buf[1:1 + n].view(B, T, Hkv, D))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_decode_partial(*args, 10)
    assert ops.LAUNCHES["flash_decode_partial"] == 0


@pytest.mark.cuda
def test_attention_kernels_refuse_bad_input(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)          # D = 48
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode_partial(q[:, :, 0], q.transpose(1, 2)[:, ::2],
                                 q.transpose(1, 2)[:, ::2], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(num_kv_heads=3), dict(num_kv_heads=1),
    dict(num_kv_heads=1, pad_heads_to=6, attn_bias=True, qk_norm=True)],
    ids=["G1", "G3", "options"])
def test_lm_on_card_matches_cpu(cuda, kw):
    cfg = smollm_135m.REDUCED.replace(**kw, dtype="float32",
                                      param_dtype="float32")
    model = DecoderLM(cfg)
    gen = torch.Generator().manual_seed(3)       # biases, norms act too
    params = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen),
                      model.init(0, device="cpu"))
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 40))
    cpu_logits, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    want = LMServingEngine(model, params, cache_len=64,
                           device="cpu").generate(toks, steps=6)
    dev_params = tree_map(lambda t: t.to(cuda), params)
    logits, _ = model.prefill(dev_params,
                              {"tokens": torch.from_numpy(toks).to(cuda)})
    torch.testing.assert_close(logits.cpu(), cpu_logits, atol=1e-4,
                               rtol=1e-4)
    ops.reset_launches()
    got = LMServingEngine(model, dev_params, cache_len=64).generate(toks,
                                                                   steps=6)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    assert ops.LAUNCHES["flash_decode_partial"] == cfg.num_layers * 6
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_decode_step_makes_no_host_sync(cuda):
    """``pos`` stays on the device and the cache is written in place: a
    decode step never waits for the card (sync debug mode raises on any
    operation that would)."""
    model = DecoderLM(smollm_135m.REDUCED.replace(num_kv_heads=1))
    params = model.init(0, device=cuda)
    toks = torch.randint(0, 256, (2, 24), device=cuda, dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=32)
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, cache = model.decode_step(params, cache, {"tokens": tok})
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(cache["pos"]) == 25


def _zoo_launches(cfg, steps: int):
    """(attention launches a prefill, decode launches over ``steps``)."""
    if cfg.family == "audio":                 # encoder, self, cross
        return (cfg.encdec.num_encoder_layers + 2 * cfg.num_layers,
                2 * cfg.num_layers * steps)
    if cfg.family == "hybrid":                # the shared block per group
        groups = cfg.num_layers // cfg.ssm.attn_every
        return groups, groups * steps
    if cfg.family == "ssm":                   # attention-free
        return 0, 0
    return cfg.num_layers, cfg.num_layers * steps


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b",
                                  "llava-next-mistral-7b",
                                  "whisper-large-v3", "zamba2-7b",
                                  "rwkv6-3b"])
def test_zoo_arch_on_card_matches_cpu(cuda, arch):
    """The reduced MoE, VLM, whisper and recurrent models in fp32:
    prefill logits on the card within 1e-4 of the CPU's (the kernels'
    plain versions), the same greedy tokens, and every attention through
    the kernels (none for rwkv6)."""
    cfg = get_reduced(arch).replace(dtype="float32", param_dtype="float32")
    model = registry.build(cfg)
    gen = torch.Generator().manual_seed(3)       # gates and norms act too
    params = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen),
                      model.init(0, device="cpu"))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (2, 40))
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = torch.from_numpy(rng.randn(
            2, cfg.encdec.encoder_seq, cfg.d_model).astype(np.float32))
    if cfg.family == "vlm":
        extra["images"] = torch.from_numpy(rng.randn(
            2, cfg.vlm.num_patches, cfg.d_model).astype(np.float32))
    batch = dict(extra, tokens=torch.from_numpy(toks))
    cpu_logits, _ = model.prefill(params, batch)
    want = LMServingEngine(model, params, cache_len=96,
                           device="cpu").generate(toks, steps=6, extra=extra)
    dev_params = tree_map(lambda t: t.to(cuda), params)
    logits, _ = model.prefill(dev_params,
                              {k: v.to(cuda) for k, v in batch.items()})
    torch.testing.assert_close(logits.cpu(), cpu_logits, atol=1e-4,
                               rtol=1e-4)
    ops.reset_launches()
    got = LMServingEngine(model, dev_params, cache_len=96).generate(
        toks, steps=6, extra=extra)
    attn, decode = _zoo_launches(cfg, 6)
    assert ops.LAUNCHES["flash_attention"] == attn
    assert ops.LAUNCHES["flash_decode_partial"] == decode
    assert sum(ops.LAUNCHES.values()) == attn + decode
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_moe_decode_step_sync_free_and_repeatable(cuda):
    """An MoE decode step (routing, capacity dispatch, the ordered
    combine) never waits for the card, and two steps from copies of one
    cache give bitwise equal logits in bf16 (no atomics in the
    combine)."""
    model = registry.build(get_reduced("qwen2-moe-a2.7b"))
    params = model.init(0, device=cuda)
    toks = torch.randint(0, 256, (4, 24), device=cuda, dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=32)
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    copies = [{k: v.clone() for k, v in cache.items()} for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [model.decode_step(params, c, {"tokens": tok})[0]
                for c in copies]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_recurrent_decode_step_sync_free_and_repeatable(cuda, arch):
    """A recurrent decode step (zamba2: SSM and conv states and the
    shared block's KV cache written in place at the device ``pos``;
    rwkv6: the WKV state) never waits for the card, and two steps from
    copies of one cache give bitwise equal logits in bf16."""
    model = registry.build(get_reduced(arch))
    params = model.init(0, device=cuda)
    toks = torch.randint(0, 256, (4, 24), device=cuda, dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=32)
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    copies = [tree_map(torch.clone, cache) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [model.decode_step(params, c, {"tokens": tok})
                for c in copies]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert outs[0][0].dtype == torch.bfloat16
    assert torch.equal(outs[0][0], outs[1][0])
    assert int(outs[0][1]["pos"]) == 24


@pytest.mark.cuda
def test_kernels_refuse_grad_requiring_operands(cuda):
    """The CUDA kernels have no backward: each wrapper raises on an
    operand that requires grad while grad mode is on (where it would
    otherwise drop the gradient), and launches under ``torch.no_grad``."""
    q = torch.randn(1, 2, 64, 64, device=cuda, requires_grad=True)
    qd = torch.randn(1, 2, 64, device=cuda, requires_grad=True)
    kc = torch.randn(1, 32, 2, 64, device=cuda)
    tables = torch.randn(2, 16, 128, device=cuda, requires_grad=True)
    idx = torch.zeros(4, 2, 3, dtype=torch.int32, device=cuda)
    pos = torch.tensor(7, dtype=torch.int32, device=cuda)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "flash_decode_partial": lambda: ops.flash_decode_partial(
            qd, kc, kc, pos),
        "embedding_bag": lambda: ops.embedding_bag(tables, idx),
        "embedding_bag_fused_flat": lambda: ops.embedding_bag_fused(
            tables, idx),
        "embedding_bag_nmp_flat": lambda: ops.embedding_bag_nmp(tables, idx),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call()
    ops.reset_launches()
    with torch.no_grad():
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    assert all(n == 1 for n in ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b",
                                  "zamba2-7b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """A reduced fp32 train step (the loss through the blocked attention,
    the update in place) on the card against the same step on the CPU:
    loss and gradient norm within 1e-5 relative, parameters within 1e-5
    after an SGD step at lr 1 (they move by the clipped gradient itself;
    Adam's first step would magnify the last bits of gradients below its
    eps); no kernel launches."""
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.train_loop import make_train_step

    cfg = get_reduced(arch).replace(dtype="float32", param_dtype="float32")
    model = registry.build(cfg)
    cpu_params = model.init(0, device="cpu")
    dev_params = tree_map(lambda t: t.to(cuda), cpu_params)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    opt = OptConfig(kind="sgd", lr=1.0)
    step = make_train_step(model, opt)
    ops.reset_launches()
    dev_params, _, dm = step(dev_params, init_state(opt, dev_params),
                             {k: v.to(cuda) for k, v in batch.items()})
    cpu_params, _, cm = step(cpu_params, init_state(opt, cpu_params), batch)
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(dm[key]), float(cm[key]), rtol=1e-5)
    for a, b in zip(tree_leaves(dev_params), tree_leaves(cpu_params)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-5,
                                   rtol=0)


#: (B, H, Hkv, T, D) x pos: in the first shard, in the second, past T
SHARDED_DECODE = [((2, 9, 3, 256, 64), (10, 130, 1000)),
                  ((2, 4, 2, 200, 112), (0, 150, 250))]

SHARDED_DECODE_RANK = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, d = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "store"), rank=rank, world_size=2)
try:
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    mesh = make_host_mesh(2)
    data = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    with shd.use_mesh(mesh, None):
        for key in sorted({k.rsplit("/", 1)[0] for k in data.files}):
            dtype = torch.bfloat16 if "bfloat16" in key else torch.float32
            t = {n: torch.from_numpy(data[f"{key}/{n}"]).cuda().to(dtype)
                 for n in ("q", "kc", "vc", "k", "v")}
            n = t["kc"].shape[1] // 2
            kc = t["kc"][:, rank * n:(rank + 1) * n].clone()
            vc = t["vc"][:, rank * n:(rank + 1) * n].clone()
            pos = torch.tensor(int(data[f"{key}/pos"]), dtype=torch.int32,
                               device="cuda")
            o, kc, vc = L.sharded_decode_attention(t["q"], kc, vc, t["k"],
                                                   t["v"], pos, "model")
            torch.cuda.synchronize()
            out[f"{key}/o"] = o.float().cpu().numpy()
            out[f"{key}/kc"] = kc.float().cpu().numpy()
            out[f"{key}/vc"] = vc.float().cpu().numpy()
    np.savez(os.path.join(d, f"rank-{rank}.npz"), **out)
finally:
    dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_sharded_decode_on_card_matches_unsharded(cuda, tmp_path):
    """Two gloo ranks on the card, each with half the sequence of one
    cache: the sharded decode (the kernel on each slice at its
    ``kv_offset``, the partials combined over ``model``) against the
    unsharded one on the whole cache."""
    from repro_torch.models import layers as L

    rng = np.random.RandomState(11)
    inputs, want = {}, {}
    for (B, H, Hkv, T, D), poss in SHARDED_DECODE:
        for pos in poss:
            for name, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                key = f"{D}-{pos}-{name}"
                arrs = {"q": rng.randn(B, H, D), "kc": rng.randn(B, T, Hkv, D),
                        "vc": rng.randn(B, T, Hkv, D), "k": rng.randn(B, Hkv, D),
                        "v": rng.randn(B, Hkv, D)}
                for n, a in arrs.items():
                    inputs[f"{key}/{n}"] = a.astype(np.float32)
                inputs[f"{key}/pos"] = np.array(pos)
                t = {n: torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)
                     for n, a in arrs.items()}
                p = torch.tensor(pos, dtype=torch.int32, device=cuda)
                with torch.no_grad():
                    o, kc, vc = L.decode_attention_unsharded(
                        t["q"], t["kc"], t["vc"], t["k"], t["v"], p)
                want[key] = (o.float().cpu(), kc.float().cpu(),
                             vc.float().cpu(), dtype)
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", SHARDED_DECODE_RANK,
                               str(r), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = [np.load(tmp_path / f"rank-{r}.npz") for r in range(2)]
    for key, (o, kc, vc, dtype) in want.items():
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        for r, res in enumerate(ranks):
            n = kc.shape[1] // 2
            np.testing.assert_array_equal(res[f"{key}/kc"],
                                          kc[:, r * n:(r + 1) * n].numpy())
            np.testing.assert_array_equal(res[f"{key}/vc"],
                                          vc[:, r * n:(r + 1) * n].numpy())
            np.testing.assert_allclose(res[f"{key}/o"], o.numpy(), rtol=tol,
                                       atol=tol)

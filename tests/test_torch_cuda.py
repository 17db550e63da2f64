"""The port's CUDA kernels and device path on the card (marker ``cuda``).

Every test here needs a CUDA card and skips without one; the file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held against their plain PyTorch versions: fp32 (and
bf16, whose rows widen to fp32 exactly and add in the same order) is
bitwise equal.  The cluster on the card is held against the same
cluster on the CPU: equal stats, scores within rtol=1e-5, atol=1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import rm1
from repro_torch.data.queries import dlrm_request_stream
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ops
from repro_torch.models.dlrm import DLRMModel
from repro_torch.serving.cluster import ClusterConfig, ClusterEngine
from repro_torch.serving.engine import Request
from repro_torch.serving.scenario import FailMN

GRID = [(1, 64, 8, 4, 4), (4, 100, 16, 8, 10), (3, 257, 32, 5, 7),
        (2, 128, 128, 16, 20),
        (3, 96, 13, 6, 5),        # D not a multiple of the vector width
        (2, 50, 8, 5, 1)]         # single-slot bags
KERNELS = ["embedding_bag_fused_flat", "embedding_bag_nmp_flat"]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,D,B,P", GRID)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_bitwise_vs_plain(cuda, kernel, T, R, D, B, P, dtype):
    flat, offsets, idx = _case(T, R, D, B, P, cuda, dtype)
    before = ops.LAUNCHES[kernel]
    got = getattr(ops, kernel)(flat, offsets, idx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    assert torch.equal(got, teb.embedding_bag_flat_plain(flat, offsets, idx))


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
    assert all(n > 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
    assert dataclasses.asdict(stats) == dataclasses.asdict(cpu_stats)
    want = {r.rid: r.outputs for r in cpu_res}
    for r in res:
        np.testing.assert_allclose(r.outputs, want[r.rid], rtol=1e-5,
                                   atol=1e-6)

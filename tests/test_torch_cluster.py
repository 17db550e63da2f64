"""The port's ClusterEngine against ``repro.serving.cluster`` on the
reduced RM1, 16 requests, with the reference's weights.

The virtual clock and every counter depend only on indices and bytes,
so ``ClusterStats`` is equal field for field (nan-aware).  Scores agree
within rtol=1e-5, atol=1e-6 (the dense tower's fp32 products run in
another library).  Inside the port, scores are bitwise equal across pool
mixes, cache on or off and in-flight depths, as the reference pins.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs import rm1
from repro.models.dlrm import DLRMModel as JaxDLRM
from repro.serving.cluster import ClusterConfig as JaxConfig
from repro.serving.cluster import ClusterEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import rm1 as trm1
from repro_torch.data.queries import QueryDist, dlrm_batch
from repro_torch.models.dlrm import DLRMModel, params_from_reference
from repro_torch.serving.cluster import ClusterConfig, ClusterEngine
from repro_torch.serving.engine import Request
from repro_torch.serving.scenario import FailMN

MIXED = ("ddr_mn", "ddr_mn", "nmp_mn", "nmp_mn")
CASES = {
    "all_ddr": dict(kw={}, events=()),
    "mixed_fail": dict(kw=dict(mn_types=MIXED),
                       events=((0.02, 2),)),
    "cache": dict(kw=dict(cache_mb=0.05), events=()),
    "depth4": dict(kw=dict(inflight_depth=4, mn_types=MIXED), events=()),
}


def assert_same(a, b, path="stats"):
    """Equal field for field; nan equals nan."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def setup():
    jm, tm = JaxDLRM(rm1.REDUCED), DLRMModel(trm1.REDUCED)
    jp = jm.init(0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(0)
    sizes = QueryDist(mean_size=6.0, max_size=40).sample(rng, 16)
    stream = []
    for i, s in enumerate(sizes):
        b = dlrm_batch(trm1.REDUCED, int(s), rng)
        stream.append((i, {"dense": b["dense"], "indices": b["indices"]},
                       int(s), 0.002 * i))
    return jm, jp, tm, tp, stream


def _serve_port(setup, kw, events):
    _, _, tm, tp, stream = setup
    eng = ClusterEngine(tm, tp, ClusterConfig(batch_size=32, **kw),
                        device="cpu")
    res, stats = eng.serve([Request(*r) for r in stream],
                           events=[FailMN(t, mn=j) for t, j in events])
    return {r.rid: r.outputs for r in res}, stats


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_and_scores_match_reference(setup, case):
    jm, jp, _, _, stream = setup
    kw, events = CASES[case]["kw"], CASES[case]["events"]
    jkw = dict(kw, mn_types=list(kw["mn_types"])) if "mn_types" in kw else kw
    jeng = JaxEngine(jm, jp, JaxConfig(batch_size=32, **jkw))
    jres, jstats = jeng.serve([JaxRequest(*r) for r in stream],
                              failures=list(events))
    got, stats = _serve_port(setup, kw, events)
    assert stats.completed == len(stream)
    assert stats.failures == len(events)
    assert_same(dataclasses.asdict(stats), dataclasses.asdict(jstats))
    for r in jres:
        np.testing.assert_allclose(got[r.rid], r.outputs, rtol=1e-5,
                                   atol=1e-6)


def test_scores_bitwise_invariant_in_port(setup):
    """Pool mix, cache and depth move bytes and time, never values."""
    runs = [_serve_port(setup, CASES[c]["kw"], CASES[c]["events"])[0]
            for c in sorted(CASES)]
    for other in runs[1:]:
        assert other.keys() == runs[0].keys()
        for rid, out in runs[0].items():
            assert np.array_equal(out, other[rid])


def test_plain_reference_path_close(setup):
    """use_kernel=False pools with the one-reduction reference."""
    kernel, _ = _serve_port(setup, {}, ())
    plain, _ = _serve_port(setup, dict(use_kernel=False), ())
    for rid, out in kernel.items():
        np.testing.assert_allclose(plain[rid], out, rtol=1e-5, atol=1e-6)


def test_params_must_lie_on_the_engine_device(setup):
    _, _, tm, tp, _ = setup
    with pytest.raises(ValueError, match="engine runs on"):
        ClusterEngine(tm, tp, ClusterConfig(), device="meta")

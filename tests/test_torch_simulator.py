"""The port's discrete-event simulator against ``repro.serving.simulator``.

Both are numpy only over the analytic serving-unit model, so the same
config and seed give the same ``SimStats`` field for field (exact, nan
equal to nan) under both scheduling policies, with and without failure
injection, on a disaggregated and a monolithic unit; the latency-bounded
rate search and the processor-sharing schedule are exactly equal too.
"""
import dataclasses
import math

import numpy as np
import pytest

import repro.core.failure as jfail
import repro_torch.core.failure as tfail
from repro.configs import rm1 as jrm1
from repro.configs import rm2 as jrm2
from repro.core.serving_unit import ServingUnitModel as JUnit
from repro.core.serving_unit import UnitSpec as JSpec
from repro.data.queries import QueryDist as JDist
from repro.serving import simulator as jsim
from repro_torch.configs import rm1 as trm1
from repro_torch.configs import rm2 as trm2
from repro_torch.core.scheduler import INTERLEAVED, SEQUENTIAL
from repro_torch.core.serving_unit import ServingUnitModel as TUnit
from repro_torch.core.serving_unit import UnitSpec as TSpec
from repro_torch.data.queries import QueryDist as TDist
from repro_torch.serving import simulator as tsim

UNITS = {
    "rm1_disagg": (jrm1, dict(n=2, cn_type="cn_1g", m=2, mn_type="ddr_mn")),
    "rm2_nmp": (jrm2, dict(n=3, cn_type="cn_4g", m=2, mn_type="nmp_mn")),
    "rm1_mono": (jrm1, dict(n=2, cn_type="so1s_1g", scheme="distributed")),
}


def _sims(unit, policy, **kw):
    jcfg_mod, spec = UNITS[unit]
    tcfg_mod = trm1 if jcfg_mod is jrm1 else trm2
    cfg = dict(policy=policy, batch_size=128, duration_s=3.0, warmup_s=0.5,
               seed=3, **kw)
    return (jsim.ClusterSim(JUnit(jcfg_mod.generation(0), JSpec(**spec)),
                            jsim.SimConfig(**cfg)),
            tsim.ClusterSim(TUnit(tcfg_mod.generation(0), TSpec(**spec)),
                            tsim.SimConfig(**cfg)))


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.fixture
def failing(monkeypatch):
    """Failures certain within the simulated window, in both packages."""
    def arm(duration_s):
        for mod in (jfail, tfail):
            monkeypatch.setattr(mod.hw, "FAIL_CN", 86400.0 / duration_s)
            monkeypatch.setattr(mod.hw, "FAIL_MN", 86400.0 / duration_s)
    return arm


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("policy", [SEQUENTIAL, INTERLEAVED])
@pytest.mark.parametrize("unit", sorted(UNITS))
def test_run_matches_reference(unit, policy, inject, failing):
    js, ts = _sims(unit, policy, inject_failures=inject)
    if inject:
        failing(ts.cfg.duration_s)
    for rate in (20.0, 80.0):
        want = dataclasses.asdict(js.run(rate))
        got = dataclasses.asdict(ts.run(rate))
        assert_same(got, want)
        assert got["completed"] > 0
        if inject:
            assert got["failures"] >= 1


def test_run_with_query_dist_matches_reference():
    js, ts = _sims("rm1_disagg", SEQUENTIAL)
    kw = dict(mean_size=12.0, sigma=0.8, max_size=256, alpha=1.05)
    assert_same(dataclasses.asdict(ts.run(40.0, TDist(**kw))),
                dataclasses.asdict(js.run(40.0, JDist(**kw))))


@pytest.mark.parametrize("policy", [SEQUENTIAL, INTERLEAVED])
def test_latency_bounded_qps_matches_reference(policy):
    js, ts = _sims("rm1_disagg", policy)
    for sla in (0.25, 5.0):
        assert (ts.latency_bounded_qps(sla=sla, iters=6)
                == js.latency_bounded_qps(sla=sla, iters=6))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ps_schedule_matches_reference(seed):
    rng = np.random.RandomState(seed)
    arrivals = np.sort(rng.exponential(1.0, 40).cumsum() * 0.3)
    works = rng.exponential(1.0, 40)
    for kw in ({}, dict(busy_until=2.0), dict(overhead=0.25),
               dict(max_concurrency=1), dict(max_concurrency=8,
                                             overhead=0.1)):
        got = tsim._ps_schedule(arrivals, works, **kw)
        want = jsim._ps_schedule(arrivals, works, **kw)
        assert np.array_equal(got, want), kw

"""The port's fleet serving against ``repro.serving.fleet`` and the fleet
half of ``repro.serving.cluster``: RM1 and RM2 (reduced, 8 x 1000 x 16
tables each) on one shared pool.

- The merged request stream of ``plan_fleet_workload`` is equal (rid,
  arrival, model tag, size, payloads bitwise, phases) for
  ``fleet_shift`` and for a spec whose ``ShiftTraffic`` drains a model
  to zero share.
- ``run_fleet`` on the reference's weights (``params_from_reference``)
  gives a ``ScenarioReport.to_dict()`` equal field for field, nan-aware,
  ``per_model`` included, with per-model SLA controllers that act;
  scores agree within rtol=1e-5, atol=1e-6 (the dense towers' fp32
  products run in another library).
- A one-model fleet spec normalizes to the single-model path, in both
  packages and bitwise inside the port.
- The shared pool's uniform-shape error, the per-model cache budget
  split (``_cache_budgets``) and its rebalance are the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import rm1 as jrm1
from repro.serving import fleet as jfleet
from repro.serving import scenario as jscen
from repro.serving.cluster import ClusterConfig as JConfig
from repro.serving.cluster import ClusterEngine as JEngine
from repro.models.dlrm import DLRMModel as JDLRM
from repro_torch import configs as tconfigs
from repro_torch.configs import rm1 as trm1
from repro_torch.models.dlrm import DLRMModel, params_from_reference
from repro_torch.serving import fleet as tfleet
from repro_torch.serving import scenario as tscen
from repro_torch.serving.cluster import ClusterConfig, ClusterEngine
from tests.test_torch_scenario import PRESETS, assert_same

SHIFT_TO_ZERO = dict(
    name="fleet-drain", requests=40,
    events=lambda m: (m.ShiftTraffic(0.02, from_model="rm1", to_model="rm2",
                                     share=0.5),
                      m.SetWorkload(0.05, alpha=1.2),
                      m.ShiftTraffic(0.07, from_model="rm2", to_model="rm1",
                                     share=0.25)))


def _spec(mod, case):
    """The same fleet spec built by one package's scenario module."""
    if case == "fleet_shift":
        return mod.ScenarioSpec.load(str(PRESETS / "fleet_shift.json"))
    if case == "drain":
        return mod.ScenarioSpec(
            name=SHIFT_TO_ZERO["name"],
            models=(mod.ModelRef(arch="rm1", rate_share=0.5),
                    mod.ModelRef(arch="rm2", rate_share=0.5)),
            topology=mod.smoke_topology(batch_size=16, cache_mb=0.02),
            workload=mod.Workload(requests=SHIFT_TO_ZERO["requests"],
                                  mean_size=4.0, max_size=24, gap_s=0.002,
                                  arrival="poisson", seed=2),
            events=SHIFT_TO_ZERO["events"](mod))
    # per-model SLA targets: rm1 its own tight one, rm2 the spec's
    return mod.ScenarioSpec(
        name="fleet-sla",
        models=(mod.ModelRef(arch="rm1", rate_share=0.6, sla_p99_s=5e-4),
                mod.ModelRef(arch="rm2", rate_share=0.4)),
        topology=mod.smoke_topology(n_cn=1, m_mn=2, batch_size=16,
                                    cache_mb=0.02, max_wait_s=5e-4),
        workload=mod.Workload(requests=96, mean_size=4.0, max_size=24,
                              gap_s=2e-4, arrival="poisson", seed=4),
        sla_p99_s=2e-3,
        events=(mod.ShiftTraffic(0.008, from_model="rm1", to_model="rm2",
                                 share=0.3),))


def _members(spec_j):
    """The reference's fleet (its own seeded init) and the port's copy of
    it on the CPU."""
    ref = jfleet.build_fleet(spec_j)
    port = [tfleet.FleetModel(
        name=m.name, ref=m.ref,
        model=DLRMModel(tconfigs.get_reduced(m.ref.arch)),
        params=params_from_reference(jax.tree.map(np.asarray, m.params),
                                     device="cpu")) for m in ref]
    for t, j in zip(port, ref):
        assert (dataclasses.asdict(t.model.cfg.dlrm)
                == dataclasses.asdict(j.model.cfg.dlrm))
    return ref, port


@pytest.mark.parametrize("case", ["fleet_shift", "drain"])
def test_fleet_stream_matches_reference(case):
    spec_j, spec_t = _spec(jscen, case), _spec(tscen, case)
    assert spec_t.to_dict() == spec_j.to_dict()
    ref, port = _members(spec_j)
    jreqs, jphases = jfleet.plan_fleet_workload(spec_j, ref)
    treqs, tphases = tfleet.plan_fleet_workload(spec_t, port)
    assert len(treqs) == len(jreqs) == spec_t.workload.requests
    for a, b in zip(treqs, jreqs):
        assert (a.rid, a.arrival, a.model, a.size) == (
            b.rid, b.arrival, b.model, b.size)
        assert a.payload.keys() == b.payload.keys()
        for k in a.payload:
            assert a.payload[k].dtype == b.payload[k].dtype
            assert np.array_equal(a.payload[k], b.payload[k])
    assert ([dataclasses.asdict(p) for p in tphases]
            == [dataclasses.asdict(p) for p in jphases])
    if case == "drain":       # rm1 silenced between the shifts
        mids = [r.model for r in treqs if 0.02 <= r.arrival < 0.07]
        assert mids and set(mids) == {1}


@pytest.fixture(scope="module")
def runs():
    """Each fleet spec served once per package on the same weights."""
    out = {}
    for case in ("fleet_shift", "sla"):
        spec_j, spec_t = _spec(jscen, case), _spec(tscen, case)
        ref, port = _members(spec_j)
        out[case] = (tfleet.run_fleet(spec_t, fleet=port, device="cpu"),
                     jfleet.run_fleet(spec_j, fleet=ref))
    return out


@pytest.mark.parametrize("case", ["fleet_shift", "sla"])
def test_run_fleet_matches_reference(runs, case):
    got, want = runs[case]
    assert got.completed == got.total == want.total
    assert set(got.stats.per_model) == {"rm1", "rm2"}
    assert all(m.completed > 0 for m in got.stats.per_model.values())
    assert_same(got.to_dict(), want.to_dict())
    assert got.summary() == want.summary()
    if case == "sla":
        assert got.stats.sla_actions >= 1 and got.stats.sla_window_filled
    by_rid = {r.rid: r.outputs for r in got.results}
    for r in want.results:
        np.testing.assert_allclose(by_rid[r.rid], r.outputs, rtol=1e-5,
                                   atol=1e-6)


def test_run_scenario_delegates_fleet_specs(runs):
    """The front door builds the fleet itself (the port's own seeded
    init): the same stats as the injected run, other weights."""
    spec = _spec(tscen, "fleet_shift")
    rep = tscen.run_scenario(spec, device="cpu")
    injected, _ = runs["fleet_shift"]
    assert_same(rep.to_dict(), injected.to_dict())
    with pytest.raises(ValueError, match="single-model only"):
        tscen.run_scenario(spec, device="cpu", stream=([], []))
    with pytest.raises(ValueError, match="multi-model spec"):
        tfleet.run_fleet(tscen.ScenarioSpec.load(
            str(PRESETS / "failover_storm.json")), device="cpu")


def test_one_model_fleet_is_the_single_model_path():
    def spec(mod, fleet_form):
        kw = dict(name="one", topology=mod.smoke_topology(cache_mb=0.02),
                  workload=mod.Workload(requests=12, seed=5))
        ref = mod.ModelRef(arch="rm1", init_seed=3)
        return (mod.ScenarioSpec(models=(ref,), **kw) if fleet_form
                else mod.ScenarioSpec(model=ref, **kw))
    one = spec(tscen, True)
    assert one == spec(tscen, False) and one.model is one.models[0]
    got = tscen.run_scenario(one, device="cpu")
    single = tscen.run_scenario(spec(tscen, False), device="cpu")
    assert got.bitwise_equal(single)
    assert_same(got.to_dict(), single.to_dict())
    assert_same(got.to_dict(),
                jscen.run_scenario(spec(jscen, True)).to_dict())


def test_uniform_shape_error_is_the_references():
    def wide(cfg):
        return cfg.replace(name="rm1-wide", dlrm=dataclasses.replace(
            cfg.dlrm, embed_dim=32))
    ma, mb = DLRMModel(trm1.REDUCED), DLRMModel(wide(trm1.REDUCED))
    ja, jb = JDLRM(jrm1.REDUCED), JDLRM(wide(jrm1.REDUCED))
    with pytest.raises(ValueError) as want:
        pa, pb = ja.init(0), jb.init(1)
        JEngine(ja, pa, JConfig(n_cn=1, m_mn=2, batch_size=8),
                fleet=[("a", ja, pa), ("b", jb, pb)])
    with pytest.raises(ValueError) as got:
        pa, pb = ma.init(0, device="cpu"), mb.init(1, device="cpu")
        ClusterEngine(ma, pa, ClusterConfig(n_cn=1, m_mn=2, batch_size=8),
                      fleet=[("a", ma, pa), ("b", mb, pb)], device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="primary"):
        ClusterEngine(ma, pa, ClusterConfig(), device="cpu",
                      fleet=[("b", mb, pb), ("a", ma, pa)])


def test_cache_budgets_match_reference():
    """The per-model split of one CN's cache, cold and after skewed
    traffic, and the rows a rebalance evicts, are the reference's."""
    spec_j = _spec(jscen, "fleet_shift")
    ref, port = _members(spec_j)
    spec_t = _spec(tscen, "fleet_shift")
    jcfg = spec_j.topology.cluster_config(seed=9)
    tcfg = spec_t.topology.cluster_config(seed=9)
    jeng = JEngine(ref[0].model, ref[0].params, jcfg,
                   fleet=[(m.name, m.model, m.params) for m in ref])
    teng = ClusterEngine(port[0].model, port[0].params, tcfg,
                         fleet=[(m.name, m.model, m.params) for m in port],
                         device="cpu")
    for budget in (0, 1, 50_000, 50_001):
        assert teng._cache_budgets(budget) == jeng._cache_budgets(budget)
    rng = np.random.RandomState(0)
    for step in range(3):
        counts = rng.randint(0, 500 * (step + 1), teng.T)
        tids = list(range(teng.T))
        jeng.hotness.update(tids, counts)
        teng.hotness.update(tids, counts)
        for budget in (50_000, 12_345):
            assert (teng._cache_budgets(budget)
                    == jeng._cache_budgets(budget))
    reqs, _ = tfleet.plan_fleet_workload(spec_t, port)
    jreqs, _ = jfleet.plan_fleet_workload(spec_j, ref)
    for (tr, jr) in zip(reqs[:6], jreqs[:6]):   # fill the caches
        p = tr.payload
        teng._execute(0, p["dense"], p["indices"], model=tr.model)
        jeng._execute(0, jr.payload["dense"], jr.payload["indices"],
                      model=jr.model)
    for k in (1, 0):           # skew hotness to one owner, then the other
        hot = [t for t in range(teng.T) if teng._tbl_owner[t] == k]
        jeng.hotness.update(hot, np.full(len(hot), 10**6))
        teng.hotness.update(hot, np.full(len(hot), 10**6))
        assert (teng.rebalance_cache_budgets()
                == jeng.rebalance_cache_budgets())
        assert ([c.stats.__dict__ for c in teng.caches]
                == [c.stats.__dict__ for c in jeng.caches])

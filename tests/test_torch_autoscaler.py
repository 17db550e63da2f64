"""The port's autoscalers against ``repro.serving.autoscaler``.

Both packages' autoscaler modules are numpy and the analytic models
only, so every output is held exactly: the diurnal ``Autoscaler``'s
``units_for``, ``series`` and ``plan`` for ``diurnal_elastic``'s toy
config, ``for_model(rm1)`` and ``monolithic(rm2)``; the node-hour and
energy accounting; and the ``SLAController`` fed one seeded sequence of
completions (and pool pressures), which must emit the same ``Resize``
actions and report the same sliding p99 after every step, in coupled
and decoupled mode.  The presets whose runs the SLA controller steers
(``flash_crowd``, ``spike_plus_failure``) give the reference's
``ScenarioReport`` field for field, as every preset does
(``test_torch_scenario.check_preset_report``).
"""
import math

import numpy as np
import pytest

from repro.configs import rm1 as jrm1
from repro.configs import rm2 as jrm2
from repro.serving import autoscaler as jas
from repro_torch.configs import rm1 as trm1
from repro_torch.configs import rm2 as trm2
from repro_torch.serving import autoscaler as tas
from tests.test_torch_scenario import SLA_PRESETS, check_preset_report

TOY = dict(qps_per_cn=1.0, qps_per_mn=0.5, min_cn=1, min_mn=2, max_cn=3,
           max_mn=6)                       # diurnal_elastic's toy policy


def _scalers(case):
    if case == "toy":
        return (jas.Autoscaler(jas.AutoscalerConfig(**TOY)),
                tas.Autoscaler(tas.AutoscalerConfig(**TOY)), 3.0)
    if case == "rm1_for_model":
        return (jas.Autoscaler.for_model(jrm1.CONFIG, n_replicas=2),
                tas.Autoscaler.for_model(trm1.CONFIG, n_replicas=2), 5e4)
    if case == "rm1_for_model_nmp":
        return (jas.Autoscaler.for_model(jrm1.CONFIG, cn_type="cn_4g",
                                         mn_type="nmp_mn", max_cn=6,
                                         max_mn=9),
                tas.Autoscaler.for_model(trm1.CONFIG, cn_type="cn_4g",
                                         mn_type="nmp_mn", max_cn=6,
                                         max_mn=9), 5e4)
    return (jas.Autoscaler.monolithic(jrm2.CONFIG),
            tas.Autoscaler.monolithic(trm2.CONFIG), 2e3)


CASES = ["toy", "rm1_for_model", "rm1_for_model_nmp", "rm2_monolithic"]


@pytest.mark.parametrize("case", CASES)
def test_autoscaler_matches_reference(case):
    ja, ta, peak = _scalers(case)
    assert ta.cfg.__dict__ == ja.cfg.__dict__
    for load in np.linspace(0.0, 1.5 * peak, 23).tolist() + [-1.0]:
        assert ta.units_for(load) == ja.units_for(load), load
    for steps in (8, 24, 96):
        assert ta.series(peak, steps) == ja.series(peak, steps)
        got = ta.plan(peak, duration_s=32 * 0.002, steps=steps)
        want = ja.plan(peak, duration_s=32 * 0.002, steps=steps)
        assert [tuple(e) for e in got] == [tuple(e) for e in want]
        assert all(isinstance(e, tas.ResizeEvent) for e in got)


@pytest.mark.parametrize("case", CASES)
def test_accounting_matches_reference(case):
    ja, ta, peak = _scalers(case)
    series = ta.series(peak, 96)
    assert series == ja.series(peak, 96)
    for duration in (86400.0, 4 * 3600.0):
        assert (tas.node_hours(series, duration)
                == jas.node_hours(series, duration))
        assert (tas.idle_node_hours(series, duration)
                == jas.idle_node_hours(series, duration))
        for cn, mn in (("cn_1g", "ddr_mn"), ("cn_4g", "nmp_mn"),
                       ("so1s_1g", "")):
            assert (tas.energy_joules(series, cn, mn, duration)
                    == jas.energy_joules(series, cn, mn, duration))


def _feed(seed, n=600):
    """A seeded completion sequence: latencies that swing through calm,
    breach and recovery, with per-pool queueing pressures that favour
    one pool, the other, or neither."""
    rng = np.random.RandomState(seed)
    t = np.cumsum(rng.exponential(1e-4, n))
    base = np.concatenate([np.full(n // 3, 2e-5), np.full(n // 3, 9e-5),
                           np.full(n - 2 * (n // 3), 1e-5)])
    lat = base * rng.lognormal(0.0, 0.5, n)
    cn_p = rng.exponential(1.0, n) * rng.choice([0.1, 1.0, 10.0], n)
    mn_p = rng.exponential(1.0, n)
    return list(zip(t.tolist(), lat.tolist(), cn_p.tolist(),
                    mn_p.tolist()))


@pytest.mark.parametrize("mode", ["coupled", "decoupled"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sla_controller_matches_reference(mode, seed):
    kw = dict(sla_p99_s=6e-5, window=16, cooldown=8, mode=mode)
    jc = jas.SLAController(jas.SLAControllerConfig(**kw), n_cn=1, m_mn=2)
    tc = tas.SLAController(tas.SLAControllerConfig(**kw), n_cn=1, m_mn=2)
    acted = 0
    for i, (t, lat, cn_p, mn_p) in enumerate(_feed(seed)):
        pressure = None if i % 7 == 0 else (cn_p, mn_p)
        got = tc.observe(t, lat, pressure=pressure)
        want = jc.observe(t, lat, pressure=pressure)
        assert [e.to_dict() for e in got] == [e.to_dict() for e in want], i
        acted += len(got)
        p_t, p_j = tc.p99(), jc.p99()
        assert p_t == p_j or (math.isnan(p_t) and math.isnan(p_j)), i
        assert (tc.n_cn, tc.m_mn) == (jc.n_cn, jc.m_mn)
        if i == 400:              # a peer moved the shared pool
            tc.sync_pool(3, 9)
            jc.sync_pool(3, 9)
    assert acted >= 2                   # the sequence makes it act
    assert tc.window_filled == jc.window_filled
    assert [e.to_dict() for e in tc.actions] == [e.to_dict()
                                                 for e in jc.actions]


@pytest.mark.parametrize("bad", [dict(sla_p99_s=0.0), dict(window=0),
                                 dict(band_low=1.0), dict(max_scale=0),
                                 dict(mode="sideways"), dict(mix_band=0.5)])
def test_sla_controller_rejects_what_the_reference_rejects(bad):
    kw = dict(dict(sla_p99_s=1e-3), **bad)
    with pytest.raises(ValueError) as want:
        jas.SLAController(jas.SLAControllerConfig(**kw), 1, 2)
    with pytest.raises(ValueError) as got:
        tas.SLAController(tas.SLAControllerConfig(**kw), 1, 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", SLA_PRESETS)
def test_sla_preset_report_matches_reference(name, monkeypatch):
    check_preset_report(name, monkeypatch)

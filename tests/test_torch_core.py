"""The port's failure-aware allocation (``core/allocator``, paper Eq. 1-3)
and TCO study (``core/tco``) against the JAX package's copies.

Both are pure Python over the analytic serving-unit model: the same
inputs run the same float arithmetic, so every result is held to exact
equality, field for field (``dataclasses.asdict``).  The cases are those
of ``tests/test_allocator_tco.py``.
"""
import dataclasses

import pytest

from repro.configs import rm1 as jrm1, rm2 as jrm2
from repro.core import allocator as jalloc, tco as jtco
from repro.core.serving_unit import UnitSpec as JUnit
from repro_torch.configs import rm1 as trm1, rm2 as trm2
from repro_torch.core import allocator as talloc, tco as ttco
from repro_torch.core.serving_unit import UnitSpec as TUnit

PEAK = 2e5
UNITS = [  # UnitSpec arguments
    dict(n=3, cn_type="cn_1g", m=8, mn_type="ddr_mn"),
    dict(n=11, cn_type="so1s_1g", scheme="distributed"),
    dict(n=8, cn_type="so1s_1g", scheme="distributed"),
    dict(n=2, cn_type="cn_4g", m=5, mn_type="nmp_mn"),
]


def _uid(unit):
    return f"{unit['n']}x{unit['cn_type']}"


def _asdict(x):
    return [dataclasses.asdict(p) for p in x] if isinstance(x, list) \
        else dataclasses.asdict(x)


def test_diurnal_load_equal():
    for peak, steps in ((50_000.0, 96), (1234.5, 24)):
        assert (talloc.diurnal_load(peak, steps)
                == jalloc.diurnal_load(peak, steps))


@pytest.mark.parametrize("unit", UNITS, ids=_uid)
@pytest.mark.parametrize("kw", [{}, {"f_cn": 0.5, "f_mn": 0.1},
                                {"f_mn": 0.1, "r_margin": 0.3, "steps": 48}],
                         ids=["default", "high-failure", "margin"])
@pytest.mark.parametrize("qps,load", [(1000.0, 50_000.0), (137.5, 9.9e5)])
def test_allocate_equal(unit, kw, qps, load):
    ju, tu = JUnit(**unit), TUnit(**unit)
    want = jalloc.allocate(ju, qps, ju.power(), load, **kw)
    got = talloc.allocate(tu, qps, tu.power(), load, **kw)
    assert _asdict(got) == _asdict(want)


def test_allocate_refuses_zero_qps():
    for mod, U in ((jalloc, JUnit), (talloc, TUnit)):
        unit = U(**UNITS[0])
        with pytest.raises(ValueError, match="QPS=0"):
            mod.allocate(unit, 0.0, unit.power(), PEAK)


@pytest.mark.parametrize("unit", UNITS, ids=_uid)
def test_allocate_from_model_equal(unit):
    want = jalloc.allocate_from_model(jrm1.generation(0), JUnit(**unit), PEAK)
    got = talloc.allocate_from_model(trm1.generation(0), TUnit(**unit), PEAK)
    assert _asdict(got) == _asdict(want)


def test_allocate_from_model_capacity_gate():
    """RM1 V5 (7.8 TB) does not fit one SU-2S server in either copy."""
    unit = dict(n=1, cn_type="su2s", scheme="su_numa")
    for mod, rm, U in ((jalloc, jrm1, JUnit), (talloc, trm1, TUnit)):
        with pytest.raises(ValueError, match="cannot hold"):
            mod.allocate_from_model(rm.generation(5), U(**unit), PEAK)


@pytest.mark.parametrize("cands", ["monolithic_candidates",
                                   "monolithic_nmp_candidates",
                                   "disagg_candidates"])
def test_best_unit_equal(cands):
    jbest, jplans = jalloc.best_unit(jrm1.generation(0),
                                     getattr(jtco, cands)(), PEAK)
    tbest, tplans = talloc.best_unit(trm1.generation(0),
                                     getattr(ttco, cands)(), PEAK)
    assert _asdict(tbest) == _asdict(jbest)
    assert _asdict(tplans) == _asdict(jplans)


@pytest.mark.parametrize("rm,cands", [
    ("rm1", "disagg_candidates"), ("rm2", "disagg_candidates"),
    ("rm1", "monolithic_candidates"), ("rm2", "monolithic_nmp_candidates")])
def test_evolution_study_equal(rm, cands):
    jgens = {"rm1": jrm1, "rm2": jrm2}[rm].GENERATIONS
    tgens = {"rm1": trm1, "rm2": trm2}[rm].GENERATIONS
    want = jtco.evolution_study(jgens, getattr(jtco, cands), PEAK)
    got = ttco.evolution_study(tgens, getattr(ttco, cands), PEAK)
    assert [g.model_name for g in got] == [g.model_name for g in want]
    assert _asdict(got) == _asdict(want)


@pytest.mark.parametrize("unit", UNITS, ids=_uid)
def test_idleness_breakdown_equal(unit):
    want = jtco.idleness_breakdown(jrm1.generation(0), JUnit(**unit), PEAK)
    got = ttco.idleness_breakdown(trm1.generation(0), TUnit(**unit), PEAK)
    assert got == want

"""The port's scenario front door against ``repro.serving.scenario``.

For every single-model preset without an SLA, the port's
``ScenarioReport.to_dict()`` (stats, phases, audit trail, latency model;
no scores) equals the reference's field for field, nan-aware, and the
port's clock sanitizer (``REPRO_CLOCKSAN=1``) finds nothing.
"""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

from repro.serving.scenario import ScenarioReport as JaxReport
from repro.serving.scenario import ScenarioSpec as JaxSpec
from repro.serving.scenario import run_scenario as jax_run_scenario
from repro_torch.analysis import clocksan
from repro_torch.launch import serve
from repro_torch.serving.scenario import (ScenarioReport, ScenarioSpec,
                                          plan_workload, run_scenario)

PRESETS = Path(__file__).resolve().parents[1] / "examples" / "scenarios"
PORTED = ["failover_storm", "diurnal_elastic", "skew_drift",
          "mixed_ddr_nmp", "pipeline_burst"]


def assert_same(a, b, path="report"):
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


@pytest.mark.parametrize("name", PORTED)
def test_preset_report_matches_reference(name, monkeypatch):
    monkeypatch.setenv("REPRO_CLOCKSAN", "1")     # a finding raises
    clocksan.reset()
    path = str(PRESETS / f"{name}.json")
    spec = ScenarioSpec.load(path)
    assert spec.to_dict() == JaxSpec.load(path).to_dict()
    got = run_scenario(spec, device="cpu")
    monkeypatch.delenv("REPRO_CLOCKSAN")
    want = jax_run_scenario(JaxSpec.load(path))
    assert got.completed == got.total == want.total
    assert_same(got.to_dict(), want.to_dict())
    assert got.summary()[1:] == want.summary()[1:]


@pytest.mark.parametrize("name", ["flash_crowd", "fleet_shift"])
def test_unported_branches_raise(name):
    spec = ScenarioSpec.load(str(PRESETS / f"{name}.json"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_scenario(spec, device="cpu")


def test_preplanned_stream_is_reused():
    """A pre-planned stream gives the same report as planning anew."""
    spec = ScenarioSpec.load(str(PRESETS / "mixed_ddr_nmp.json"))
    a = run_scenario(spec, device="cpu")
    b = run_scenario(spec, device="cpu",
                     stream=plan_workload(spec, a.engine.model.cfg))
    assert_same(a.to_dict(), b.to_dict())


def test_cli_cluster_and_single_unit(capsys):
    assert serve.main(["--cluster", "--mn-type", "2xddr_mn+2xnmp_mn",
                       "--fail-mn", "1", "--requests", "8",
                       "--device", "cpu"]) == 0
    assert serve.main(["--requests", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] scored 8/8 queries" in out
    assert "[serve] scored 4 queries" in out
    for flags in (["--elastic"], ["--sla-p99-ms", "5"], ["--models", "rm1"]):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            serve.main(["--cluster", "--device", "cpu"] + flags)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        serve.main(["--arch", "smollm-135m", "--device", "cpu"])


def test_report_fields_are_the_references():
    assert ([f.name for f in dataclasses.fields(ScenarioReport)]
            == [f.name for f in dataclasses.fields(JaxReport)])

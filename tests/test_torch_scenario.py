"""The port's scenario front door against ``repro.serving.scenario``.

For every preset in ``examples/scenarios/`` (the SLA-controlled and the
RM1 + RM2 fleet ones included), the port's ``ScenarioReport.to_dict()``
(stats, phases, audit trail, latency model; no scores) equals the
reference's field for field, nan-aware, and the port's clock sanitizer
(``REPRO_CLOCKSAN=1``) finds nothing.  The reports' score-parity
predicate ``bitwise_equal`` gives the reference's answer on the same
pairs of runs.  The preset library, its ``--write-presets`` files and
the lint CLI's ``--format json`` output are the reference's byte for
byte, and the serve CLI's cluster flags (``--elastic``,
``--sla-p99-ms``, ``--models``) give the reference's summary lines.
"""
import dataclasses
import functools
import io
import json
import math
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro.serving import scenario as jscenario
from repro.serving.scenario import ScenarioReport as JaxReport
from repro.serving.scenario import ScenarioSpec as JaxSpec
from repro.serving.scenario import run_scenario as jax_run_scenario
from repro_torch.analysis import clocksan
from repro_torch.launch import serve
from repro_torch.serving import scenario as tscenario
from repro_torch.serving.scenario import (ScenarioReport, ScenarioSpec,
                                          plan_workload, run_scenario)

PRESETS = Path(__file__).resolve().parents[1] / "examples" / "scenarios"
# the SLA-controlled presets' parity runs in test_torch_autoscaler.py:
# the reference takes about 20 s for each, and xdist's loadfile then
# runs them beside this file instead of after it
SLA_PRESETS = ["flash_crowd", "spike_plus_failure"]
PORTED = ["failover_storm", "diurnal_elastic", "skew_drift",
          "mixed_ddr_nmp", "pipeline_burst", "fleet_shift"] + SLA_PRESETS


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


def check_preset_report(name, monkeypatch):
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


@pytest.mark.parametrize("name", [n for n in PORTED
                                  if n not in SLA_PRESETS])
def test_preset_report_matches_reference(name, monkeypatch):
    check_preset_report(name, monkeypatch)


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
    # the elastic, SLA and fleet flags: the reference's summary lines
    # (the scored line's mean CTR differs: the weights come from torch's
    # generator, not JAX's)
    for flags in (["--elastic", "--cns", "3", "--mns", "6"],
                  ["--arrival", "poisson", "--sla-p99-ms", "1.5",
                   "--sla-mode", "decoupled", "--requests", "48"],
                  ["--models", "rm1,rm2", "--cache-mb", "0.02"]):
        argv = ["--cluster"] + flags
        assert serve.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.splitlines()
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert jserve.main(argv) == 0
        want = buf.getvalue().splitlines()
        assert got[0].rsplit(",", 1)[0] == want[0].rsplit(",", 1)[0]
        assert got[1:] == want[1:], flags
        assert any(w in " ".join(got) for w in
                   ("resizes=", "SLA feedback", "model rm2"))
    # the recurrent LM archs generate as the reference's CLI does: the
    # same line for the same two seeded prompts (the tokens differ: the
    # weights come from torch's generator, not JAX's)
    for arch in ("zamba2-7b", "rwkv6-3b"):
        argv = ["--arch", arch, "--decode-steps", "4"]
        assert serve.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.splitlines()
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert jserve.main(argv) == 0
        want = buf.getvalue().splitlines()
        assert len(got) == len(want) == 1, (got, want)
        head, toks = got[0].split(": ", 1)
        assert head == want[0].split(": ", 1)[0] == (
            "[serve] generated 4 tokens/seq for 2 sequences")
        toks = json.loads(toks)
        assert len(toks) == len(json.loads(want[0].split(": ", 1)[1])) == 4
        assert all(0 <= t < 256 for t in toks), toks     # reduced vocab


@pytest.mark.parametrize("name", sorted(tscenario.PRESETS))
def test_preset_matches_reference_and_example(name):
    got = tscenario.preset(name)
    assert got.to_dict() == jscenario.preset(name).to_dict()
    assert got.to_json() == jscenario.preset(name).to_json()
    assert got == ScenarioSpec.load(str(PRESETS / f"{name}.json"))
    assert sorted(tscenario.PRESETS) == sorted(jscenario.PRESETS)
    assert tscenario.smoke_topology() == tscenario.Topology()


def test_write_presets_byte_equal_to_reference(tmp_path, capsys):
    assert tscenario.main(["--write-presets", str(tmp_path / "port")]) == 0
    assert jscenario.main(["--write-presets", str(tmp_path / "ref")]) == 0
    port = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(port) == len(tscenario.PRESETS)
    for name in port:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
        assert ((tmp_path / "port" / name).read_bytes()
                == (PRESETS / name).read_bytes()), name


def test_lint_cli_matches_reference(tmp_path, capsys):
    """``--format json`` (a clean file, a broken one, a missing one) and
    the text lint are the reference's output; without ``--run`` the lint
    touches no device."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(
        json.loads((PRESETS / "fleet_shift.json").read_text()),
        events=[{"type": "fail_mn", "time_s": 0.01, "mn": 99}])))
    paths = [str(PRESETS / "failover_storm.json"), str(bad),
             str(tmp_path / "missing.json")]
    outs = []
    for mod in (tscenario, jscenario):
        rc = mod.main(["--format", "json"] + paths)
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == 1 and json.loads(outs[0][1])["files_checked"] == 3
    good = [str(PRESETS / f"{n}.json") for n in PORTED]
    assert tscenario.main(["--format", "json"] + good) == 0
    assert tscenario.main(good) == 0
    got = capsys.readouterr().out
    assert jscenario.main(["--format", "json"] + good) == 0
    assert jscenario.main(good) == 0
    assert got == capsys.readouterr().out


def test_report_fields_are_the_references():
    assert ([f.name for f in dataclasses.fields(ScenarioReport)]
            == [f.name for f in dataclasses.fields(JaxReport)])


@functools.lru_cache(maxsize=None)
def _parity_run(package: str, variant: str):
    """``failover_storm`` (two MN failures and recoveries) run by one
    package as it is ("failures"), without its events ("clean"), with
    the weights re-drawn from another seed mid-stream ("reload") and
    with fewer requests ("fewer")."""
    mod, spec_cls, kw = ((tscenario, ScenarioSpec, {"device": "cpu"})
                         if package == "port" else (jscenario, JaxSpec, {}))
    spec = spec_cls.load(str(PRESETS / "failover_storm.json"))
    if variant == "clean":
        spec = dataclasses.replace(spec, events=())
    elif variant == "reload":
        spec = dataclasses.replace(
            spec, events=(mod.ReloadParams(0.01, seed=9),))
    elif variant == "fewer":
        spec = dataclasses.replace(spec, workload=dataclasses.replace(
            spec.workload, requests=spec.workload.requests // 2))
    return mod.run_scenario(spec, **kw)


@pytest.mark.parametrize("a,b,equal", [
    ("failures", "clean", True),     # failures move time, never scores
    ("clean", "failures", True),
    ("reload", "clean", False),      # other weights, other scores
    ("clean", "fewer", False)])      # another total
def test_bitwise_equal_matches_reference(a, b, equal):
    got = _parity_run("port", a).bitwise_equal(_parity_run("port", b))
    want = _parity_run("reference", a).bitwise_equal(
        _parity_run("reference", b))
    assert got == want == equal

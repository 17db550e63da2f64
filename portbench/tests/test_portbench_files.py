"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import math
import re
from pathlib import Path

import pytest

from portbench import bench

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|mlp|expansion|experts_per)")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert 1 <= len(M["command"]) <= 32
    assert M["command"][1].startswith("portbench/")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_names_units_and_lines():
    entries = M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_workload_files_found_by_name(w):
    spec = bench.spec_of(w["name"])
    assert w["chips"] in (1, 4)
    assert spec["config"]["family"] == "dlrm"
    assert (ROOT / "portbench" / "families" /
            f"{spec['config']['family']}.py").exists()
    assert spec["cell"]["score_gap_limit"] > 0
    # every cell reports setup_s, another end-to-end metric, a layer metric
    e2e = {e["name"] for e in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]


def test_configs_keep_the_published_widths():
    from repro_torch.configs import rm2
    gens = {"rm2-v4": rm2.GENERATIONS[4].dlrm, "rm2-v5": rm2.GENERATIONS[5].dlrm}
    for c in M["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        src = gens[c["name"]]
        for k, v in vars(src).items():
            if k not in c["reduced"]:
                assert cfg[k] == (list(v) if isinstance(v, tuple) else v), k
        assert cfg["before_reduction"]["rows_per_table"] == src.rows_per_table
        for k in ("bottom_mlp", "top_mlp", "rows_per_table"):
            assert "not a published figure" in cfg["assumed"][k]


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert m["moves"] in {e["name"] for e in M["end_to_end"]}
    assert set(m["workloads"]) <= {w["name"] for w in M["workloads"]}
    assert callable(bench.reader(m["name"]).read)


def test_bounds():
    for e in M["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert not math.isnan(M["run_seconds"])

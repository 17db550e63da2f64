"""A run of the harness on the CPU, at REDUCED sizes, with the timed path
broken underneath: ``correct`` has to come out false for each fault, and
true without one."""
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench
from repro_torch.serving.cluster import ClusterEngine
from _portbench_cases import tiny_spec

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4099


def _run(trace=False, workload="rm2v5_mixed_b128"):
    return bench.run_cell(tiny_spec(workload), SEED, 0.3, trace, "cpu")


def _score_altered(monkeypatch):
    orig = ClusterEngine._execute

    def execute(self, *a, **k):
        scores, mem, gat = orig(self, *a, **k)
        scores = scores.copy()
        scores[0] += 1e-3
        return scores, mem, gat
    monkeypatch.setattr(ClusterEngine, "_execute", execute)


def _bag_altered(monkeypatch):
    orig = ClusterEngine._mn_pool

    def mn_pool(self, j, tids, idx_sub):
        out = orig(self, j, tids, idx_sub).clone()
        out[:, 0, :] = 0.0            # the first table's pooled vectors
        return out
    monkeypatch.setattr(ClusterEngine, "_mn_pool", mn_pool)


def _answer_dropped(monkeypatch):
    orig = ClusterEngine.serve

    def serve(self, requests, *a, **k):
        results, stats = orig(self, requests, *a, **k)
        return results[:-1], stats
    monkeypatch.setattr(ClusterEngine, "serve", serve)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    out = _run(trace)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["score_gap"]["value"] <= (
        out["checks"]["score_gap"]["limit"])


def test_readers_see_the_programs_stats(monkeypatch):
    """A traced run hands the readers each window serve call's
    ClusterStats and the device entry, and times the port's imports as
    a set-up phase of their own."""
    seen = []
    real = bench.reader

    def reader(name):
        mod = real(name)
        if not seen:
            seen.append(None)

            class Capture:
                @staticmethod
                def read(ctx):
                    seen[0] = ctx
                    return mod.read(ctx)
            return Capture
        return mod
    monkeypatch.setattr(bench, "reader", reader)
    out = _run(trace=True)
    ctx = seen[0]
    assert out["correct"] and ctx.stats
    assert sum(s.completed for s in ctx.stats) == out["attempted"]
    assert ctx.device["platform"] == "cpu"
    assert ctx.device["memory_peak_bytes"] == (
        out["device"]["memory_peak_bytes"])
    phases = out["window"]["setup_phases_s"]
    assert list(phases)[:3] == ["start_and_torch_import", "cuda_init",
                                "program_imports"]


@pytest.mark.parametrize("fault", [_score_altered, _bag_altered,
                                   _answer_dropped])
@pytest.mark.parametrize("workload", ["rm2v5_mixed_b128", "rm2v4_ddr_b128"])
def test_fault_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    out = _run(workload=workload)
    assert not out["correct"]


def test_entry_point_refuses_without_a_card(tmp_path):
    """No CUDA card here: a non-zero exit and no result on stdout, also
    from a copy that holds only BENCHMARK.json and the harness."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "rm2v5_mixed_b128", "--seed", "1", "--seconds", "1"],
            cwd=root, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""

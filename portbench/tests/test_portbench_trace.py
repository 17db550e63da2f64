"""The trace reader and the per-layer metric readers on a made-up trace."""
import json

import pytest

from portbench import bench, counts, devtrace
from _portbench_cases import REDUCED


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def trace(tmp_path):
    events = [
        _ev("user_annotation", "portbench.window", 0, 1000),
        _ev("user_annotation", "portbench.serve", 0, 1000),
        _ev("user_annotation", "portbench.execute", 100, 800),
        _ev("user_annotation", "portbench.dense_forward", 500, 100),
        _ev("cuda_runtime", "cudaMemcpyAsync", 110, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 5, corr=3),
        _ev("cuda_driver", "cuLaunchKernelEx", 520, 5, corr=4),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 120, 30, corr=1),
        _ev("kernel", "void (anonymous namespace)::fused_flat_kernel<float, true>",
            210, 40, corr=2),
        _ev("kernel", "sgemm", 600, 200, corr=3),
        _ev("kernel", "sgemm", 790, 100, corr=4),      # overlaps the first
        _ev("kernel", "late", 990, 50, corr=99),        # clipped at 1000
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return devtrace.load(str(p))


def test_busy_union_and_clipping(trace):
    assert trace.window_s == pytest.approx(1e-3)
    # 120-150, 210-250, 600-890, 990-1000
    assert trace.busy_s() == pytest.approx((30 + 40 + 290 + 10) * 1e-6)
    assert trace.device_s(lambda n: "HtoD" in n) == pytest.approx(30e-6)


def test_launched_in_span(trace):
    assert trace.launched_in_s("portbench.dense_forward") == pytest.approx(
        300e-6)
    assert trace.launched_in_s("portbench.execute") == pytest.approx(370e-6)


def test_idle_gaps_by_innermost_span(trace):
    gaps = trace.idle_gaps()
    # gaps 0-120 and 890-990 (serve), 150-210 and 250-600 (execute)
    assert gaps["portbench.serve"] == pytest.approx(220e-6)
    assert gaps["portbench.execute"] == pytest.approx(410e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - trace.busy_s())


def test_readers(trace):
    cfg = dict(REDUCED)
    counters = {"batches": 2, "batch_size": 4, "samples": 8,
                "execute_s": [0.2, 0.3], "window_s": 1.0, "dense_calls": 2,
                "bag": {"ddr": {"calls": 2, "tables": 8, "bags": 32,
                                "index_slots": 320, "valid": 200}}}
    peak = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e11}
    ctx = bench.Readings(counters, trace, cfg, peak)
    read = {n: bench.reader(n).read(ctx) for n in (
        "dispatch_ms_per_batch", "batch_fill", "execute_p95_ms",
        "h2d_ms_per_batch", "bag_fused_roofline", "bag_nmp_roofline",
        "dense_roofline", "step_mfu", "device_idle")}
    assert read["dispatch_ms_per_batch"] == pytest.approx(250.0)
    assert read["batch_fill"] == pytest.approx(100.0)
    assert read["h2d_ms_per_batch"] == pytest.approx(15e-3)
    assert read["bag_nmp_roofline"] is None           # no NMP launch
    b = counts.bag_bytes(200, 320, 32, 8, cfg["embed_dim"])
    assert read["bag_fused_roofline"] == pytest.approx(100 * b / 1e11 / 40e-6)
    flops = 2 * 4 * counts.tower_flops_per_sample(cfg)
    nbytes = 2 * counts.tower_bytes(cfg, 4)
    assert read["dense_roofline"] == pytest.approx(
        100 * max(flops / 1e12, nbytes / 1e11) / 300e-6)
    assert read["step_mfu"] == pytest.approx(
        100 * 8 * counts.tower_flops_per_sample(cfg) / 1e-3 / 1e12)
    assert read["device_idle"] == pytest.approx(100 * (1 - 370e-6 / 1e-3))


def test_readers_without_a_trace_or_peak():
    counters = {"batches": 0, "batch_size": 4, "samples": 0, "execute_s": [],
                "window_s": 1.0, "dense_calls": 0, "bag": {}}
    ctx = bench.Readings(counters, None, dict(REDUCED), None)
    for e in bench.manifest()["per_layer"]:
        assert bench.reader(e["name"]).read(ctx) is None, e["name"]

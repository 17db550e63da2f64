"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); ``cells/<cell>.json`` holds the cell's
engine settings and its limits; the configuration's ``family`` names
the module that drives it (``families/<family>.py``); each per-layer
metric is read by ``metrics/<metric>.py``.  A later cell, mix or metric
is added as files and entries.

The window serves successive chunks of requests, each one call of the
program's serve entry, and ends with the last chunk that started
before ``seconds`` had passed.  ``samples_per_s`` is every sample
scored in the window over the window's wall time; ``setup_s`` runs
from the process's start to the window's.  With ``trace`` the window
runs under ``torch.profiler`` (no shapes, no stacks) and the line holds
the per-layer metrics instead.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import devtrace, peaks

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
TOP = 10


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(MANIFEST)


def spec_of(workload: str) -> dict:
    """The cell's entry, configuration, engine settings and mix."""
    m = manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    w = cells[workload]
    return {"name": workload, "chips": w["chips"],
            "config": _json(HERE / "configs" / f"{w['config']}.json"),
            "cell": _json(HERE / "cells" / f"{workload}.json"),
            "mix": _json(HERE / "traffic" / f"{w['traffic']}.json"),
            "end_to_end": [e for e in m["end_to_end"]
                           if workload in e.get("workloads", [workload])],
            "per_layer": [e for e in m["per_layer"]
                          if workload in e.get("workloads", [workload])]}


def reader(metric: str):
    """``metrics/<metric>.py``, loaded by its path (a metric's name may
    hold characters that a module name may not)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Readings:
    """What a per-layer metric's reader may read: the harness's counters
    of the traced window, its trace, the configuration, the card's peaks,
    the program's own statistics of each of the window's serve calls (a
    ``ClusterStats`` each, for the DLRM cells) and the run's ``device``
    entry (name, count, ``memory_peak_bytes``)."""
    counters: dict
    trace: Optional[devtrace.Trace]
    cfg: dict
    peak: Optional[Dict[str, float]]
    stats: List = field(default_factory=list)
    device: dict = field(default_factory=dict)


def serve_window(session, seconds: float, traced: bool):
    """Serve chunks until ``seconds`` have passed: the window's start,
    each chunk's end (host clock), and the requests and samples sent."""
    rf = (torch.profiler.record_function if traced
          else lambda name: contextlib.nullcontext())
    requests = samples = i = 0
    ends = []
    t0 = time.perf_counter()
    with rf(devtrace.WINDOW):
        while i == 0 or ends[-1] - t0 < seconds:
            with rf("portbench.serve"):
                r, s = session.serve(i)
            ends.append(time.perf_counter())
            requests += r
            samples += s
            i += 1
    return t0, ends, requests, samples


def _profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _read_trace(prof) -> devtrace.Trace:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return devtrace.load(path)
    finally:
        os.unlink(path)


def _device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _top(d: Dict[str, float]) -> List:
    return [[k[:64], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None) -> dict:
    """One run of the cell ``spec`` (``spec_of``): the result's line as
    a dict, with ``checks`` last, and the window's own counts under
    ``window`` (the entry point prints them on a line of their own)."""
    if t_start is None:
        t_start = time.perf_counter()
    device = torch.device(device)
    cfg, cell = spec["config"], spec["cell"]
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    t_import = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)     # starts CUDA
    t_cuda = time.perf_counter()
    session = family.Session(spec["name"], cfg, cell, spec["mix"], seed,
                             device, trace=trace)
    phases = {"start_and_torch_import": t_import - t_start,
              "cuda_init": t_cuda - t_import, **session.setup_phases}
    prof = _profile(device) if trace else contextlib.nullcontext()
    with prof:
        t0, ends, requests, samples = serve_window(session, seconds, trace)
    t1 = ends[-1]
    setup_s, rate = t0 - t_start, samples / (t1 - t0)
    info = _device_info(device)
    counters = session.counters() if trace else None
    tr = _read_trace(prof) if trace else None
    session.free_program()
    chk = session.check()
    gap, limit = chk["gap"], cell["score_gap_limit"]
    correct = (chk["failed"] == 0 and chk["attempted"] == requests > 0
               and chk["compared"] > 0 and gap <= limit)
    metrics = {}
    if not trace:
        values = {"samples_per_s": rate, "setup_s": setup_s}
        for e in spec["end_to_end"]:
            metrics[e["name"]] = {"value": values[e["name"]], "unit": e["unit"]}
    else:
        counters["window_s"] = t1 - t0
        ctx = Readings(counters, tr, cfg, peaks.for_device(info["kind"]),
                       list(session.stats), dict(info))
        for e in spec["per_layer"]:
            v = reader(e["name"]).read(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
    out = {"correct": bool(correct), "attempted": requests,
           "failed": chk["failed"], "metrics": metrics, "device": info}
    if trace:
        out["breakdown"] = {"device_ops": _top(tr.top_ops()),
                            "idle_gaps": _top(tr.idle_gaps())}
    out["window"] = {"seconds": t1 - t0, "requests": requests,
                     "samples": samples, "samples_per_s": rate,
                     "compared_samples": chk["compared_samples"],
                     "reference_s": chk.get("reference_s"),
                     "setup_phases_s": phases,
                     "chunk_s": [b - a for a, b in zip([t0] + ends, ends)]}
    out["checks"] = {
        "failed_requests": {"value": chk["failed"], "limit": 0},
        "score_gap": {"value": gap if math.isfinite(gap) else None,
                      "limit": limit}}
    return out

"""Reading a ``torch.profiler`` chrome trace of the measured window.

The harness exports the traced run's trace to a temporary file and
reads it here: the window (the ``portbench.window`` span), the device's
operations (kernels, copies, sets) with their correlation ids, the host
launches those ids point to, and the harness's spans (user annotations
named ``portbench.*``).  Times in the trace are microseconds on one
clock for host and device; everything returned here is in seconds.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    t0: float                                   # window, microseconds
    t1: float
    ops: List[Tuple[str, float, float, int]]    # name, start, end, corr
    launches: Dict[int, float] = field(default_factory=dict)
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)

    def __post_init__(self):
        self._starts = {n: [s for s, _ in iv] for n, iv in self.spans.items()}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clip(self, s: float, e: float) -> float:
        return max(0.0, min(e, self.t1) - max(s, self.t0))

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's operations inside the window."""
        out: List[Tuple[float, float]] = []
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``match``es."""
        return 1e-6 * sum(self._clip(s, e) for n, s, e, _ in self.ops
                          if match(n))

    def launched_in_s(self, span: str) -> float:
        """Device seconds of the operations launched from the host while
        a span of that name was open."""
        iv, starts = self.spans.get(span, []), self._starts.get(span, [])
        total = 0.0
        for _, s, e, corr in self.ops:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += self._clip(s, e)
        return total * 1e-6

    def span_at(self, t: float) -> str:
        """The innermost harness span open on the host at time ``t``."""
        best, best_len = "host, outside the spans", float("inf")
        for name, iv in self.spans.items():
            i = bisect.bisect_right(self._starts[name], t) - 1
            if i >= 0 and t <= iv[i][1] and iv[i][1] - iv[i][0] < best_len:
                best, best_len = name, iv[i][1] - iv[i][0]
        return best

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of the window with nothing on the device, by the
        innermost span that the host was in at the middle of each gap."""
        out: Dict[str, float] = defaultdict(float)
        edge = self.t0
        for s, e in self.busy() + [(self.t1, self.t1)]:
            if s > edge:
                out[self.span_at(0.5 * (edge + s))] += (s - edge) * 1e-6
            edge = max(edge, e)
        return dict(out)

    def top_ops(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e, _ in self.ops:
            out[n] += self._clip(s, e) * 1e-6
        return dict(out)


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    window = None
    ops, launches, spans = [], {}, defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((name, ts, ts + dur, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation" and name.startswith("portbench."):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans[name].append((ts, ts + dur))
    if window is None:
        raise ValueError(f"{path}: no {WINDOW} span in the trace")
    for iv in spans.values():
        iv.sort()
    return Trace(window[0], window[1], ops, launches, dict(spans))

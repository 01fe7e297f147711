"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activities) over a steady slice of the window, exported as a Chrome
trace into a temporary directory under ``TMPDIR`` and reduced to:

- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the slice; ``window_s``: the slice's length;
- ``kernel_s``: device seconds summed by kernel name;
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: the ten longest gaps between device intervals, each
  named by the benchmark span (a ``record_function`` range) and the
  innermost host operation that the host was in when the gap began.
"""

from __future__ import annotations

import json
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    requests: int
    kernel_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, substrings) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of
        ``substrings``; None where none ran."""
        hits = [s for n, s in self.kernel_s.items()
                if any(k in n for k in substrings)]
        return sum(hits) if hits else None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(trace: dict, t_lo: float, t_hi: float, span_names,
              requests: int) -> TraceSummary:
    """Reduce a Chrome trace (``traceEvents``, times in microseconds) over
    [t_lo, t_hi] microseconds of its clock."""
    dev, host_ops, spans = [], [], []
    kernel_s: Dict[str, float] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        a, b = max(ts, t_lo), min(ts + dur, t_hi)
        if cat in DEVICE_CATS:
            if b > a:
                dev.append((a, b))
                kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) \
                    + (b - a) * 1e-6
        elif cat == "user_annotation" and e["name"] in span_names:
            spans.append((ts, ts + dur, e["name"]))
        elif cat in ("cpu_op", "cuda_runtime"):
            host_ops.append((ts, ts + dur, e["name"]))
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [t_lo] + [x for ab in merged for x in ab] + [t_hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]

    def where(t):
        s = [x for x in spans if x[0] <= t < x[1]]
        span = min(s, key=lambda x: x[1] - x[0])[2] if s else "between"
        ops = [x for x in host_ops if x[0] <= t < x[1]]
        op = min(ops, key=lambda x: x[1] - x[0])[2] if ops else ""
        return f"{span}/{op}"[:64] if op else span

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = [(where(a), (b - a) * 1e-6) for a, b in gaps[:10]]
    top = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return TraceSummary(window_s=(t_hi - t_lo) * 1e-6, busy_s=busy,
                        requests=requests, kernel_s=kernel_s,
                        device_ops=top, idle_gaps=idle)


class DeviceTrace:
    """Profile requests ``first`` .. ``first + count - 1`` of a window:
    call :meth:`before` and :meth:`after` around every request."""

    def __init__(self, first: int, count: int, span_names, log=print):
        self.first, self.count = first, count
        self.span_names = set(span_names)
        self.log = log
        self.prof = None
        self.summary: Optional[TraceSummary] = None
        self._t = None

    @staticmethod
    def warm(device) -> None:
        """Start the profiler's CUDA tracing once, in set-up: its first
        use pays the tracer's initialisation."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        if device.type != "cuda":
            return
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1024, device=device).add_(1.0)
            torch.cuda.synchronize(device)

    @property
    def done(self) -> bool:
        return self.summary is not None

    def close(self) -> None:
        """End a slice the window cut short (no summary then)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def before(self, i: int) -> None:
        if i == self.first and self.summary is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._t = [time.perf_counter(), None]
            self._marker("benchmark_trace_open")

    def after(self, i: int) -> None:
        if self.prof is not None and i == self.first + self.count - 1:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._marker("benchmark_trace_close")
            self.prof.__exit__(None, None, None)
            self._t[1] = time.perf_counter()
            self._reduce()
            self.prof = None

    def _marker(self, name):
        import torch

        with torch.profiler.record_function(name):
            pass

    def _reduce(self) -> None:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            with open(path) as fh:
                trace = json.load(fh)
        marks = {e["name"]: float(e["ts"]) for e in trace["traceEvents"]
                 if e.get("name") in ("benchmark_trace_open",
                                      "benchmark_trace_close")}
        self.summary = summarize(trace, marks["benchmark_trace_open"],
                                 marks["benchmark_trace_close"],
                                 self.span_names, self.count)
        self.log(f"trace: {self.count} requests, window "
                 f"{self.summary.window_s!r} s, busy {self.summary.busy_s!r}"
                 f" s (host clock {self._t[1] - self._t[0]!r} s); reduced "
                 f"in {time.perf_counter() - t0:.1f} s")

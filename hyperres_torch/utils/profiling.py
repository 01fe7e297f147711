# Port-owned copy of hyperres/utils/profiling.py: ``StageTimer`` verbatim;
# ``profile_trace`` on torch.profiler instead of jax.profiler; the spans
# are the port's own.
"""Tracing / profiling utilities.

The reference's only observability is print breadcrumbs + tqdm
(SURVEY.md section 5); here every pipeline records a structured
stage-timing ledger, and these helpers add (a) a reusable timer, (b) a
torch.profiler trace context for host and CUDA timeline capture
(enable with HYPERRES_PROFILE_DIR=/path or the context manager) and
(c) the program's spans and counters.

Spans: ``with span("fused.warp", device):`` marks one stage of one
call. A span is on only while a ``torch.profiler`` records (the
profiler's own module flag) or inside :func:`tracing`; off, it costs one
flag test and makes no torch or CUDA call. On, it is a
``record_function`` range of the same name (so it lands in the device
trace, nested under the caller's ranges), and it records its host
``perf_counter`` start and end, its parent, the id of its root span
(``trace_id``: every span of one call shares it), the counts that
:func:`count` adds while it is the innermost open span, and, where its
device is a CUDA device, a pair of CUDA events on that device's current
stream. :func:`records` returns the finished spans, resolving the events
with one synchronise; :func:`clear` drops them. The Chrome trace of
:func:`profile_trace` is the export: there is no other.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class StageTimer:
    """Accumulates named stage wall-clock timings into a dict ledger."""

    def __init__(self, ledger: Optional[Dict] = None):
        self.ledger = ledger if ledger is not None else {}

    @contextlib.contextmanager
    def stage(self, name: str, **extra):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = {"seconds": round(time.perf_counter() - t0, 6)}
            rec.update(extra)
            self.ledger[name] = rec


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """torch.profiler trace context; no-op unless a directory is given
    or HYPERRES_PROFILE_DIR is set. With one, it drops the span records
    (:func:`clear`), records the host and, where a CUDA device is
    present, the device, and on exit writes a Chrome trace,
    ``trace_<pid>_<ns>.json``, into the directory; the program's spans
    are its ``user_annotation`` ranges."""
    log_dir = log_dir or os.environ.get("HYPERRES_PROFILE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    clear()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class SpanRecord:
    """One finished span: ``span_id``, the enclosing span's
    ``parent_id`` (None for a root), the root's id ``trace_id``, host
    ``perf_counter`` seconds ``start_s`` / ``end_s``, the ``counts``
    added inside it, and ``device_ms`` between its CUDA events (None
    without a CUDA device, or until :func:`records` resolves it)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    start_s: float = 0.0
    end_s: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.end_s - self.start_s)

    @property
    def ms(self) -> float:
        """Device milliseconds where the span had CUDA events, else host
        milliseconds."""
        return self.host_ms if self.device_ms is None else self.device_ms


_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_open = threading.local()      # .stack: this thread's open spans
_records: List[SpanRecord] = []
_pending: List[tuple] = []     # (record, start event, end event, device)
_tracing = 0


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "rec", "range", "events")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        parent = stack[-1].rec if stack else None
        sid = next(_ids)
        self.rec = SpanRecord(self.name, sid,
                              None if parent is None else parent.span_id,
                              sid if parent is None else parent.trace_id)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.events = None
        if self.device is not None and \
                torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        stack.append(self)
        self.rec.start_s = time.perf_counter()
        return self.rec

    def __exit__(self, *exc) -> bool:
        self.rec.end_s = time.perf_counter()
        if self.events is not None:
            self.events[1].record(self.events[2])
        _stack().pop()
        try:
            self.range.__exit__(*exc)
        finally:
            _records.append(self.rec)
            if self.events is not None:
                _pending.append((self.rec, self.events[0], self.events[1],
                                 self.events[2].device))
        return False


def span(name: str, device=None):
    """A context manager that marks one stage of one call (module
    docstring). ``device``: the device the stage runs on; a CUDA one
    gets CUDA events (None: the host clock alone). Off, it is a shared
    no-op context."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[name]`` of this thread's innermost open
    span; nothing where no span is open (spans off included)."""
    stack = getattr(_open, "stack", None)
    if stack:
        counts = stack[-1].rec.counts
        counts[name] = counts.get(name, 0) + int(n)


@contextlib.contextmanager
def tracing():
    """Spans on inside the block, with no profiler recording."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


def records() -> List[SpanRecord]:
    """The finished spans, oldest first. CUDA events not yet read are
    resolved first, after one synchronise of each of their devices."""
    if _pending:
        for dev in {p[3] for p in _pending}:
            torch.cuda.synchronize(dev)
        for rec, start, end, _ in _pending:
            rec.device_ms = start.elapsed_time(end)
        _pending.clear()
    return list(_records)


def clear() -> None:
    """Drop the finished spans."""
    _records.clear()
    _pending.clear()


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op off CUDA)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_call(fn, device):
    """``(fn(), seconds)``: on a CUDA device, CUDA events around the call
    on the current stream, then a synchronise; elsewhere the host clock
    around the call."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / 1000.0


def card_info(device) -> Dict[str, object]:
    """``{"device": name, "power_limit_w": W}`` for the record of a
    timed run: the CUDA device's name and its power limit from
    ``nvidia-smi`` (None where that cannot be read); ``"cpu"`` and None
    off CUDA."""
    import subprocess

    device = torch.device(device)
    if device.type != "cuda":
        return {"device": device.type, "power_limit_w": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
        watts = float(r.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        watts = None
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": watts}

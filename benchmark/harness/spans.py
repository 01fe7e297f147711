"""Spans of the benchmark's own code, around its calls into each layer
of the program: name, request, host-clock start and end. In a traced run
each span is also a ``torch.profiler`` range of the same name, so the
device trace can say what the host was doing in an idle gap, and the
spans that name a device stage also get a pair of CUDA events, resolved
after the window (device milliseconds per call)."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import List, Optional


class Spans:
    def __init__(self, traced: bool = False, device=None):
        self.traced = traced
        self.device = device
        self.records: List[tuple] = []
        self._events: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str, request: int, device_events: bool = False):
        """Record ``name`` for ``request``. The body ends its device work
        with a synchronise where the span is a host-clock span of device
        work (the system adapter does that, not this)."""
        ev = None
        rf = contextlib.nullcontext()
        if self.traced:
            import torch

            rf = torch.profiler.record_function(name)
            if device_events and self.device is not None \
                    and self.device.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with rf:
            t0 = time.perf_counter()
            if ev is not None:
                ev[0].record()
            try:
                yield
            finally:
                if ev is not None:
                    ev[1].record()
                    self._events.append((name, request, ev))
                self.records.append((name, request, t0, time.perf_counter()))

    def seconds(self, name: str) -> List[float]:
        return [t1 - t0 for n, _, t0, t1 in self.records if n == name]

    def device_ms(self, name: str) -> List[float]:
        """CUDA-event milliseconds of each traced call of ``name``."""
        if self._events:
            import torch

            torch.cuda.synchronize(self.device)
        return [ev[0].elapsed_time(ev[1]) for n, _, ev in self._events
                if n == name]

    def median_device_ms(self, name: str) -> Optional[float]:
        ms = self.device_ms(name)
        return statistics.median(ms) if ms else None

    def mean_seconds(self, name: str) -> Optional[float]:
        s = self.seconds(name)
        return sum(s) / len(s) if s else None

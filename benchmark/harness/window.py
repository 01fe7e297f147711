"""The measured window of a closed loop with one caller.

The caller sends request i + 1 as soon as request i is complete (its
product on the device, or in host memory, after a synchronise). The
window opens when request 0 is sent and closes at the completion of the
first request that ends ``seconds`` or more after the opening, so no
request is cut at the edge and none is lost: every request in the window
counts whole, and the window's time is all the time from its opening to
its last completion.

- Time per request: the window's length over the requests completed in
  it (every request is; a failed one counts as attempted and not as
  completed).
- Latency of request i: from the moment it was due (the completion of
  request i - 1, the opening for request 0) to its completion. The
  latencies add up to the window, so a stall anywhere, between requests
  too, lands in one of them.
- p95: the nearest-rank 95th percentile of those latencies.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Window:
    opened: float
    completions: List[float] = field(default_factory=list)
    failed: int = 0

    @property
    def attempted(self) -> int:
        return len(self.completions)

    @property
    def completed(self) -> int:
        return self.attempted - self.failed

    @property
    def length(self) -> float:
        return self.completions[-1] - self.opened

    def latencies(self) -> List[float]:
        due = [self.opened] + self.completions[:-1]
        return [c - d for c, d in zip(self.completions, due)]

    def time_per_request(self) -> float:
        """The window's length over its completed requests (inf if none
        completed)."""
        return self.length / self.completed if self.completed else math.inf

    def p95(self) -> float:
        return nearest_rank(self.latencies(), 95.0)


def nearest_rank(values: List[float], q: float) -> float:
    """The smallest value with at least q % of the values at or below
    it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def closed_loop(request: Callable[[int], None], seconds: float,
                clock: Callable[[], float] = time.perf_counter,
                on_error: Callable[[int, BaseException], None] = None,
                until: Callable[[], bool] = lambda: True) -> Window:
    """Run ``request(i)`` for i = 0, 1, ... until a completion lands
    ``seconds`` or more after the window opened and ``until()`` holds (a
    traced run's slice is complete). ``request`` returns once its product
    is complete. A request that raises ``Exception`` counts as failed
    (``on_error`` sees it) and the loop goes on."""
    win = Window(opened=clock())
    i = 0
    while True:
        try:
            request(i)
        except Exception as exc:  # a failed request is counted, not fatal
            win.failed += 1
            if on_error is not None:
                on_error(i, exc)
        win.completions.append(clock())
        i += 1
        if win.completions[-1] - win.opened >= seconds and until():
            return win

"""The program's own spans and counters (``hyperres_torch.utils.profiling``
``records()``), as the per-layer readers see them.

The program opens its spans only while a ``torch.profiler`` records, so
a traced run holds those of its traced slice. A run keeps the records
that began in its window (earlier runs of the same process are left
out) and groups them by trace id: one root span, one call. A span's
milliseconds are those of its CUDA events, or of the host clock where
it had none (a CPU run). A program without span records (one older
than them) gives no records, so every reader returns None.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional


def program_records() -> list:
    """Every finished span record of the program; [] where it has none."""
    try:
        from hyperres_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "records", None)
    return list(read()) if read is not None else []


def calls(ctx, root: str) -> List[list]:
    """The records of each call of ``root`` in the run's window, in the
    order the calls began."""
    by_trace: Dict[int, list] = defaultdict(list)
    for r in program_records():
        if r.start_s >= ctx.window.opened:
            by_trace[r.trace_id].append(r)
    out = []
    for recs in by_trace.values():
        top = [r for r in recs if r.parent_id is None]
        if len(top) == 1 and top[0].name == root:
            out.append(recs)
    return sorted(out, key=lambda recs: min(r.start_s for r in recs))


def stage_ms(recs, name: str) -> Optional[float]:
    """Milliseconds of the spans ``name`` of one call, summed; None where
    the call has none."""
    ms = [r.ms for r in recs if r.name == name]
    return sum(ms) if ms else None


def self_ms(recs) -> float:
    """The root's milliseconds less those of its direct children."""
    root = next(r for r in recs if r.parent_id is None)
    return root.ms - sum(r.ms for r in recs if r.parent_id == root.span_id)


def median_stage_ms(ctx, root: str, name: str) -> Optional[float]:
    """Median over the window's calls of ``root`` of the ms of ``name``."""
    ms = [v for v in (stage_ms(c, name) for c in calls(ctx, root))
          if v is not None]
    return statistics.median(ms) if ms else None


def median_self_ms(ctx, root: str) -> Optional[float]:
    ms = [self_ms(c) for c in calls(ctx, root)]
    return statistics.median(ms) if ms else None


def mean_count(ctx, root: str, counter: str) -> Optional[float]:
    """Mean over the window's calls of ``root`` of ``counter``, summed
    over each call's spans."""
    per_call = [sum(r.counts.get(counter, 0) for r in c)
                for c in calls(ctx, root)]
    return sum(per_call) / len(per_call) if per_call else None

# Port-owned copy of hyperres/utils/profiling.py: ``StageTimer`` verbatim;
# ``profile_trace`` on torch.profiler instead of jax.profiler.
"""Tracing / profiling utilities.

The reference's only observability is print breadcrumbs + tqdm
(SURVEY.md section 5); here every pipeline records a structured
stage-timing ledger, and these helpers add (a) a reusable timer and
(b) a torch.profiler trace context for host and CUDA timeline capture
(enable with HYPERRES_PROFILE_DIR=/path or the context manager).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Optional


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
    or HYPERRES_PROFILE_DIR is set. With one, it records the host and,
    where a CUDA device is present, the device, and on exit writes a
    Chrome trace, ``trace_<pid>_<ns>.json``, into the directory."""
    log_dir = log_dir or os.environ.get("HYPERRES_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))

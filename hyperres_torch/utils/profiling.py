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


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op off CUDA)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_call(fn, device):
    """``(fn(), seconds)``: on a CUDA device, CUDA events around the call
    on the current stream, then a synchronise; elsewhere the host clock
    around the call."""
    import torch

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

    import torch

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

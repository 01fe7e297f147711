"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, and the result's last line."""

from __future__ import annotations

import json
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .compare import Check, checks
from .devtrace import DeviceTrace
from .manifest import Manifest
from .spans import Spans
from .window import Window, closed_loop

FORBIDDEN = ("jax", "jaxlib", "flax", "hyperres")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def split(log_fn, what: str, t0: float) -> float:
    """Log the seconds of one part of set-up since ``t0``; returns now."""
    t = time.perf_counter()
    log_fn(f"setup split: {what} {t - t0:.3f} s")
    return t


def kernel_builds() -> Dict[str, float]:
    """Seconds each of the program's CUDA libraries took to build in
    this process (0 where an earlier run's build was loaded)."""
    mod = sys.modules.get("hyperres_torch.kernels._build")
    if mod is None:
        return {}
    return {k: round(v["seconds"], 3) for k, v in mod.build_info.items()}


@dataclass
class Context:
    """What a per-layer metric's reader may read."""

    cell: dict
    config: dict
    traffic: dict
    window: Window
    spans: Spans
    trace: Optional[object]
    shapes: Dict[str, object]
    power_limit_w: Optional[float]
    log: Callable[[str], None] = log


def end_to_end(stat: str, win: Window, work: float) -> float:
    """A window statistic by the name the traffic mix gives it."""
    if stat == "time_per_request":
        return win.time_per_request()
    if stat == "p95_latency":
        return win.p95()
    if stat == "work_rate":
        return work / win.time_per_request()
    raise ValueError(f"unknown end-to-end statistic {stat!r}")


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             trace: bool, device, setup_clock: Callable[[], float],
             system_factory=None, card: Optional[dict] = None,
             power_limit: Callable[[], Optional[float]] = lambda: None
             ) -> dict:
    """The result object of one run (see the module docstring).
    ``setup_clock()`` gives the seconds since the process started;
    ``system_factory`` replaces the configuration's adapter (tests);
    ``power_limit()`` reads the card's power limit, after the window."""
    import torch

    cell = manifest.cell(name)
    config = manifest.config(cell)
    traffic = manifest.traffic(cell)
    traced = bool(trace)
    spans = Spans(traced=traced, device=device)
    factory = system_factory or manifest.system(config, traffic).System
    system = factory(config, traffic, seed, device, log, spans)
    log(f"setup split: process start to set-up {setup_clock():.3f} s "
        f"(interpreter, imports, CUDA start)")
    system.setup()
    if traced:
        t = time.perf_counter()
        DeviceTrace.warm(device)
        split(log, "profiler start", t)
    log(f"setup split: kernel builds {kernel_builds()}")
    spans.records.clear()
    spans._events.clear()
    setup_s = setup_clock()
    log(f"setup_s {setup_s!r}")

    dt = None
    if traced:
        tr = traffic["trace"]
        dt = DeviceTrace(tr["first"], tr["requests"], system.span_names, log)

    def one(i: int) -> None:
        if dt is not None:
            dt.before(i)
        system.request(i)
        if dt is not None:
            dt.after(i)

    errors: List[str] = []

    def on_error(i, exc):
        if len(errors) < 3:
            errors.append(f"request {i}: {traceback.format_exc()}")
            log(errors[-1])

    try:
        win = closed_loop(one, seconds, on_error=on_error,
                          until=(lambda: dt.done) if dt else (lambda: True))
    finally:
        if dt is not None:
            dt.close()
    lat = sorted(win.latencies())
    log(f"window {win.length!r} s, {win.attempted} requests, "
        f"{win.failed} failed; latency min {lat[0]!r} median "
        f"{lat[len(lat) // 2]!r} max {lat[-1]!r} s")

    watts = power_limit()
    log(f"power.limit {watts} W")
    cuda = device.type == "cuda"
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": (card or {}).get("kind"),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                if cuda else 0}
    units = {m["name"]: m["unit"] for m in
             manifest.data["end_to_end"] + manifest.data["per_layer"]}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if not traced:
        stats = traffic["end_to_end"]
        for m in manifest.end_to_end(cell):
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = end_to_end(stats[m["name"]], win,
                               system.work_per_request())
            metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        summary = dt.summary
        if summary is not None:
            dev_info["busy_s"] = summary.busy_s
            dev_info["window_s"] = summary.window_s
            breakdown = {"device_ops": [list(x) for x in summary.device_ops],
                         "idle_gaps": [list(x) for x in summary.idle_gaps]}
        ctx = Context(cell, config, traffic, win, spans, summary,
                      system.shapes(), watts)
        for m in manifest.per_layer(cell):
            v = manifest.reader(m).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}

    system.release()
    t0 = time.perf_counter()
    readings = system.readings()
    limits = config["correct"]["limits"]
    found_checks: List[Check] = checks(readings, limits)
    log(f"reference and comparison: {time.perf_counter() - t0:.1f} s")
    # last, after the readers and the reference: whatever any step of the
    # run loaded, directly or through the program, is in sys.modules now
    found = forbidden_modules()
    if found:
        log(f"FATAL: modules of JAX or the JAX package are loaded: {found}")
        raise SystemExit(5)
    correct = (win.failed == 0 and win.attempted > 0 and found_checks != []
               and all(c.ok for c in found_checks))
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in found_checks}
    for c in found_checks:
        log(f"compared {c.name} {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAIL'}")
    return result


def print_result(result: dict) -> None:
    print(json.dumps(result), flush=True)

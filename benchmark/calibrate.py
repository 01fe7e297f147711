"""Readings for the limits of ``correct``: the program's on many seeds and
the control's (the plain reference one precision lower, put in the
program's place), one cell, in one process. Not part of a benchmark run.

    python benchmark/calibrate.py --workload rgb10.resident \
        --seeds 11,12,13 --seconds 2 [--control 3]

Each seed is one untraced run of the cell through the harness's own
``run_cell`` (a short window); the control is then read on the same
system, for the window's last request. Prints one JSON line per seed:
``{"seed", "requests", "correct", "program": readings, "control":
readings}`` (the control on the first ``--control`` seeds).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_seed(manifest, workload: str, seed: int, seconds: float, device,
             control: bool = False) -> dict:
    """One run of ``workload`` on ``seed`` and, with ``control``, the
    control's readings on the same system after it."""
    from benchmark.harness.runner import run_cell

    systems = []

    def factory(config, traffic, *args):
        system = manifest.system(config, traffic).System(config, traffic,
                                                         *args)
        systems.append(system)
        return system

    t0 = time.perf_counter()
    res = run_cell(manifest, workload, seed, seconds, False, device,
                   lambda: time.perf_counter() - t0, system_factory=factory)
    line = {"seed": seed, "requests": res["attempted"],
            "correct": res["correct"],
            "program": {k: v["value"] for k, v in res["compared"].items()}}
    if control:
        line["control"] = systems[0].control_readings(res["attempted"] - 1)
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness.manifest import Manifest

    m = Manifest(ROOT / "BENCHMARK.json")
    dev = torch.device(args.device)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = run_seed(m, args.workload, seed, args.seconds, dev,
                        control=k < args.control)
        print(json.dumps(line), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of ``hyperres_torch`` (the PyTorch / CUDA port) on NVIDIA
cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (at the checkout's root) on this
machine's first CUDA device: set-up (scene or data from the seed, the
program's objects, every shape warmed), then a closed-loop window of at
least ``--seconds`` (``harness/window.py``), then the comparison of the
window's sampled products with the plain reference
(``benchmark/reference/``). Standard error carries the log and, last,
each compared number beside its limit; the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, ``breakdown`` (traced runs) and
``compared``.

Exits 3, printing no result, without a CUDA device or with fewer than
the cell asks for; 5 if JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def process_seconds() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where ``/proc`` cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness.manifest import Manifest
    from benchmark.harness.peaks import power_limit_w
    from benchmark.harness.runner import log, print_result, run_cell

    manifest = Manifest(ROOT / "BENCHMARK.json")
    cell = manifest.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"FATAL: cell {cell['name']} needs {cell['chips']} CUDA "
            f"device(s); torch.cuda.is_available() "
            f"{torch.cuda.is_available()}, device_count "
            f"{torch.cuda.device_count()}")
        return 3
    device = torch.device("cuda", 0)
    card = {"kind": torch.cuda.get_device_name(0)}
    log(f"device {card['kind']}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, process_seconds, card=card,
                      power_limit=lambda: power_limit_w(0))
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

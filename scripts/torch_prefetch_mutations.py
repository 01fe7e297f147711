#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s ingest hazard phase (2a) on one
CUDA GPU.

Runs ``chip_smoke.prefetch_phase`` on the port as it is, then with each
of ``hyperres_torch.io.pipeline.PrefetchToDevice``'s two guards switched
off at run time (nothing on disk changes), and prints one RESULT line
per run:

- ``Tensor.record_stream`` made a no-op: a slab the consumer drops goes
  back to the side stream's pool while its read is still queued;
- the loader's pinned-buffer queue made to keep nothing: a pinned buffer
  is let go as soon as its copy is queued.

Run from the repository root:

    python3 scripts/torch_prefetch_mutations.py
"""

from __future__ import annotations

import collections
import sys
import types
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from hyperres_torch.io import pipeline  # noqa: E402

REPEATS = 3


def run(label: str, dev) -> None:
    for _ in range(REPEATS):
        try:
            chip_smoke.prefetch_phase(dev)
            verdict = "slabs intact"
        except SystemExit:
            verdict = "slabs differ"
        print(f"RESULT {label}: {verdict}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    run("as committed", dev)

    record_stream = torch.Tensor.record_stream
    torch.Tensor.record_stream = lambda self, stream: None
    try:
        run("record_stream a no-op", dev)
    finally:
        torch.Tensor.record_stream = record_stream

    real = pipeline.collections
    pipeline.collections = types.SimpleNamespace(
        deque=lambda: collections.deque(maxlen=0))
    try:
        run("pinned-buffer queue keeps nothing", dev)
    finally:
        pipeline.collections = real


if __name__ == "__main__":
    main()

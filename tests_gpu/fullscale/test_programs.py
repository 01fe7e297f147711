"""The port's programs on the card, each run's launch counts read:
``python bench_torch.py`` in a subprocess at scale 1.0 (the ``bench``
fixture's cached scene), and in this process the throughput program,
both validations and the production run at small sizes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench_torch
from card_inputs import MAIN_SCALE, counted, script
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES
from hyperres_torch.kernels.quantize import KERNEL_NAME as QUANT

pytestmark = pytest.mark.gpu

#: seconds ``python bench_torch.py`` may take at scale 1.0, cached scene
BENCH_TIMEOUT = 300
#: the scale of the throughput program and of both validations
PROGRAMS_SCALE = 0.25
PROGRAMS_GRANULES = 2
#: the production run's raw granule (rows, columns) and S2 stack (px)
PROD_RAW = (256, 256)
PROD_S2 = 2048
REPO = Path(__file__).resolve().parents[2]
PASSES = sorted(KERNEL_NAMES.values())


def test_bench_torch(bench):
    """``bench_torch.py`` with HYPERRES_BENCH_SCALE=1.0 and no other
    HYPERRES_BENCH_* variable exits 0 within BENCH_TIMEOUT s with one
    stdout line, a JSON object that meets ``bench.py``'s gates and shows
    ``bench_torch.DEFAULT_RUNS`` launches of each fused ortho warp pass."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HYPERRES_BENCH_")}
    env.update(PYTHONPATH=str(REPO), HYPERRES_BENCH_SCALE=str(MAIN_SCALE))
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout[-2000:]
    line, gates = json.loads(lines[0]), bench_torch.GATES
    assert "status" not in line, line
    assert line["psnr_db"] >= gates["psnr_db_min"]
    assert line["sam_rad"] <= gates["sam_rad_max"]
    assert line["method_psnr_db"] >= gates["method_psnr_db_min"]
    assert all(line["launches"].get(k) == bench_torch.DEFAULT_RUNS
               for k in PASSES), line["launches"]


def test_throughput_program(card, monkeypatch):
    """``torch_bench_throughput`` at PROGRAMS_SCALE with PROGRAMS_GRANULES
    granules: each fused ortho warp pass launched for the warm-up and every
    granule."""
    monkeypatch.setenv("HYPERRES_TP_SCALE", str(PROGRAMS_SCALE))
    monkeypatch.setenv("HYPERRES_TP_GRANULES", str(PROGRAMS_GRANULES))
    monkeypatch.delenv("HYPERRES_TP_TRANSFER", raising=False)
    _, counts = counted(lambda: script("torch_bench_throughput").main([]))
    assert all(counts.get(k, 0) >= PROGRAMS_GRANULES + 1 for k in PASSES
               ), counts


@pytest.mark.parametrize("name", ["torch_validate_fullscale",
                                  "torch_validate_fused_parity"])
def test_validation(card, name):
    """Each validation at PROGRAMS_SCALE passes its own checks (a failed
    one exits) and launches each fused ortho warp pass."""
    _, counts = counted(lambda: script(name).main([str(PROGRAMS_SCALE)]))
    assert all(counts.get(k, 0) >= 1 for k in PASSES), counts


def test_production_run(card, workdir):
    """``torch_run_production_fullscale.run`` on a PROD_RAW granule with a
    PROD_S2 px stack: each fused ortho warp pass and quantize launched,
    the fused product finite on > 0.3 of its pixels, a report."""
    res, counts = counted(lambda: script("torch_run_production_fullscale")
                          .run(workdir / "prod", raw_shape=PROD_RAW,
                               s2_size=PROD_S2))
    assert all(counts.get(k, 0) >= 1 for k in PASSES + [QUANT]), counts
    finite = float(np.isfinite(res.fusion.fused_10m).all(-1).mean())
    assert finite > bench_torch.GATES["finite_frac_min"]
    assert res.report_path.exists()

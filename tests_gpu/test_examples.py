"""The four torch demos on the card (``examples/torch_demo_*.py`` with
``--device cuda``), each run through ``runpy`` with the launch counts set
to 0 just before it and read just after. Each demo asserts its own
accuracy; the numbers it returns are held to the bounds below, and to
their JAX twins' on the CPU in tests/test_torch_examples*.py. The
launch counts and each demo's seconds go into the junit XML report
(``--junitxml``) as properties."""

import json
import runpy
import time
from pathlib import Path

import numpy as np
import pytest

from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES
from hyperres_torch.kernels.quantize import KERNEL_NAME as QUANTIZE

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SCANLINE = tuple(KERNEL_NAMES.values())


def run_demo(name, argv, record_property):
    """``main(argv + ["--device", "cuda"])`` of
    ``examples/torch_demo_<name>.py``; returns its numbers and the kernel
    launches of the run."""
    main = runpy.run_path(str(EXAMPLES / f"torch_demo_{name}.py"))["main"]
    reset_launch_counts()
    t0 = time.perf_counter()
    got = main(argv + ["--device", "cuda"])
    record_property("demo_seconds", round(time.perf_counter() - t0, 3))
    counts = dict(launch_counts)
    record_property("launches", json.dumps(counts, sort_keys=True))
    return got, counts


@pytest.mark.gpu
def test_torch_demo_pairs_on_card(cuda, tmp_path, record_property):
    """The pairs demo (``--no-quicklook``: the card's machine has no
    matplotlib): the ortho cube within 0.05 dB of 53.25 dB PSNR and 1e-4
    rad of 0.0066 rad SAM against the analytic world (the JAX twin's
    readings on the CPU, the bounds of tests/test_torch_examples.py plus
    the printed digits), 8 tiles, SR mean R² > 0.99; each fused ortho
    warp pass and the quantize kernel launched."""
    got, counts = run_demo("pairs", [str(tmp_path), "--no-quicklook"],
                           record_property)
    assert abs(got["ortho_psnr_db"] - 53.25) <= 0.05 + 0.005
    assert abs(got["ortho_sam_rad"] - 0.0066) <= 1e-4
    assert got["n_tiles"] == 8
    assert got["sr_r2_mean"] > 0.99
    assert all(counts.get(k, 0) >= 1 for k in SCANLINE + (QUANTIZE,)), counts


@pytest.mark.gpu
def test_torch_demo_coreg_on_card(cuda, tmp_path, record_property):
    """The coregistration demo: success on band B08, the recovered shift
    within 0.15 px of the applied (2.4, -1.7) px; each fused ortho warp
    pass and the quantize kernel launched."""
    got, counts = run_demo("coreg", [str(tmp_path)], record_property)
    assert got["success"] is True and got["s2_code"] == "B08"
    assert np.all(np.abs(np.subtract(got["recovered_px"], got["applied_px"]))
                  <= 0.15)
    assert all(counts.get(k, 0) >= 1 for k in SCANLINE + (QUANTIZE,)), counts


@pytest.mark.gpu
def test_torch_demo_spectral_sr_on_card(cuda, tmp_path, record_property):
    """The spectral-SR demo: held-out R² median > 0.99 and min > 0.98
    (the JAX twin reads 0.9960 / 0.9858 on the CPU), the (200, 256, 64)
    cube, the reloaded parameters within 1e-6 (the demo's own check). Fit
    and predict are tensor ops: no hand-written kernel is launched."""
    got, counts = run_demo("spectral_sr", [str(tmp_path)], record_property)
    assert got["r2_median"] > 0.99 and got["r2_min"] > 0.98
    assert got["cube_shape"] == (200, 256, 64)
    assert Path(got["params"]).is_file()
    assert counts == {}


@pytest.mark.gpu
def test_torch_demo_multichip_on_card(cuda, record_property):
    """The mesh demo on 8 logical shards of the card: max |ΔW| < 1e-3
    (the demo's own bound), the sharded SRF within 1e-4 of NumPy's
    product, the percentiles within 2 * range / 2048 of NumPy's."""
    got, _ = run_demo("multichip", ["8"], record_property)
    assert got["fit_max_abs_dW"] < 1e-3
    assert got["srf_max_err"] <= 1e-4
    assert np.all(np.abs(np.subtract(got["percentiles"],
                                     got["numpy_percentiles"]))
                  < 2 * got["percentile_range"] / 2048)

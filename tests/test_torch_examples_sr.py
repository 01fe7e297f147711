"""The torch demos of the spectral-SR fit and the device mesh
(``examples/torch_demo_spectral_sr.py``,
``examples/torch_demo_multichip.py``) against their JAX twins on the CPU,
as tests/test_torch_examples.py holds the pipeline demos: the torch demo
through ``runpy`` with ``--device cpu`` at its twin's sizes, the twin on
the same arguments, its printed numbers read back. Each test states its
bounds; every bound adds half a unit of the last digit the twin
prints."""

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_examples import printed, run_torch, run_twin  # noqa: E402


def test_torch_demo_spectral_sr_matches_jax(tmp_path, capsys):
    """The spectral-SR demo: the held-out per-band R² median and min
    within 1e-4 of the twin's and the RMSE median within 1e-5 (the fits
    solve the same system, the port in f64: test_fit_matches_jax's
    2e-6 on the weights); the predicted cube (200, 256, 64); the
    parameters reloaded from the ``.npz`` predict within 1e-6 of the
    fitted model (the demo's own check)."""
    jax_out = run_twin("spectral_sr", [str(tmp_path / "jax")], capsys)
    got = run_torch("spectral_sr",
                    [str(tmp_path / "torch"), "--device", "cpu"])
    r2_med, r2_min = printed(r"R²: median ([-\d.]+) min ([-\d.]+)", jax_out)
    rmse_med, = printed(r"RMSE: median ([-\d.]+)", jax_out)
    assert abs(got["r2_median"] - float(r2_med)) <= 1e-4 + 5e-5
    assert abs(got["r2_min"] - float(r2_min)) <= 1e-4 + 5e-5
    assert abs(got["rmse_median"] - float(rmse_med)) <= 1e-5 + 5e-6
    assert got["cube_shape"] == (200, 256, 64)
    assert "params saved + reloaded OK" in jax_out


def test_torch_demo_multichip_matches_jax(eight_devices, capsys):
    """The mesh demo on 8 shards (``["cpu"] * 8``; the twin on the 8
    virtual CPU devices): the data-parallel fit's max |ΔW| against the
    single-device fit < 1e-3 (the demo's own bound; the port's psum of
    f64 terms gives ~0); the band-sharded SRF within 1e-4 of NumPy's
    product (sums of 288 f32 terms near 7; the twin prints ~8e-6); the
    percentiles within 2 * range / 2048 of NumPy's
    (tests/test_torch_parallel.py's bound) and within one final bin,
    range / 2048², of the twin's."""
    jax_out = run_twin("multichip", ["8"], capsys)
    got = run_torch("multichip", ["8", "--device", "cpu"])
    assert got["n"] == 8
    assert got["fit_max_abs_dW"] < 1e-3
    assert got["srf_max_err"] <= 1e-4
    span = got["percentile_range"]
    q = np.asarray(got["percentiles"])
    assert np.all(np.abs(q - got["numpy_percentiles"]) < 2 * span / 2048)
    lo, hi = printed(r"sharded percentiles: \[\s*([-\d.]+)\s+([-\d.]+)\]",
                     jax_out)
    assert np.all(np.abs(q - [float(lo), float(hi)])
                  <= span / 2048 ** 2 + 5e-5)

"""The port's two host analyses on the card against their own
``--device cpu`` runs, at their smallest sizes:
``scripts/torch_calibrate_coreg_reliability.py`` at 8 windows per cell and
``scripts/torch_srf_sensitivity.py`` at 24 x 32 px of 60 m. The CPU runs
are held to the JAX scripts in tests/test_torch_analyses.py."""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import torch_calibrate_coreg_reliability as cal  # noqa: E402
import torch_srf_sensitivity as sens  # noqa: E402
from hyperres_torch.kernels.phasecorr import RELIABILITY_TAU  # noqa: E402

SRF_SIZE = ["--h60", "24", "--w60", "32"]


@pytest.mark.gpu
def test_analyses_on_card_match_cpu(cuda):
    """Calibration: each window's recovered shift on the card within
    1e-3 px of the CPU's (cuFFT against PocketFFT at f32 rounding), the
    same snr*. SRF sensitivity: 26 rows, each band delta within 1e-5 of
    the CPU's (NumPy on the host in both), the worst fused PSNR against
    the baseline within 1 dB (the card's OT draw differs from the CPU's
    generator); the card's name and power limit in the card's summary
    only."""
    rows = {d: cal.window_rows(8, d) for d in ("cuda", "cpu")}
    for k in ("got_dy", "got_dx"):
        np.testing.assert_allclose([r[k] for r in rows["cuda"]],
                                   [r[k] for r in rows["cpu"]], rtol=0,
                                   atol=1e-3)
    stars = [cal.calibrate(rows[d], RELIABILITY_TAU)["snr_star"]
             for d in ("cuda", "cpu")]
    assert stars[0] is not None and stars[0] == stars[1], stars

    with contextlib.redirect_stdout(io.StringIO()):
        got = {d: sens.main(SRF_SIZE + ["--device", d])
               for d in ("cuda", "cpu")}
    assert got["cuda"]["perturbations"] == got["cpu"]["perturbations"] == 26
    for a, b in zip(got["cuda"]["rows"], got["cpu"]["rows"]):
        for k in ("band_abs_max", "band_rel_max"):
            assert abs(a[k] - b[k]) <= 1e-5, (a, b)
    assert abs(got["cuda"]["worst_fused_psnr_db_vs_baseline"]
               - got["cpu"]["worst_fused_psnr_db_vs_baseline"]) <= 1.0
    assert "power_limit_w" in got["cuda"] and "device" not in got["cpu"]

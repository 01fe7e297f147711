"""The port's host analyses on the card at their full sizes, each
``main`` in this process."""

import contextlib
import io

import pytest

from card_inputs import counted, script

pytestmark = pytest.mark.gpu

#: windows per cell of the reliability calibration: 40 gives the 1440
#: windows the constant RELIABILITY_TAU rests on
CALIB_PER_CELL = 40
CALIB_WINDOWS = 1440
#: the JAX script reads tau 20.845 on the CPU against the constant 20.8;
#: 0.3 in tau is about 0.27 in snr*, three steps of its 0.1 grid
CALIB_TAU_TOL = 0.3
SRF_SENS_PERTURBATIONS = 26
#: the JAX script's worst band delta at 96 x 128 (docs/PARITY.md); the
#: synthesis deltas are NumPy on the host in both scripts
SRF_SENS_WORST_BAND = 0.00575
SRF_SENS_BAND_TOL = 1e-5
#: JAX reads 48.8 dB on the CPU; the margin covers the port's other OT
#: draw (the plan's torch.Generator, not JAX's PRNG)
SRF_SENS_PSNR_MIN_DB = 45.0


def main_of(name, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return counted(lambda: script(name).main(argv))


def test_reliability_calibration(card):
    """``scripts/torch_calibrate_coreg_reliability.py`` at CALIB_PER_CELL
    windows per cell covers CALIB_WINDOWS windows and finds a tau within
    CALIB_TAU_TOL of the port's ``RELIABILITY_TAU``."""
    from hyperres_torch.kernels.phasecorr import RELIABILITY_TAU

    cal, _ = main_of("torch_calibrate_coreg_reliability",
                     [str(CALIB_PER_CELL)])
    assert cal["n_windows"] == CALIB_WINDOWS and cal["tau"] is not None
    assert abs(cal["tau"] - RELIABILITY_TAU) <= CALIB_TAU_TOL, cal["tau"]


def test_srf_sensitivity(card):
    """``scripts/torch_srf_sensitivity.py`` at its default 96 x 128 runs
    SRF_SENS_PERTURBATIONS perturbations, reads a worst band delta within
    SRF_SENS_BAND_TOL of SRF_SENS_WORST_BAND and a worst fused PSNR of at
    least SRF_SENS_PSNR_MIN_DB against its baseline."""
    sens, _ = main_of("torch_srf_sensitivity", [])
    assert sens["perturbations"] == SRF_SENS_PERTURBATIONS
    assert abs(sens["worst_band_abs_delta_reflectance"]
               - SRF_SENS_WORST_BAND) <= SRF_SENS_BAND_TOL
    assert (sens["worst_fused_psnr_db_vs_baseline"]
            >= SRF_SENS_PSNR_MIN_DB)

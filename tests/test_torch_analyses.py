"""The port's two host analyses against the JAX scripts they port, on the
CPU (every port call passes ``device="cpu"``):

- ``scripts/torch_calibrate_coreg_reliability.py`` against
  ``scripts/calibrate_coreg_reliability.py`` at 8 windows per cell (288
  windows): the same windows, each window's shift and reliability, and
  the threshold snr* and constant tau the two print.
- ``scripts/torch_srf_sensitivity.py`` against ``scripts/srf_sensitivity.py``
  at ``--h60 24 --w60 32``: each row's synthesis deltas, the baseline
  fused products, and each row's fused PSNR against its baseline.

Each JAX script runs once, through its guarded ``main`` with ``sys.argv``
set, with its device calls wrapped to record what they saw and returned.
Each test's docstring states its tolerance.
"""

import contextlib
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import calibrate_coreg_reliability as jcal  # noqa: E402
import srf_sensitivity as jsens  # noqa: E402
import torch_calibrate_coreg_reliability as tcal  # noqa: E402
import torch_srf_sensitivity as tsens  # noqa: E402
from hyperres.fusion import fused as jfused  # noqa: E402
from hyperres.kernels import phasecorr as jphasecorr  # noqa: E402
from hyperres.pipeline import psnr  # noqa: E402
from hyperres_torch.kernels.phasecorr import RELIABILITY_TAU  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402

N_PER_CELL = 8
SRF_SIZE = ["--h60", "24", "--w60", "32"]
SHIFT_TOL_PX = 1e-3
RELIABILITY_TOL = 0.01
SNR_STEP = 0.1
BAND_TOL = 1e-5
BASELINE_MIN_DB = 35.0
#: the two packages' per-row fused PSNR at this size, unrounded, differed
#: by at most 9.9e-5 dB on the CPU when written (baselines 131 dB apart):
#: the 60 m grid holds 768 pixels, fewer than the 2000 OT samples, so
#: both draws take every valid pixel; the bound is 500 times that
FUSED_PSNR_TOL_DB = 0.05


def _run_jax_script(module, argv):
    """``module.main()`` with ``sys.argv = [file] + argv``; what it printed
    to stdout."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [module.__file__] + argv)
        module.main()
    return out.getvalue()


@pytest.fixture(scope="module")
def jax_calibration():
    """The JAX script's run at N_PER_CELL: its printed snr* and tau, and
    each ``phase_correlate_batch`` call's inputs and outputs as NumPy."""
    calls = []
    real = jphasecorr.phase_correlate_batch

    def recorded(ref, tgt, lowpass_frac=1.0):
        dy, dx, rel = real(ref, tgt, lowpass_frac=lowpass_frac)
        calls.append({"refs": np.asarray(ref), "tgts": np.asarray(tgt),
                      "lowpass_frac": lowpass_frac, "dy": np.asarray(dy),
                      "dx": np.asarray(dx), "rel": np.asarray(rel)})
        return dy, dx, rel

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jphasecorr, "phase_correlate_batch", recorded)
        text = _run_jax_script(jcal, [str(N_PER_CELL)])
    snr_star = float(re.search(r"snr\* = ([0-9.]+):", text).group(1))
    tau = float(re.search(r"==> tau = .* = ([0-9.]+) ", text).group(1))
    return {"snr_star": snr_star, "tau": tau, "calls": calls, "text": text}


@pytest.fixture(scope="module")
def port_rows():
    return tcal.window_rows(N_PER_CELL, "cpu")


@pytest.fixture(scope="module")
def srf_runs():
    """Both scripts at SRF_SIZE: each one's printed / returned summary and
    its fused products in call order (the baseline first)."""
    jax_products, port_products = [], []

    class RecordingPlan(jfused.FusedFusionPlan):
        def __call__(self, *args, **kw):
            out = super().__call__(*args, **kw)
            jax_products.append(np.asarray(out["fused_10m"]))
            return out

    real_run = tsens.run_fusion

    def recorded_run(scene, srf, device):
        assert str(device) == "cpu"
        port_products.append(real_run(scene, srf, device))
        return port_products[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused, "FusedFusionPlan", RecordingPlan)
        jax_summary = json.loads(_run_jax_script(jsens, SRF_SIZE))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsens, "run_fusion", recorded_run)
        with contextlib.redirect_stdout(io.StringIO()):
            port_summary = tsens.main(SRF_SIZE + ["--device", "cpu"])
    return {"jax": jax_summary, "port": port_summary,
            "jax_products": jax_products, "port_products": port_products}


@pytest.mark.parametrize("corr_len", [2.0, 20.0])
def test_copied_helpers_equal_the_jax_scripts(corr_len):
    """``smooth_texture``, ``subpixel_shift``, ``block_mean`` and
    ``perturb_srf`` are bit-equal to the JAX scripts' functions on seeded
    inputs (``array_equal``: the copies are verbatim; ``perturb_srf``'s
    ``np.trapezoid`` is ``np.trapz`` renamed)."""
    a = tcal.smooth_texture(np.random.default_rng(5), 96, corr_len)
    b = jcal.smooth_texture(np.random.default_rng(5), 96, corr_len)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcal.subpixel_shift(a, 3.7, -1.25),
                                  jcal.subpixel_shift(b, 3.7, -1.25))
    np.testing.assert_array_equal(tcal.block_mean(a[:95, :94], 6),
                                  jcal.block_mean(b[:95, :94], 6))
    srf = builtin_srf("S2A", bands=["B2", "B3", "B4", "B8A"],
                      exponent=corr_len / 4.0)
    for dc, ff in ((0.0, 1.0), (-2.0, 0.95), (2.0, 1.05)):
        got = tsens.perturb_srf(srf, dc, ff)
        with np.testing.suppress_warnings() as sup:
            sup.filter(DeprecationWarning)
            want = jsens.perturb_srf(srf, dc, ff)
        assert list(got) == list(want)
        for band in got:
            for x, y in zip(got[band], want[band]):
                np.testing.assert_array_equal(x, y)


def test_calibration_windows_match_jax(jax_calibration, port_rows):
    """The port's ensemble is the JAX script's window for window
    (``array_equal`` references and targets, the same low-pass per cell);
    on each of the 288 windows the port's shift lies within 1e-3 px and
    its reliability within 0.01 (0-100 scale) of JAX's
    ``phase_correlate_batch``."""
    calls = jax_calibration["calls"]
    cells = list(tcal.ensemble(N_PER_CELL))
    assert len(cells) == len(calls) == 36
    for cell, call in zip(cells, calls):
        np.testing.assert_array_equal(cell[3], call["refs"])
        np.testing.assert_array_equal(cell[4], call["tgts"])
        assert cell[6] == call["lowpass_frac"]
    want = {k: np.concatenate([c[k] for c in calls])
            for k in ("dy", "dx", "rel")}
    assert len(port_rows) == len(want["dy"]) == 288
    got = {k: np.array([r[name] for r in port_rows])
           for k, name in (("dy", "got_dy"), ("dx", "got_dx"),
                           ("rel", "reliability"))}
    np.testing.assert_allclose(got["dy"], want["dy"], rtol=0,
                               atol=SHIFT_TOL_PX)
    np.testing.assert_allclose(got["dx"], want["dx"], rtol=0,
                               atol=SHIFT_TOL_PX)
    np.testing.assert_allclose(got["rel"], want["rel"], rtol=0,
                               atol=RELIABILITY_TOL)


def test_calibration_threshold_matches_jax(jax_calibration, port_rows,
                                           monkeypatch, capsys):
    """``main(["8", "--device", "cpu"])`` returns snr* and tau equal to
    those the JAX script prints here (18.00 / 19.644 when written), tau
    to the 3 decimals printed; or, if snr* lies one grid step (0.1) away,
    the failure names the windows whose rounded SNR or acceptance moved.
    Its per-window rows are the fixture's (``window_rows`` is stubbed to
    them after checking its arguments)."""
    def rows(n_per, device):
        assert (n_per, device) == (N_PER_CELL, "cpu")
        return port_rows

    monkeypatch.setattr(tcal, "window_rows", rows)
    res = tcal.main([str(N_PER_CELL), "--device", "cpu"])
    text = capsys.readouterr().out
    assert res["n_windows"] == 288
    assert f"==> tau = snr*/ln(2.5) = {res['tau']:.3f}" in text
    want = jax_calibration
    if res["snr_star"] != want["snr_star"]:
        rel_j = np.concatenate([c["rel"] for c in want["calls"]])
        snr_j = np.round(tcal.window_snr(rel_j, RELIABILITY_TAU), 1)
        snr_t = np.round(tcal.window_snr(
            [r["reliability"] for r in port_rows], RELIABILITY_TAU), 1)
        moved = [(i, port_rows[i]["kind"], port_rows[i]["corr_len"],
                  port_rows[i]["noise"], float(snr_j[i]), float(snr_t[i]))
                 for i in np.flatnonzero(snr_j != snr_t)]
        steps = abs(res["snr_star"] - want["snr_star"]) / SNR_STEP
        pytest.fail(
            f"snr* {res['snr_star']} (port) vs {want['snr_star']} (JAX), "
            f"{steps:.0f} grid step(s) apart; windows (index, kind, "
            f"corr_len, noise, JAX snr, port snr) whose rounded SNR moved: "
            f"{moved}")
    assert abs(res["tau"] - want["tau"]) <= 5e-4, (res["tau"], want["tau"])


def test_srf_band_deltas_match_jax(srf_runs):
    """26 rows, in the JAX script's order of (centre, FWHM, exponent);
    each row's ``band_abs_max`` and ``band_rel_max`` and the worst band
    delta within 1e-5 of the JAX script's (the synthesis is NumPy on
    both sides and the weight matrices are copies: equal when written)."""
    j, t = srf_runs["jax"], srf_runs["port"]
    assert t["perturbations"] == j["perturbations"] == 26
    for rj, rt in zip(j["rows"], t["rows"]):
        key = ("d_centre_nm", "fwhm_factor", "exponent")
        assert [rt[k] for k in key] == [rj[k] for k in key]
        for k in ("band_abs_max", "band_rel_max"):
            assert abs(rt[k] - rj[k]) <= BAND_TOL, (rj, rt)
    assert abs(t["worst_band_abs_delta_reflectance"]
               - j["worst_band_abs_delta_reflectance"]) <= BAND_TOL


def test_srf_baseline_fused_products_agree(srf_runs):
    """The two packages' baseline fused products (the first of each run's
    27) lie more than 35 dB apart on the pixels finite in both, the bar
    tests/test_torch_bench_scripts.py uses for fused products."""
    a, b = srf_runs["port_products"][0], srf_runs["jax_products"][0]
    assert len(srf_runs["port_products"]) == len(srf_runs["jax_products"]) \
        == 27
    m = np.isfinite(a).all(-1) & np.isfinite(b).all(-1)
    assert m.mean() > 0.9
    assert psnr(a[m], b[m]) > BASELINE_MIN_DB


def test_srf_fused_psnr_rows_match_jax(srf_runs):
    """Each row's fused PSNR against its own baseline, computed unrounded
    from both packages' products with the script's formula, lies within
    FUSED_PSNR_TOL_DB (0.05 dB) of JAX's; the printed (rounded) values
    and the worst case within that plus one 0.1 dB rounding step."""
    def row_psnr(products):
        base = products[0]
        out = []
        for p in products[1:]:
            m = np.isfinite(p).all(-1) & np.isfinite(base).all(-1)
            mse = ((p[m] - base[m]) ** 2).mean()
            out.append(float(10 * np.log10(1.0 / max(mse, 1e-12))))
        return np.array(out)

    got = row_psnr(srf_runs["port_products"])
    want = row_psnr(srf_runs["jax_products"])
    np.testing.assert_allclose(got, want, rtol=0, atol=FUSED_PSNR_TOL_DB)
    j, t = srf_runs["jax"], srf_runs["port"]
    for rj, rt in zip(j["rows"], t["rows"]):
        assert abs(rt["fused_psnr_db_vs_baseline"]
                   - rj["fused_psnr_db_vs_baseline"]) <= \
            FUSED_PSNR_TOL_DB + 0.1 + 1e-9
    assert abs(t["worst_fused_psnr_db_vs_baseline"]
               - j["worst_fused_psnr_db_vs_baseline"]) <= \
        FUSED_PSNR_TOL_DB + 0.1 + 1e-9


@pytest.mark.parametrize("script", [tcal, tsens])
def test_analyses_need_a_card_by_default(script, monkeypatch):
    """Without ``--device`` each analysis runs on the current CUDA device:
    with none there it raises (as ``resolve_device``), never falling back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main(["2"] if script is tcal else SRF_SIZE)

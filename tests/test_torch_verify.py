"""The port's granule parity harness (``hyperres_torch.verify.
verify_granule``) on the CPU, on the scene ``tests/test_verify_granule.py``
uses (``make_scene(raw_shape=(80, 90), n_bands=48, s2_size=420)``), and
its report against the JAX package's on the same files.

Tolerances: the cube PSNR of the two packages' shipped-vs-exact
comparison within 0.5 dB (both compare a two-pass warp with a tap-loop
warp; the ports agree with their originals to ~1e-6, and at ~60 dB the
MSE is a sum of such differences), SAM within 2e-4 rad, the mask
agreement equal; the fused products' PSNRs are those of two different
OT sample draws, so only their gates are compared."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres.testing.scenes import make_scene  # noqa: E402
from hyperres.verify import verify_granule as j_verify  # noqa: E402
from hyperres_torch import verify as tverify  # noqa: E402
from hyperres_torch.verify import VerifyResult, verify_granule  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' harness once on one scene: (port, jax, scene)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPERRES_SRF_SOURCE", "parametric")
        d = tmp_path_factory.mktemp("torch_verify")
        sc = make_scene(d / "scene", raw_shape=(80, 90), n_bands=48,
                        s2_size=420)
        with pytest.warns(UserWarning, match="PARAMETRIC"):
            tres = verify_granule(sc.emit_nc_path, sc.s2_tif_path,
                                  d / "port", device="cpu")
        jres = j_verify(sc.emit_nc_path, sc.s2_tif_path, d / "jax")
    return tres, jres, sc


def test_verify_granule_passes_its_gates(runs):
    """The default gates hold on the test scene, as in
    tests/test_verify_granule.py; the report and the JSON are written."""
    tres = runs[0]
    assert isinstance(tres, VerifyResult) and tres.passed is True
    assert tres.report_path.name == "verify_granule.md"
    assert tres.json_path.name == "verify_granule.json"
    m = json.loads(tres.json_path.read_text())
    assert m == json.loads(json.dumps(tres.metrics))
    assert m["passed"] is True, m["gates"]
    assert m["cube_shipped_vs_exact"]["psnr_db"] > 40.0
    assert m["cube_shipped_vs_exact"]["mask_agreement"] > 0.999
    assert m["fused_shipped_vs_exact"]["psnr_db"] > 40.0
    assert m["pipeline_audit"]["psnr_db"] > 40.0
    assert m["coeffs_max_abs_delta"] < 0.5
    assert m["ortho_shipped_backend"] == "pallas_banded"
    text = tres.report_path.read_text()
    assert "Granule parity report" in text and "**PASS**" in text


def test_verify_report_has_the_reference_keys(runs):
    """The same JSON keys at every level and the same report lines
    (numbers and paths aside), so the two packages' reports diff."""
    tres, jres, _ = runs

    def keys(v):
        if isinstance(v, dict):
            return {k: keys(x) for k, x in v.items()}
        return None

    assert keys(tres.metrics) == keys(jres.metrics)

    def skeleton(text):
        import re
        return [re.sub(r"[-+]?\d+\.?\d*(e[-+]?\d+)?|`[^`]*`|pallas_banded|"
                       r"auto|two_pass", "#", line)
                for line in text.splitlines()]

    assert skeleton(tres.report_path.read_text()) == skeleton(
        jres.report_path.read_text())


def test_verify_metrics_match_jax(runs):
    """The cube comparison within 0.5 dB / 2e-4 rad of the JAX report's,
    equal valid fraction and mask agreement (4 and 6 decimals), the same
    ``passed``; each fused gate on the same side."""
    tres, jres, _ = runs
    a, b = (r.metrics["cube_shipped_vs_exact"] for r in (tres, jres))
    assert abs(a["psnr_db"] - b["psnr_db"]) <= 0.5
    assert abs(a["sam_rad"] - b["sam_rad"]) <= 2e-4
    assert a["valid_frac"] == b["valid_frac"]
    assert a["mask_agreement"] == b["mask_agreement"]
    assert tres.passed == jres.passed is True
    for k, g in tres.metrics["gates"].items():
        assert g["pass"] == jres.metrics["gates"][k]["pass"]
        assert g["gate"] == jres.metrics["gates"][k]["gate"]
    assert np.shape(tres.metrics["coeffs_shipped"]) == (3, 5)
    assert np.shape(tres.metrics["coeffs_exact"]) == (3, 5)


def test_verify_exact_half_is_reproducible_against_jax(runs):
    """The exact half (tap-loop cube -> phase-wise fusion, host-RNG
    sampling) is deterministic in both packages: its coefficients define
    curves within 1e-3 of the reference's over [0, 1]."""
    tres, jres, _ = runs
    x = np.linspace(0.0, 1.0, 51)
    for ca, cb in zip(tres.metrics["coeffs_exact"],
                      jres.metrics["coeffs_exact"]):
        assert np.abs(np.polyval(ca, x) - np.polyval(cb, x)).max() < 1e-3


def test_verify_gates_decide_passed(runs, tmp_path, monkeypatch):
    """A gate above the measured value fails the run and the report
    says so; the ortho outputs of both routes are where the reference
    puts them."""
    _, _, sc = runs
    monkeypatch.setenv("HYPERRES_SRF_SOURCE", "parametric")
    res = verify_granule(sc.emit_nc_path, sc.s2_tif_path, tmp_path,
                         cube_psnr_gate=200.0, device="cpu")
    assert res.passed is False
    assert res.metrics["gates"]["cube_psnr"]["pass"] is False
    assert res.metrics["gates"]["fused_psnr"]["pass"] is True
    assert "**FAIL**" in res.report_path.read_text()
    for sub in ("shipped", "exact"):
        assert list((tmp_path / sub).glob("*.hdr"))


def test_verify_reads_the_envi_cube_when_none_is_kept(runs, tmp_path,
                                                       monkeypatch):
    """A second run into a finished directory: the ortho stage skips
    (no device cube), the cubes come from the ENVI files, and the cube
    metrics are the first run's."""
    tres, _, sc = runs
    monkeypatch.setenv("HYPERRES_SRF_SOURCE", "parametric")
    out = tres.json_path.parent
    again = verify_granule(sc.emit_nc_path, sc.s2_tif_path, out,
                           device="cpu")
    assert again.metrics["cube_shipped_vs_exact"] == tres.metrics[
        "cube_shipped_vs_exact"]
    assert again.passed is True


def test_fused_metrics_helper():
    """``_fused_metrics``: None PSNR / SAM and 0 agreement for products
    with no common finite pixel; else the pipeline's psnr / sam."""
    a = np.full((4, 5, 3), np.nan)
    b = np.zeros((4, 5, 3))
    assert tverify._fused_metrics(a, b) == {
        "psnr_db": None, "sam_rad": None, "mask_agreement": 0.0}
    b = np.random.default_rng(0).random((4, 5, 3))
    a = b + 0.01
    a[0, 0] = np.nan
    m = tverify._fused_metrics(a, b)
    assert m["psnr_db"] == 40.0 and m["mask_agreement"] == 0.95

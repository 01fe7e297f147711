"""The port's full pairs pipeline (``hyperres_torch.pipeline.
run_pair_pipeline``) against the JAX package's on the CPU, on the scene
of tests/test_pipeline_e2e.py:10 (raw 80 x 90, 48 bands, S2 420 px), with
``TilingConfig(emit_tile_size=16, max_black_frac=0.05)``, ``max_tiles=4``,
``train_sr=True``, ``predict_sr_cube=True``; the port runs with
``device="cpu"``.

Tolerances, by ``engine="phases"`` (host-RNG OT sampling, reproducible
against the reference from one seed):

- the ortho ENVI cube as tests/test_torch_ortho.py holds it: the same
  fill, atol 1e-5 on the 2-px eroded interior, elsewhere 2e-4 of
  max(|v|, 1);
- ``fused_10m``: the same NaN pixels, atol 1e-5 (measured ~1e-6: the
  fit's f32 sums in another order);
- the tile list identical; the decoded tile GeoTIFFs within one code
  (measured: equal); ``sr_metrics["r2_mean"]`` within 1e-4;
- the SR cube's u16 codes within two codes, and no more than 2e-4 of
  them more than one code apart (measured: 6 % differ by one, 394 of
  5.6 M by two). The reference solves the SR model's normal equations in
  f32, the port in f64 (``fusion/ridge_sr.py``'s docstring), and this
  scene's ten S2 bands come from a four-endmember world, so the f32
  solve is badly conditioned and its rounding reaches ~1.5e-4 of
  reflectance at worst;
- the report's sections, in order, and its lines with numbers and paths
  blanked.

By ``engine="fused"``: the two packages draw different OT samples
(ROADMAP's PRNG pin), so the fused product is held statistically, > 35
dB from the reference's. With ``coregister=True`` on the shifted scene of
tests/test_pipeline_e2e.py:99 (shifted here with NumPy): ``mean_shift_px``
within 0.05 px of the reference's, within 1.5 px of the injected shift.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage
from scipy.ndimage import binary_erosion

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres import pipeline as jpipe  # noqa: E402
from hyperres.core import config as jconfig  # noqa: E402
from hyperres.testing.scenes import make_scene  # noqa: E402
from hyperres_torch import pipeline as tpipe  # noqa: E402
from hyperres_torch.core import config as tconfig  # noqa: E402
from hyperres_torch.io import envi  # noqa: E402
from hyperres_torch.io.tiff import TiffReader, write_geotiff  # noqa: E402

SECTIONS = ["Orthorectification", "Fusion (OT + poly)", "Tiles",
            "Spectral SR (ridge)", "Spectral SR 10 m product", "Timing"]
COREG_SHIFT = (2.0, -3.0)


def _run(mod, cfg, scene, out, **kw):
    kwargs = dict(tiling_config=cfg.TilingConfig(emit_tile_size=16,
                                                 max_black_frac=0.05),
                  max_tiles=4, train_sr=True, predict_sr_cube=True)
    kwargs.update(kw)
    if mod is tpipe:
        kwargs["device"] = "cpu"
    return mod.run_pair_pipeline(scene.emit_nc_path, scene.s2_tif_path,
                                 out, **kwargs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' pipeline by ``engine="phases"`` on one scene, and
    by ``engine="fused"``: {engine: (port, jax)}, and the scene."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPERRES_SRF_SOURCE", "parametric")
        d = tmp_path_factory.mktemp("torch_pairs")
        sc = make_scene(d / "scene", raw_shape=(80, 90), n_bands=48,
                        s2_size=420)
        out = {}
        for engine in ("phases", "fused"):
            with pytest.warns(UserWarning, match="PARAMETRIC"):
                t = _run(tpipe, tconfig, sc, d / f"port_{engine}",
                         engine=engine)
            j = _run(jpipe, jconfig, sc, d / f"jax_{engine}", engine=engine)
            out[engine] = (t, j)
    return out, sc


def test_outputs_and_result(runs):
    """A ``PairRunResult`` with every artifact on disk: the fused and SR
    GeoTIFFs, the tiles with their ``_b32`` subsets and JSON, the
    manifest, the report; ``info["stages"]`` times each stage."""
    t, j = runs[0]["phases"]
    assert isinstance(t, tpipe.PairRunResult)
    assert t.fused_tif.name == j.fused_tif.name == "fused_rgb_10m.tif"
    assert t.fused_tif.exists() and t.report_path.exists()
    assert t.run.local_manifest_csv.exists()
    assert len(t.tile_records) == len(t.tiles) == 4
    for rec in t.tile_records:
        for p in (rec.emit_tif, rec.s2_tif, rec.emit_b32_tif):
            assert Path(p).exists()
        assert (t.run.local_tile_meta / f"tile_{rec.idx:03d}.json").exists()
    assert Path(t.sr_metrics["sr_cube_tif"]).name == "emit_sr_10m.tif"
    assert (t.run.local_meta / "ortho_info.json").exists()
    assert set(t.info) == {"total_seconds", "coreg", "stages"}
    assert list(t.info["stages"]) == ["ortho", "crop", "fusion",
                                      "fused_geotiff", "tiling", "sr_fit",
                                      "sr_predict", "sr_geotiff"]
    assert t.info["coreg"] is None and j.info["coreg"] is None
    assert t.fusion.info["engine"] == "phases"


def test_ortho_cube_matches(runs):
    """The ENVI cube the pipeline orthorectified: the ortho tolerance of
    tests/test_torch_ortho.py."""
    t, j = runs[0]["phases"]
    got, want = (envi.EnviReader(r.ortho_info["outputs"]["data_envi_hdr"])
                 .read() for r in (t, j))
    fill = want == -9999.0
    np.testing.assert_array_equal(got == -9999.0, fill)
    interior = binary_erosion(~fill.all(-1), iterations=2)[..., None] & ~fill
    np.testing.assert_allclose(got[interior], want[interior], rtol=0,
                               atol=1e-5)
    err = np.abs(got[~fill] - want[~fill]) / np.maximum(
        np.abs(want[~fill]), 1.0)
    assert err.max() <= 2e-4


def test_fusion_matches_by_phases(runs):
    """``fused_10m``, ``matched_60m`` and the coefficients of the
    phase-wise engine: tight (module docstring); the fused GeoTIFFs
    decode within the same bound."""
    t, j = runs[0]["phases"]
    a, b = t.fusion.fused_10m, j.fusion.fused_10m
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(t.fusion.matched_60m, j.fusion.matched_60m,
                               rtol=0, atol=1e-5, equal_nan=True)
    assert t.fusion.info["n_valid_60m"] == j.fusion.info["n_valid_60m"]
    with TiffReader(t.fused_tif) as ra, TiffReader(j.fused_tif) as rb:
        assert (ra.grid, ra.nodata, ra.descriptions) == (
            rb.grid, rb.nodata, rb.descriptions)
        np.testing.assert_allclose(ra.read(), rb.read(), rtol=0, atol=1e-5)


def _tile_lists(t, j):
    return [[{k: (vars(v) if hasattr(v, "col_off") else v)
              for k, v in tile.items()} for tile in r.tiles]
            for r in (t, j)]


def _decoded(path):
    with TiffReader(path) as r:
        return r.read(), (r.grid, r.nodata, r.descriptions, r.dataset_tags)


def test_tiles_match(runs):
    """The same tiles; every tile GeoTIFF (EMIT, S2, ``_b32``) decodes
    within one code of the reference's, with the same georeferencing,
    nodata, descriptions and tags; the same ``_b32`` indices."""
    t, j = runs[0]["phases"]
    a, b = _tile_lists(t, j)
    assert a == b
    for rt, rj in zip(t.tile_records, j.tile_records):
        assert rt.emit_b32_indices_0based == rj.emit_b32_indices_0based
        for pt, pj in ((rt.emit_tif, rj.emit_tif), (rt.s2_tif, rj.s2_tif),
                       (rt.emit_b32_tif, rj.emit_b32_tif)):
            (qa, ma), (qb, mb) = _decoded(pt), _decoded(pj)
            assert ma == mb and qa.dtype == qb.dtype
            assert np.abs(qa.astype(np.int64)
                          - qb.astype(np.int64)).max() <= 1


def test_sr_product_and_metrics_match(runs):
    """The SR metrics (``r2_mean`` within 1e-4, the same band indices and
    training pixels) and the decoded 10 m SR cube within the bound of the
    module docstring, with the same mask, descriptions and tags."""
    t, j = runs[0]["phases"]
    mt, mj = t.sr_metrics, j.sr_metrics
    assert abs(mt["r2_mean"] - mj["r2_mean"]) <= 1e-4
    assert mt["band_indices"] == mj["band_indices"]
    assert mt["n_train_pixels"] == mj["n_train_pixels"]
    np.testing.assert_allclose(mt["r2_per_band"], mj["r2_per_band"],
                               atol=1e-4)
    assert mt["r2_mean"] > 0.8
    (qa, ma), (qb, mb) = (_decoded(m["sr_cube_tif"]) for m in (mt, mj))
    assert ma == mb and qa.dtype == qb.dtype == np.uint16
    np.testing.assert_array_equal(qa == 65535, qb == 65535)
    d = np.abs(qa.astype(np.int64) - qb.astype(np.int64))
    assert d.max() <= 2 and (d > 1).mean() <= 2e-4


def _skeleton(text, root):
    text = text.replace(str(root), "<root>")
    return [re.sub(r"[-+]?\d[\d,]*\.?\d*(e[-+]?\d+)?|\{[^}]*\}", "#", line)
            for line in text.splitlines()]


def test_report_and_metadata_match(runs):
    """The report's sections in the reference's order and its lines
    (numbers, stage dicts and paths blanked); the manifest and the tile
    JSON equal with paths and timestamps normalised."""
    for engine in ("phases", "fused"):
        t, j = runs[0][engine]
        tt, jt = (r.report_path.read_text() for r in (t, j))
        heads = [ln[3:] for ln in tt.splitlines() if ln.startswith("## ")]
        assert heads == SECTIONS
        assert _skeleton(tt, t.run.local_root) == _skeleton(
            jt, j.run.local_root)
    t, j = runs[0]["phases"]

    def norm(r, text):
        text = text.replace(str(r.run.local_root), "<root>")
        return re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", "<stamp>", text)

    assert norm(t, t.run.local_manifest_csv.read_text()) == norm(
        j, j.run.local_manifest_csv.read_text())
    for rec in t.tile_records:
        name = f"tile_{rec.idx:03d}.json"
        a = json.loads(norm(t, (t.run.local_tile_meta / name).read_text()))
        b = json.loads(norm(j, (j.run.local_tile_meta / name).read_text()))
        assert a == b


def test_fused_engine_statistically(runs):
    """``engine="fused"`` (the default path: the ortho cube stays on the
    device into the fused plan): the fused product > 35 dB from the
    reference's fused product (different OT draws), the same valid
    pixels, values in [0, 1]; the tiles identical to the phase-wise
    run's; the SR fit on the device cube within 1e-4 of the reference."""
    t, j = runs[0]["fused"]
    assert t.fusion.info["engine"] == "fused"
    a, b = t.fusion.fused_10m, j.fusion.fused_10m
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert tpipe.psnr(a, b) > 35.0
    ok = np.isfinite(a)
    assert a[ok].min() >= 0.0 and a[ok].max() <= 1.0
    assert _tile_lists(t, j)[0] == _tile_lists(*runs[0]["phases"])[0]
    assert abs(t.sr_metrics["r2_mean"] - j.sr_metrics["r2_mean"]) <= 1e-4


def _shifted_stack(src, dst, shift):
    """tests/test_pipeline_e2e.py:99's shifted S2 stack, by SciPy: a
    bilinear shift with reflected edges."""
    with TiffReader(src) as r:
        stack = r.read().astype(np.float32)
        grid, nodata, descs = r.grid, r.nodata, r.descriptions
    shifted = np.stack([ndimage.shift(b, shift, order=1, mode="reflect")
                        for b in stack])
    write_geotiff(dst, shifted.astype(np.uint16), grid, nodata=nodata,
                  descriptions=descs)
    return dst


def test_pipeline_with_coregistration_matches(tmp_path, monkeypatch):
    """``coregister=True`` on tests/test_pipeline_e2e.py:99's scene and
    settings: success in both packages, the same band, the mean shift
    within 0.05 px of the reference's and within 1.5 px of the injected
    one; the coregistered stack feeds the overlap crop; the report has
    the Coregistration section."""
    monkeypatch.setenv("HYPERRES_SRF_SOURCE", "parametric")
    sc = make_scene(tmp_path / "scene", raw_shape=(90, 100), n_bands=24,
                    s2_size=480, noise=0.001)
    shifted = _shifted_stack(sc.s2_tif_path, tmp_path / "s2_shifted.tif",
                             COREG_SHIFT)
    res = {}
    for name, mod, cfg in (("port", tpipe, tconfig),
                           ("jax", jpipe, jconfig)):
        kw = dict(coregister=True,
                  coreg_config=cfg.CoregConfig(
                      window_size=(256, 256), grid_res=120, max_points=9,
                      min_reliability=20, max_shift=8.0),
                  tiling_config=cfg.TilingConfig(emit_tile_size=16,
                                                 max_black_frac=0.1),
                  max_tiles=2, train_sr=False)
        if mod is tpipe:
            kw["device"] = "cpu"
        res[name] = mod.run_pair_pipeline(sc.emit_nc_path, shifted,
                                          tmp_path / name, **kw)
    ft, fj = (res[k].info["coreg"]["final"] for k in ("port", "jax"))
    assert ft["success"] and fj["success"]
    assert ft["s2_code"] == fj["s2_code"]
    np.testing.assert_allclose(ft["mean_shift_px"], fj["mean_shift_px"],
                               rtol=0, atol=0.05)
    assert abs(ft["mean_shift_px"][0] - COREG_SHIFT[0]) < 1.5
    assert abs(ft["mean_shift_px"][1] - COREG_SHIFT[1]) < 1.5
    t = res["port"]
    assert (t.run.local_s2 / "s2_coregistered.tif").exists()
    assert "## Coregistration\n" in t.report_path.read_text()
    assert "coreg" in t.info["stages"] and t.sr_metrics is None

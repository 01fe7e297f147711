"""The port's ``viz`` copies (``hyperres_torch.viz``) held to the originals
(``hyperres.viz``) on the same inputs, as tests/test_torch_core.py holds
the ``core`` copies: every function of both modules, on seeded arrays and
on files the tests write. The copies are verbatim apart from their
package imports, so the results are equal (arrays ``array_equal``, text
and returned records ``==``); the drawing functions are held to the same
returned arrays and to writing their image files.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres import viz as jviz  # noqa: E402
from hyperres.viz import interactive as jint  # noqa: E402
from hyperres_torch import viz as tviz  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.io import envi  # noqa: E402
from hyperres_torch.io.tiff import write_geotiff  # noqa: E402
from hyperres_torch.viz import interactive as tint  # noqa: E402


def test_same_exports():
    assert tviz.__all__ == jviz.__all__
    assert (tviz.quicklook.RGB_WAVELENGTHS_NM
            == jviz.quicklook.RGB_WAVELENGTHS_NM)
    assert tviz.quicklook.SCL_COLORS == jviz.quicklook.SCL_COLORS


@pytest.fixture
def cube(rng):
    c = rng.random((30, 26, 20)).astype(np.float32)
    c[3:6, 4:9, :] = -9999.0
    c[10, 10, 5] = np.nan
    return c


def test_array_helpers_match(rng, cube):
    """nearest_band_index, percentile_stretch, the shared stretch pair
    and emit_rgb_from_cube (both white balance settings, a gamma)."""
    wl = np.linspace(380.0, 2500.0, 20)
    for nm in (490.0, 560.0, 665.0, 2400.0):
        assert tviz.nearest_band_index(wl, nm) == jviz.nearest_band_index(
            wl, nm)
    x = cube[..., 2]
    np.testing.assert_array_equal(tviz.percentile_stretch(x, 5, 95),
                                  jviz.percentile_stretch(x, 5, 95))
    ims = [rng.random((8, 9, 3)), rng.random((5, 4, 3))]
    lo, hi = tviz.compute_shared_stretch_params(ims)
    jlo, jhi = jviz.compute_shared_stretch_params(ims)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(tviz.apply_stretch(ims[0], lo, hi, 2.2),
                                  jviz.apply_stretch(ims[0], lo, hi, 2.2))
    for wb, gamma in ((True, 1.0), (False, 1.8)):
        np.testing.assert_array_equal(
            tviz.emit_rgb_from_cube(cube, wl, white_balance=wb, gamma=gamma),
            jviz.emit_rgb_from_cube(cube, wl, white_balance=wb, gamma=gamma))


@pytest.fixture
def rasters(tmp_path, rng):
    """An S2-like u16 RGB GeoTIFF with a 0 nodata, an EMIT-like tile with
    wavelength descriptions, a float ENVI cube with wavelengths."""
    utm = CRS.utm(33, True)
    g10 = Grid(utm, 500000.0, 5800000.0, 10.0, 10.0, 48, 42)
    g60 = Grid(utm, 500000.0, 5800000.0, 60.0, 60.0, 8, 7)
    s2 = (rng.random((3, 42, 48)) * 8000 + 200).astype(np.uint16)
    s2[:, :4, :5] = 0
    s2p = tmp_path / "s2.tif"
    write_geotiff(s2p, s2, g10, nodata=0,
                  descriptions=["B02_blue", "B03_green", "B04_red"])
    emit = (rng.random((6, 7, 8)) * 5000).astype(np.uint16)
    ep = tmp_path / "emit_tile.tif"
    write_geotiff(ep, emit, g60, nodata=65535,
                  descriptions=[f"{w:.1f} nm" for w in
                                (450, 490, 560, 665, 850, 1600)])
    cubef = rng.random((7, 8, 12)).astype(np.float32)
    cubef[0, 0] = -9999.0
    _, hdr = envi.write_cube(tmp_path / "cube", cubef, g60, nodata=-9999.0,
                             wavelengths=np.linspace(400, 2400, 12))
    return {"s2": s2p, "emit": ep, "hdr": hdr}


def test_file_helpers_match(rasters, capsys):
    """load_s2_rgb_u8 (u16 stretched without the nodata), the cv2 area
    resize and print_raster_geometry: the same arrays, records and
    printed lines."""
    for bands in ((0, 1, 2), (2, 1, 0)):
        np.testing.assert_array_equal(
            tviz.load_s2_rgb_u8(rasters["s2"], bands),
            jviz.load_s2_rgb_u8(rasters["s2"], bands))
    rgb = tviz.load_s2_rgb_u8(rasters["s2"])
    np.testing.assert_array_equal(tviz.resize_s2_rgb_to(rgb, (7, 8)),
                                  jviz.resize_s2_rgb_to(rgb, (7, 8)))
    got = tviz.print_raster_geometry(rasters["s2"])
    t_out = capsys.readouterr().out
    assert got == jviz.print_raster_geometry(rasters["s2"])
    assert t_out == capsys.readouterr().out


def test_plots_match(rasters, tmp_path, rng):
    """The matplotlib panels: the same returned arrays and an image file
    from each (show_emit_rgb_from_envi, plot_s2_truecolor,
    show_side_by_side, plot_tile_pair_simple, plot_scl_map)."""
    pytest.importorskip("matplotlib")
    np.testing.assert_array_equal(
        tviz.show_emit_rgb_from_envi(rasters["hdr"], tmp_path / "t1.png"),
        jviz.show_emit_rgb_from_envi(rasters["hdr"], tmp_path / "j1.png"))
    np.testing.assert_array_equal(
        tviz.plot_s2_truecolor(rasters["s2"], tmp_path / "t2.png"),
        jviz.plot_s2_truecolor(rasters["s2"], tmp_path / "j2.png"))
    a, b = rng.random((6, 6, 3)), rng.random((6, 6, 3))
    tviz.show_side_by_side(a, b, "a", "b", save_path=tmp_path / "t3.png")
    tviz.plot_tile_pair_simple(rasters["emit"], rasters["s2"],
                               save_path=tmp_path / "t4.png")
    scl = rng.integers(0, 12, (20, 20))
    tviz.plot_scl_map(scl, save_path=tmp_path / "t5.png")
    for k in range(1, 6):
        assert (tmp_path / f"t{k}.png").stat().st_size > 0


def test_viewer_payload_and_html_match(cube, tmp_path):
    """prepare_viewer_payload (subsampled, u8-quantized, nodata and good
    bands) and write_interactive_quicklook: the same payload and the same
    HTML text."""
    wl = np.linspace(380.0, 2500.0, 20)
    good = np.ones(20, bool)
    good[7:9] = False
    kw = dict(nodata=-9999.0, good_bands=good, max_size=16, max_bands=9)
    assert (tint.prepare_viewer_payload(cube, wl, **kw)
            == jint.prepare_viewer_payload(cube, wl, **kw))
    pt = tint.write_interactive_quicklook(cube, tmp_path / "t.html", wl,
                                          title="x", **kw)
    pj = jint.write_interactive_quicklook(cube, tmp_path / "j.html", wl,
                                          title="x", **kw)
    assert pt.read_text() == pj.read_text()
    with pytest.raises(ValueError, match="need \\(H, W, B\\) cube"):
        tint.prepare_viewer_payload(cube[..., 0])


def test_quicklook_from_product_matches(rasters, tmp_path):
    """quicklook_from_product on an ENVI header, a GeoTIFF stack and a
    granule (.nc): the same HTML as the original's."""
    from hyperres_torch.testing.scenes import make_scene

    sc = make_scene(tmp_path / "sc", raw_shape=(24, 20), n_bands=10,
                    s2_size=120)
    for k, src in enumerate((rasters["hdr"], rasters["emit"],
                             sc.emit_nc_path)):
        pt = tint.quicklook_from_product(src, tmp_path / f"t{k}.html",
                                         max_size=12, max_bands=6)
        pj = jint.quicklook_from_product(src, tmp_path / f"j{k}.html",
                                         max_size=12, max_bands=6)
        assert pt.read_text() == pj.read_text()

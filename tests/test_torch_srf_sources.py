"""The port's SRF sources (``hyperres_torch.spectral``: tables, resolver,
cache, the xlsx codec) and its scene-level synthesis API
(``spectral.synth``) against the reference's, on files the tests write
themselves into temporary directories (no measured workbook is in the
repository and nothing is downloaded). The copies are held to exact
equality (``array_equal``); what runs on the device (``device="cpu"``
here) to the tolerances of tests/test_torch_resample.py."""

import inspect
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres import spectral as jspec  # noqa: E402
from hyperres.io import xlsx as jxlsx  # noqa: E402
from hyperres.spectral import srf_cache as jcache  # noqa: E402
from hyperres.spectral import srf_tables as jtables  # noqa: E402
from hyperres.spectral import synth as jsynth  # noqa: E402
from hyperres_torch import spectral as tspec  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.io import envi  # noqa: E402
from hyperres_torch.io import xlsx as txlsx  # noqa: E402
from hyperres_torch.io.tiff import TiffReader, write_geotiff  # noqa: E402
from hyperres_torch.spectral import srf_cache as tcache  # noqa: E402
from hyperres_torch.spectral import srf_tables as ttables  # noqa: E402
from hyperres_torch.spectral import synth as tsynth  # noqa: E402

BANDS3 = ["B2", "B3", "B4"]
SHEET = "Spectral Responses (S2A)"


def _same_srf(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_array_equal(a[k][1], b[k][1])


def _sheet(srf, platform="S2A"):
    """An SRF dict on one shared 1 nm axis, as the workbook lays it out:
    (header, matrix) with NaN outside each band's support."""
    lo = min(float(wl[0]) for wl, _ in srf.values())
    hi = max(float(wl[-1]) for wl, _ in srf.values())
    axis = np.arange(np.floor(lo), np.ceil(hi) + 1.0)
    header, cols = ["SR_WL"], [axis]
    for band, (wl, resp) in srf.items():
        on = np.interp(axis, wl, resp, left=np.nan, right=np.nan)
        header.append(f"{platform}_SR_AV_{band}")
        cols.append(on)
    return header, np.column_stack(cols)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty user cache of its own, no forced source."""
    monkeypatch.setenv("HYPERRES_SRF_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("HYPERRES_SRF_SOURCE", raising=False)
    return tmp_path / "cache"


def test_tables_are_copies():
    """The band tables, the box table and ``band_resolution_m``."""
    assert ttables.S2A_BAND_TABLE == jtables.S2A_BAND_TABLE
    assert ttables.S2B_BAND_TABLE == jtables.S2B_BAND_TABLE
    assert ttables.S2_BOX_TABLE == jtables.S2_BOX_TABLE
    for plat in ("S2A", "S2B"):
        _same_srf(ttables.builtin_srf(plat), jtables.builtin_srf(plat))
        for b in ttables.S2A_BAND_TABLE:
            assert (ttables.band_resolution_m(b, plat)
                    == jtables.band_resolution_m(b, plat))
    with pytest.raises(ValueError, match="platform"):
        ttables.band_resolution_m("B2", "S2C")
    assert sorted(tspec.__all__) == sorted(jspec.__all__)
    assert tcache.COPERNICUS_SRF_URL == jcache.COPERNICUS_SRF_URL
    # copied, never called here: it needs the network
    assert (inspect.signature(tcache.fetch_srf_workbook)
            == inspect.signature(jcache.fetch_srf_workbook))


def test_npz_round_trip(tmp_path):
    """``save_srf_npz`` / ``load_srf_npz``: each package reads the
    other's file, array for array."""
    srf = ttables.builtin_srf("S2B")
    pt = tcache.save_srf_npz(srf, tmp_path / "t" / "srf_s2b.npz", "unit")
    pj = jcache.save_srf_npz(srf, tmp_path / "j" / "srf_s2b.npz", "unit")
    for loader in (tcache.load_srf_npz, jcache.load_srf_npz):
        for p in (pt, pj):
            back = loader(p)
            assert set(back) == set(srf)
            _same_srf({k: back[k] for k in srf}, srf)
    _same_srf(tcache.load_srf_npz(pj, bands=BANDS3),
              {k: srf[k] for k in BANDS3})
    with pytest.raises(KeyError, match="NOPE"):
        tcache.load_srf_npz(pt, bands=["NOPE"])


def test_csv_loader_matches_reference(tmp_path):
    """A CSV export of the sheet: the same tables from both loaders;
    a missing column raises as in the reference."""
    header, data = _sheet(ttables.builtin_srf("S2A"))
    p = tmp_path / "sheet.csv"
    with open(p, "w") as f:
        f.write(",".join(header) + "\n")
        for row in data:
            f.write(",".join("" if np.isnan(v) else f"{v:.10g}"
                             for v in row) + "\n")
    got = tcache.load_srf_from_csv(p, "S2A")
    _same_srf(got, jcache.load_srf_from_csv(p, "S2A"))
    assert all((r > 0).all() for _, r in got.values())
    with pytest.raises(KeyError, match="S2B_SR_AV_B2"):
        tcache.load_srf_from_csv(p, "S2B", bands=["B2"])
    with pytest.raises(ValueError, match="WL_NM"):
        tcache.load_srf_from_csv(p, "S2A", wavelength_col="WL_NM")


def test_xlsx_codec_round_trip(tmp_path):
    """The xlsx copy: a workbook written by either package reads the
    same in both (sheet names, header, values, NaN for blanks)."""
    header, data = _sheet(ttables.builtin_srf("S2A", bands=BANDS3))
    sheets = {"Notes": (["a"], np.array([[1.0]])), SHEET: (header, data)}
    pt = txlsx.write_xlsx(tmp_path / "t.xlsx", sheets)
    pj = jxlsx.write_xlsx(tmp_path / "j.xlsx", sheets)
    for p in (pt, pj):
        assert txlsx.sheet_names(p) == jxlsx.sheet_names(p) == list(sheets)
        th, td = txlsx.read_table(p, SHEET)
        jh, jd = jxlsx.read_table(p, SHEET)
        assert th == jh == header
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(td, data)
        assert txlsx.read_sheet(p) == jxlsx.read_sheet(p)
    with pytest.raises(KeyError, match="Nope"):
        txlsx.read_sheet(pt, "Nope")


def test_xlsx_loader_matches_reference(tmp_path):
    """``load_srf_from_xlsx`` on a workbook-shaped fixture: the tables
    of the reference's loader; its errors for a missing sheet, column
    and band."""
    srf = ttables.builtin_srf("S2A")
    p = txlsx.write_xlsx(tmp_path / "srf.xlsx", {SHEET: _sheet(srf)})
    got = ttables.load_srf_from_xlsx(p, "S2A")
    _same_srf(got, jtables.load_srf_from_xlsx(p, "S2A"))
    for b in srf:
        assert got[b][0][0] >= srf[b][0][0] - 1 and (got[b][1] > 0).all()
    with pytest.raises(ValueError, match="S2B"):
        ttables.load_srf_from_xlsx(p, "S2B")
    with pytest.raises(ValueError, match="WL_NM"):
        ttables.load_srf_from_xlsx(p, "S2A", wavelength_col="WL_NM")
    with pytest.raises(KeyError, match="B99"):
        ttables.load_srf_from_xlsx(p, "S2A", bands=["B99"])


def _workbook_with_text_cells(path):
    """A one-sheet workbook whose B2 responses are stored as text
    (shared and inline strings), as a hand-edited workbook may hold
    them."""
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    rows = ['<row r="1"><c r="A1" t="inlineStr"><is><t>SR_WL</t></is></c>'
            '<c r="B1" t="inlineStr"><is><t>S2A_SR_AV_B2</t></is></c></row>']
    cells = [("s", "0"), ("inlineStr", "0.5"), ("str", " 0.75 "),
             ("s", "1"), ("n", "0.125")]
    for i, (t, v) in enumerate(cells, start=2):
        val = (f'<is><t>{v}</t></is>' if t == "inlineStr" else f"<v>{v}</v>")
        rows.append(f'<row r="{i}"><c r="A{i}"><v>{450 + i}</v></c>'
                    f'<c r="B{i}" t="{t}">{val}</c></row>')
    sheet = (f'<?xml version="1.0"?><worksheet {ns}><sheetData>'
             + "".join(rows) + "</sheetData></worksheet>")
    shared = (f'<?xml version="1.0"?><sst {ns}><si><t>0.25</t></si>'
              "<si><t>n/a</t></si></sst>")
    txlsx.write_xlsx(path, {SHEET: (["x"], np.zeros((1, 1)))})
    with zipfile.ZipFile(path) as zf:
        parts = {n: zf.read(n) for n in zf.namelist()}
    parts["xl/worksheets/sheet1.xml"] = sheet.encode()
    parts["xl/sharedStrings.xml"] = shared.encode()
    with zipfile.ZipFile(path, "w") as zf:
        for n, b in parts.items():
            zf.writestr(n, b)
    return path


def test_xlsx_numeric_strings_are_coerced(tmp_path):
    """A pin of a reference fault that the port does not copy: cells
    that hold a number as text. The port's ``read_table`` coerces them
    as pandas' ``to_numeric`` would (text that is no number stays NaN);
    the reference's drops every string cell to NaN
    (``hyperres/io/xlsx.py:158``), so its loader loses those samples."""
    p = _workbook_with_text_cells(tmp_path / "text.xlsx")
    _, td = txlsx.read_table(p, SHEET)
    _, jd = jxlsx.read_table(p, SHEET)
    np.testing.assert_array_equal(td[:, 0], jd[:, 0])
    np.testing.assert_array_equal(
        td[:, 1], [0.25, 0.5, 0.75, np.nan, 0.125])
    np.testing.assert_array_equal(
        jd[:, 1], [np.nan, np.nan, np.nan, np.nan, 0.125])
    got = ttables.load_srf_from_xlsx(p, "S2A", bands=["B2"])["B2"]
    ref = jtables.load_srf_from_xlsx(p, "S2A", bands=["B2"])["B2"]
    np.testing.assert_array_equal(got[0], [452.0, 453.0, 454.0, 456.0])
    np.testing.assert_array_equal(got[1], [0.25, 0.5, 0.75, 0.125])
    np.testing.assert_array_equal(ref[0], [456.0])


def test_resolver_order(cache, tmp_path):
    """``load_srf`` / ``describe_srf_source``: an explicit workbook, then
    the measured cache, then the parametric model;
    ``HYPERRES_SRF_SOURCE=parametric`` forces the last. With one
    ``HYPERRES_SRF_CACHE`` both packages resolve the same table, whichever
    package imported it."""
    param = ttables.builtin_srf("S2A", bands=BANDS3)
    assert ttables.describe_srf_source("S2A") == "parametric"
    assert tcache.measured_srf("S2A") is None
    _same_srf(ttables.load_srf("S2A", bands=BANDS3), param)
    assert tcache.user_cache_dir() == jcache.user_cache_dir() == cache

    measured = {b: (wl, 0.5 * r) for b, (wl, r) in
                ttables.builtin_srf("S2A").items()}
    book = txlsx.write_xlsx(tmp_path / "m.xlsx", {SHEET: _sheet(measured)})
    saved = tcache.import_srf_tables(book, platform="S2A", dest="user")
    assert saved == cache / "srf_s2a.npz"
    want = ttables.load_srf_from_xlsx(book, "S2A", bands=BANDS3)
    for resolve in (ttables.load_srf, jtables.load_srf):
        _same_srf(resolve("S2A", bands=BANDS3), want)
    src = f"measured-cache:{saved}"
    assert (ttables.describe_srf_source("S2A")
            == jtables.describe_srf_source("S2A") == src)
    assert ttables.describe_srf_source("S2B") == "parametric"

    # an explicit workbook wins over the cache; a missing one does not
    other = {b: (wl, 0.25 * r) for b, (wl, r) in measured.items()}
    book2 = txlsx.write_xlsx(tmp_path / "o.xlsx", {SHEET: _sheet(other)})
    _same_srf(ttables.load_srf("S2A", book2, bands=BANDS3),
              ttables.load_srf_from_xlsx(book2, "S2A", bands=BANDS3))
    assert ttables.describe_srf_source("S2A", book2) == f"workbook:{book2}"
    _same_srf(ttables.load_srf("S2A", tmp_path / "none.xlsx", bands=BANDS3),
              want)


def test_import_destinations_and_forced_source(cache, tmp_path, monkeypatch):
    """``import_srf_tables`` from a CSV into an explicit directory and
    the user cache; an unknown suffix is refused; the reference's import
    is found by the port; the forced parametric source hides it."""
    srf = ttables.builtin_srf("S2B")
    header, data = _sheet(srf, "S2B")
    p = tmp_path / "sheet.csv"
    with open(p, "w") as f:
        f.write(",".join(header) + "\n")
        for row in data:
            f.write(",".join("" if np.isnan(v) else f"{v:.10g}"
                             for v in row) + "\n")
    out = tcache.import_srf_tables(p, platform="S2B", dest=tmp_path / "d")
    assert out == tmp_path / "d" / "srf_s2b.npz" and out.exists()
    assert tcache.measured_srf("S2B") is None      # not a resolver root
    with pytest.raises(ValueError, match="Unsupported"):
        tcache.import_srf_tables(tmp_path / "sheet.txt")
    jcache.import_srf_tables(p, platform="S2B", dest="user")
    _same_srf(tcache.measured_srf("S2B", bands=BANDS3),
              tcache.load_srf_from_csv(p, "S2B", bands=BANDS3))
    monkeypatch.setenv("HYPERRES_SRF_SOURCE", "parametric")
    assert tcache.measured_srf("S2B") is None
    assert ttables.describe_srf_source("S2B") == "parametric"
    _same_srf(ttables.load_srf("S2B", bands=BANDS3),
              ttables.builtin_srf("S2B", bands=BANDS3))


def test_parametric_warning(cache, tmp_path):
    """``warn_if_parametric_srf`` warns (and returns "parametric") only
    while no measured table resolves; the fused plan calls it when built
    without ``srf=``."""
    from hyperres_torch.fusion.fused import FusedFusionPlan
    from hyperres_torch.testing.bench_scene import generate_scene

    with pytest.warns(UserWarning, match="PARAMETRIC"):
        assert ttables.warn_if_parametric_srf("S2A", "test") == "parametric"
    sc = generate_scene(0.02, 0)
    args = (sc["utm60"], sc["s2_grid"], sc["wavelengths"], sc["good_mask"])
    with pytest.warns(UserWarning, match="fusion: using the built-in"):
        p1 = FusedFusionPlan(*args, device="cpu")
    measured = {b: (wl, 0.5 * r) for b, (wl, r) in
                ttables.builtin_srf("S2A").items()}
    tcache.save_srf_npz(measured, cache / "srf_s2a.npz")
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*PARAMETRIC.*")
        assert ttables.warn_if_parametric_srf("S2A").startswith(
            "measured-cache:")
        p2 = FusedFusionPlan(*args, device="cpu")
    # a response scaled by a constant normalises to the same weights
    torch.testing.assert_close(p1._Wsrf, p2._Wsrf, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# spectral.synth
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rasters(tmp_path_factory):
    """Two overlapping UTM GeoTIFFs with tags and descriptions, and an
    ENVI cube with wavelengths (the port's writers; both packages
    read them)."""
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.testing.bench_scene import emit_wavelength_grid

    d = tmp_path_factory.mktemp("synth")
    rng = np.random.default_rng(4)
    utm = CRS.utm(33, True)
    s2g = Grid(utm, 500000.0, 5800000.0, 10.0, 10.0, 240, 200)
    emg = Grid(utm, 500600.0, 5799400.0, 60.0, 60.0, 50, 40)
    s2 = rng.integers(1, 9000, (4, 200, 240)).astype(np.uint16)
    s2[:, :7, :9] = 65535
    em = rng.random((3, 40, 50)).astype(np.float32)
    write_geotiff(d / "s2.tif", s2, s2g, nodata=65535,
                  descriptions=["B02", "B03", "B04", "B08"],
                  tags={"SCALE": "10000"},
                  band_tags=[{"k": str(i)} for i in range(4)])
    write_geotiff(d / "emit.tif", em, emg, nodata=-9999.0,
                  descriptions=["r", "g", "b"])
    wl, good = emit_wavelength_grid(285)
    cube = rng.random((20, 24, 285)).astype(np.float32)
    envi.write_cube(d / "cube", cube, emg.window_grid(
        emg.window_of(emg.bounds)), interleave="bil", nodata=-9999.0,
        extra_header={"wavelength": [float(x) for x in wl],
                      "wavelength units": "nanometers"})
    return dict(dir=d, s2g=s2g, emg=emg, s2=s2, em=em, wl=wl, good=good,
                cube=cube)


def test_crop_to_overlap_matches_reference(rasters, tmp_path):
    """Both rasters cropped to their common extent: the reference's
    pixels, grids, nodata, tags and descriptions; a CRS mismatch and
    disjoint extents raise."""
    d = rasters["dir"]
    outs = {}
    for name, fn in (("t", tsynth.crop_to_overlap),
                     ("j", jsynth.crop_to_overlap)):
        outs[name] = fn(d / "s2.tif", d / "emit.tif",
                        tmp_path / f"{name}_s2.tif",
                        tmp_path / f"{name}_emit.tif")
    for a, b in zip(outs["t"], outs["j"]):
        with TiffReader(a) as ra, TiffReader(b) as rb:
            np.testing.assert_array_equal(ra.read(), rb.read())
            assert ra.grid.geotransform == rb.grid.geotransform
            assert ra.grid.shape == rb.grid.shape
            assert ra.nodata == rb.nodata
            assert ra.descriptions == rb.descriptions
            assert ra.dataset_tags == rb.dataset_tags
            assert ra.band_tags == rb.band_tags
    with TiffReader(outs["t"][0]) as r:
        assert r.grid.shape == (140, 180) and r.dataset_tags["SCALE"] == "10000"
    from hyperres_torch.core.crs import CRS
    far = Grid(CRS.utm(33, True), 900000.0, 5800000.0, 10.0, 10.0, 8, 8)
    write_geotiff(tmp_path / "far.tif", np.zeros((1, 8, 8), np.float32), far)
    with pytest.raises(ValueError, match="No overlap"):
        tsynth.crop_to_overlap(tmp_path / "far.tif", d / "emit.tif",
                               tmp_path / "a.tif", tmp_path / "b.tif")
    geo = Grid(CRS.geographic(), 15.0, 52.0, 1e-4, 1e-4, 8, 8)
    write_geotiff(tmp_path / "geo.tif", np.zeros((1, 8, 8), np.float32), geo)
    with pytest.raises(ValueError, match="CRS mismatch"):
        tsynth.crop_to_overlap(tmp_path / "geo.tif", d / "emit.tif",
                               tmp_path / "a.tif", tmp_path / "b.tif")


def test_grid_transfers_match_reference(rasters, tmp_path):
    """``downsample_s2_to_grid`` (1-based bands, the file's nodata, the
    scale; onto a grid and onto a raster's grid), ``reproject_stack_to_grid``
    and ``make_grid_template_from_raster``: 2e-6 of the reference's (an
    exact 6x block mean of values < 1), NaN fill alike."""
    from hyperres.core.crs import CRS as JCRS
    from hyperres.core.grid import Grid as JGrid

    d, emg = rasters["dir"], rasters["emg"]
    jemg = JGrid(JCRS.utm(33, True), emg.x0, emg.y0, emg.dx, emg.dy,
                 emg.width, emg.height)
    kw = dict(band_indexes=[3, 1], src_scale=1e-4)
    want = jsynth.downsample_s2_to_grid(d / "s2.tif", jemg, **kw)
    got = tsynth.downsample_s2_to_grid(d / "s2.tif", emg, device="cpu", **kw)
    assert got.shape == (2, 40, 50) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert 0 < np.isnan(got).sum() < got.size
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, equal_nan=True)
    via_file = tsynth.downsample_s2_to_grid(d / "s2.tif", d / "emit.tif",
                                            device="cpu", **kw)
    np.testing.assert_array_equal(via_file, got)
    via_envi = tsynth.downsample_s2_to_grid(
        d / "s2.tif", d / "cube.hdr", [1], resampling="bilinear",
        device="cpu")
    assert via_envi.shape == (1, 20, 24)
    want = jsynth.reproject_stack_to_grid(rasters["em"], jemg, d / "s2.tif")
    got = tsynth.reproject_stack_to_grid(rasters["em"], emg, d / "s2.tif",
                                         device="cpu")
    assert got.shape == (3, 200, 240)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, equal_nan=True)
    p = tsynth.make_grid_template_from_raster(d / "s2.tif",
                                              tmp_path / "tpl.tif")
    with TiffReader(p) as r:
        assert r.grid.geotransform == rasters["s2g"].geotransform
        assert r.read().shape == (1, 200, 240) and not r.read().any()


def test_pseudo_s2_from_envi_matches_reference(rasters, cache, tmp_path):
    """``pseudo_s2_from_envi``: the reference's bands to 2e-6 and grid,
    with the parametric model and with a workbook's tables; a header
    without wavelengths raises."""
    hdr = rasters["dir"] / "cube.hdr"
    want, jgrid = jsynth.pseudo_s2_from_envi(hdr, good_mask=rasters["good"],
                                             bands=BANDS3)
    got, grid = tsynth.pseudo_s2_from_envi(hdr, good_mask=rasters["good"],
                                           bands=BANDS3, device="cpu")
    assert list(got) == BANDS3 and grid.geotransform == jgrid.geotransform
    for b in BANDS3:
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=2e-6)
    rgb = tspec.pseudo_s2_rgb(got)
    assert rgb.shape == (20, 24, 3)
    narrow = {b: (wl, r ** 4) for b, (wl, r) in
              ttables.builtin_srf("S2A").items()}
    book = txlsx.write_xlsx(tmp_path / "n.xlsx", {SHEET: _sheet(narrow)})
    got2, _ = tsynth.pseudo_s2_from_envi(hdr, srf_xlsx=book, bands=BANDS3,
                                         device="cpu")
    want2, _ = jsynth.pseudo_s2_from_envi(hdr, srf_xlsx=book, bands=BANDS3)
    for b in BANDS3:
        np.testing.assert_allclose(got2[b], want2[b], rtol=0, atol=2e-6)
    assert np.abs(got2["B2"] - got["B2"]).max() > 1e-4
    envi.write_cube(tmp_path / "nowl", rasters["cube"][..., :3],
                    rasters["emg"], interleave="bil")
    with pytest.raises(ValueError, match="no wavelengths"):
        tsynth.pseudo_s2_from_envi(tmp_path / "nowl.hdr", device="cpu")

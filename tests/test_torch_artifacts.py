"""The port's host copies for the pairs pipeline against the JAX
package's originals, on the CPU: ``core/cube.py``, ``artifacts/``
(run layout, report, metadata JSON, the manifest CSV, the archive copy),
``fusion.ridge_sr.flatten_pixels`` and ``catalog/s2_stack.py`` (the
stack's 20 m bands upsampled on ``device="cpu"``).

Tolerances: the copies are verbatim, so their outputs are equal, with
paths and timestamps normalised where the two runs write into different
directories at different times. The manifest is written without pandas
in the port: its text is equal to pandas' for the same rows. The S2
stacks are equal rasters: the 20 m bands' bilinear upsample sums the
same two products in f32 in both packages and is rounded to u16
(``np.rint``)."""

import json
import re
import shutil
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import hyperres.artifacts as jart  # noqa: E402
from hyperres.catalog import s2_stack as js2  # noqa: E402
from hyperres.core import cube as jcube  # noqa: E402
from hyperres.core.crs import CRS as JCRS  # noqa: E402
from hyperres.core.grid import Grid as JGrid  # noqa: E402
from hyperres.fusion.ridge_sr import flatten_pixels as j_flatten  # noqa: E402
import hyperres_torch.artifacts as tart  # noqa: E402
from hyperres_torch.catalog import s2_stack as ts2  # noqa: E402
from hyperres_torch.core import cube as tcube  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.fusion.ridge_sr import flatten_pixels  # noqa: E402
from hyperres_torch.io.tiff import TiffReader, write_geotiff  # noqa: E402

STAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")


# ---------------------------------------------------------------------------
# core/cube.py, flatten_pixels
# ---------------------------------------------------------------------------

def test_subsample_bands_evenly_equal():
    """Every (total, keep) up to 300 bands (collisions and the
    midpoint fill-in included): equal index arrays."""
    for total in (1, 2, 5, 31, 32, 33, 48, 64, 285, 300):
        for keep in (1, 2, 3, 16, 31, 32, 33, 64, 285):
            got = tcube.subsample_bands_evenly(total, keep)
            want = jcube.subsample_bands_evenly(total, keep)
            np.testing.assert_array_equal(got, want)


def test_raster_and_spectral_cube_equal(rng):
    """``Raster`` / ``SpectralCube`` on the same data: the same masks,
    nearest bands, raster conversion and replaced data."""
    data = rng.random((4, 6, 5)).astype(np.float32)
    data[0, 1, 1] = np.nan
    data[:, 2, 3] = -9999.0
    args = (CRS.utm(33, True), 0.0, 600.0, 60.0, 60.0, 5, 6)
    t = tcube.Raster(data, Grid(*args), nodata=-9999.0)
    j = jcube.Raster(data, JGrid(JCRS.utm(33, True), *args[1:]),
                     nodata=-9999.0)
    assert t.count == j.count == 4
    np.testing.assert_array_equal(t.valid_mask(), j.valid_mask())
    hwb = np.moveaxis(data, 0, -1)
    wl = np.array([450.0, 550.0, 650.0, 850.0])
    tc = tcube.SpectralCube(hwb, Grid(*args), wl)
    jc = jcube.SpectralCube(hwb, JGrid(JCRS.utm(33, True), *args[1:]), wl)
    assert (tc.n_bands, tc.shape) == (jc.n_bands, jc.shape)
    for nm in (400.0, 600.0, 842.0, 2000.0):
        assert tc.band_nearest(nm) == jc.band_nearest(nm)
    np.testing.assert_array_equal(tc.valid_mask(), jc.valid_mask())
    tr, jr = tc.to_raster(), jc.to_raster()
    np.testing.assert_array_equal(tr.data, jr.data)
    assert (tr.band_names, tr.nodata, tr.tags) == (jr.band_names,
                                                    jr.nodata, jr.tags)
    assert tc.with_data(hwb * 2).data[0, 0, 0] == jc.with_data(
        hwb * 2).data[0, 0, 0]


def test_flatten_pixels_bit_equal(rng):
    """The training set of the SR step: the same rows, bit for bit, with
    NaNs and nodata on either side."""
    X = rng.random((10, 30, 40)).astype(np.float32)
    Y = rng.random((32, 30, 40)).astype(np.float32)
    X[3, 4, 5] = np.nan
    Y[:, 7, 8] = -9999.0
    X[:, 9, 9] = 6.5535
    for kw in ({}, {"y_nodata": -9999.0},
               {"x_nodata": 6.5535, "y_nodata": -9999.0}):
        for a, b in zip(flatten_pixels(X, Y, **kw), j_flatten(X, Y, **kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def _rel(obj, root):
    """``obj`` with ``root`` removed from every path string and the
    timestamps blanked."""
    text = json.dumps(obj, default=str).replace(str(root), "<root>")
    return json.loads(STAMP.sub("<stamp>", text))


def test_run_paths_layout(tmp_path):
    """``RunPaths.build`` with and without an archive tree: the same
    run id and layout, relative to each package's root."""
    for drive in (None, "drive"):
        out = {}
        for d, mod in (("port", tart), ("jax", jart)):
            kw = {"drive_base": tmp_path / d / drive} if drive else {}
            rp = mod.RunPaths.build(
                emit_nc="/x/EMIT_L2A_RFL_001_20230819T110126_2323107_008.nc",
                local_root=tmp_path / d / "local", **kw)
            out[d] = _rel({k: str(v) for k, v in asdict(rp).items()},
                          tmp_path / d)
        assert out["port"] == out["jax"]
        assert out["port"]["run_id"] == "001_20230819T110126_2323107_008"
    assert sorted(p.name for p in (tmp_path / "port" / "local").iterdir()) \
        == sorted(p.name for p in (tmp_path / "jax" / "local").iterdir())


def test_report_writer_equal(tmp_path):
    """The same report text (timestamps aside), in overwrite and append
    modes, with ``None`` lines skipped and raw text."""
    texts = []
    for mod, name in ((tart, "port.md"), (jart, "jax.md")):
        rw = mod.ReportWriter(tmp_path / name).start(title="T")
        rw.section("A", ["one", None, "two"])
        rw.raw("raw text\n")
        mod.ReportWriter(tmp_path / name, mode="append").start().section(
            "B", ["three"])
        texts.append(STAMP.sub("<stamp>", (tmp_path / name).read_text()))
    assert texts[0] == texts[1]
    assert STAMP.fullmatch(tart.report.utc_now_iso())


def _tile_tifs(root):
    """A 60 m EMIT tile and a 10 m S2 tile as GeoTIFFs under ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    utm = CRS.utm(33, True)
    e = root / "tile_000_emit.tif"
    s = root / "tile_000_s2.tif"
    write_geotiff(e, np.ones((3, 4, 4), np.uint16),
                  Grid(utm, 399960.0, 5800020.0, 60.0, 60.0, 4, 4),
                  nodata=65535)
    write_geotiff(s, np.ones((2, 24, 24), np.uint16),
                  Grid(utm, 399960.0, 5800020.0, 10.0, 10.0, 24, 24),
                  nodata=0)
    return e, s


def test_tile_metadata_and_manifest_equal(tmp_path):
    """``tif_geo_summary``, ``write_tile_metadata`` (JSON and manifest
    row) and ``write_manifest_csv``: equal with paths and timestamps
    normalised; the manifest text equal to pandas' (the port writes it
    without pandas)."""
    docs, csvs = [], []
    for d, mod in (("port", tart), ("jax", jart)):
        e, s = _tile_tifs(tmp_path / d / "tiles")
        recs = []
        for i in range(3):
            rec = mod.TileRecord(
                idx=i, emit_tif=str(e), s2_tif=str(s),
                emit_black_frac=0.0 if i else 0.015625,
                s2_black_frac=1 / 3, emit_geo=mod.tif_geo_summary(e),
                s2_geo=mod.tif_geo_summary(s),
                emit_window={"col_off": 4 * i, "row_off": 0, "width": 4,
                             "height": 4},
                emit_b32_tif=str(e) if i != 1 else None,
                emit_b32_indices_0based=[0, 2])
            path, row = mod.write_tile_metadata(
                rec, {"idx": str(i), "note": "a, b"},
                tmp_path / d / "meta", emit_granule="EMIT_x",
                params={"scale": 6})
            recs.append(rec)
            docs.append(_rel([json.loads(path.read_text()), row],
                             tmp_path / d))
        mod.write_manifest_csv(tmp_path / d / "manifest.csv", recs)
        mod.write_manifest_csv(tmp_path / d / "empty.csv", [])
        csvs.append([(tmp_path / d / n).read_text().replace(
            str(tmp_path / d), "<root>") for n in ("manifest.csv",
                                                   "empty.csv")])
    assert docs[:3] == docs[3:]
    assert csvs[0] == csvs[1]


def test_manifest_csv_formats_as_pandas(tmp_path):
    """Rows of mixed cell types (ints, floats, None, lists, dicts,
    strings with commas, quotes and newlines, bools, columns that only
    some rows have): the port's text equals pandas'."""
    rows = [{"a": 1, "b": None, "c": 0.1, "d": [1.0, 2.5],
             "e": {"lon": 1.0}, "f": "x,y", "g": None, "h": 1, "i": True,
             "j": 'say "hi"'},
            {"a": 2, "b": None, "c": 1 / 3, "d": [1e-20, 2], "e": None,
             "f": "z", "g": 0.5, "h": None, "i": False, "j": "a\nb",
             "k": 7}]
    tart.write_manifest_csv(tmp_path / "port.csv", rows)
    jart.write_manifest_csv(tmp_path / "jax.csv", rows)
    assert (tmp_path / "port.csv").read_text() == (
        tmp_path / "jax.csv").read_text()


def test_emit_s2_metadata_and_archive_map_equal(tmp_path):
    """The EMIT (UMM) and S2 (STAC) summaries, their report sections and
    the archive map: the same JSON files and report text."""
    umm = {"GranuleUR": "EMIT_L2A_RFL_001_x", "CloudCover": 12,
           "TemporalExtent": {"RangeDateTime": {
               "BeginningDateTime": "2023-08-19T11:01:26Z",
               "EndingDateTime": "2023-08-19T11:01:38Z"}},
           "SpatialExtent": {"HorizontalSpatialDomain": {"Geometry": {
               "GPolygons": [{"Boundary": {"Points": [
                   {"Longitude": 13.1, "Latitude": 52.0},
                   {"Longitude": 13.9, "Latitude": 52.6},
                   {"Longitude": 13.2, "Latitude": 52.4}]}}]}}},
           "AdditionalAttributes": [{"Name": "ORBIT", "Values": ["2323107"]},
                                    {"Name": "SCENE", "Values": ["008"]}],
           "DataGranule": {"ArchiveAndDistributionInformation": [
               {"Name": "a.nc", "SizeInBytes": 10, "Format": "netCDF-4",
                "Checksum": {"Value": "ab"}}]},
           "RelatedUrls": [{"URL": "https://x/a.nc", "Type": "GET DATA"},
                           {"URL": "https://x/b", "Type": "VIEW"}]}
    item = {"meta": {"native-id": "n1", "concept-id": "c1"}, "umm": umm,
            "size": 1.5}
    s2 = {"id": "S2A_33UVU", "bbox": [13.0, 52.0, 14.0, 53.0],
          "geometry": {"type": "Polygon"},
          "properties": {"datetime": "2023-08-19T10:00:00Z",
                         "platform": "sentinel-2a", "eo:cloud_cover": 3.5,
                         "proj:code": "EPSG:32633"},
          "assets": {"B04": {"href": "s3://b04.tif", "type": "image/tiff"},
                     "junk": 1}}
    out = []
    for d, mod in (("port", tart), ("jax", jart)):
        rw = mod.ReportWriter(tmp_path / d / "report.md").start()
        a = mod.write_emit_metadata(item, tmp_path / d / "meta", report=rw)
        b = mod.write_s2_metadata(s2, tmp_path / d / "meta", report=rw)
        mod.write_archive_map(tmp_path / d / "map.json",
                              {"run": str(tmp_path / d)}, report=rw)
        files = {p.name: json.loads(p.read_text())
                 for p in sorted((tmp_path / d / "meta").iterdir())}
        out.append(_rel([a, b, files,
                         json.loads((tmp_path / d / "map.json").read_text()),
                         (tmp_path / d / "report.md").read_text()],
                        tmp_path / d))
    assert out[0] == out[1]
    assert mod.emit_polygon_bounds_wgs84({}) == (None, None)
    assert tart.emit_polygon_bounds_wgs84({}) == (None, None)


def test_copy_any_equal(tmp_path):
    """``copy_any`` of a tree (merge into an existing one, excludes,
    no overwrite) and of a file, without rsync: the same trees."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("a")
    (src / "skip.log").write_text("x")
    (src / "sub" / "b.txt").write_text("b")
    trees = []
    for d, mod in (("port", tart), ("jax", jart)):
        dst = tmp_path / d
        (dst / "sub").mkdir(parents=True)
        (dst / "sub" / "b.txt").write_text("old")
        mod.copy_any(src, dst, use_rsync=False, exclude=["*.log"])
        mod.copy_any(src / "a.txt", dst / "f" / "a2.txt", use_rsync=False)
        trees.append(sorted((str(p.relative_to(dst)), p.read_text())
                            for p in dst.rglob("*") if p.is_file()))
    assert trees[0] == trees[1]
    assert ("sub/b.txt", "old") in trees[0]
    with pytest.raises(FileNotFoundError):
        tart.copy_any(tmp_path / "missing", tmp_path / "x")


# ---------------------------------------------------------------------------
# catalog/s2_stack.py
# ---------------------------------------------------------------------------

def make_band_files(root, rng):
    """Per-band GeoTIFFs as tests/test_toolkit_s2stack.py:19 writes them:
    10 m blue/green/red/nir, 20 m red edges, nir08 and SWIR."""
    root.mkdir(parents=True, exist_ok=True)
    utm = CRS.utm(33, True)
    g10 = Grid(utm, 399960.0, 5800020.0, 10.0, 10.0, 120, 120)
    g20 = Grid(utm, 399960.0, 5800020.0, 20.0, 20.0, 60, 60)
    paths = {}
    for key in ("blue", "green", "red", "nir"):
        data = (rng.random((1, 120, 120)) * 8000).astype(np.uint16)
        paths[key] = write_geotiff(root / f"{key}.tif", data, g10, nodata=0)
    for key in ("rededge1", "rededge2", "rededge3", "nir08", "swir16",
                "swir22"):
        data = (rng.random((1, 60, 60)) * 8000).astype(np.uint16)
        data[0, :3, :5] = 0
        paths[key] = write_geotiff(root / f"{key}.tif", data, g20, nodata=0)
    return paths, g10


def _same_raster(a, b):
    with TiffReader(a) as ra, TiffReader(b) as rb:
        assert (ra.grid, ra.nodata, ra.descriptions, ra.dtype,
                ra.dataset_tags) == (rb.grid, rb.nodata, rb.descriptions,
                                     rb.dtype, rb.dataset_tags)
        np.testing.assert_array_equal(ra.read(), rb.read())


@pytest.mark.parametrize("bands", [10, 9])
def test_build_s2_spectral_stack_equal(tmp_path, rng, bands):
    """The 10-band stack (nir08 at 20 m) and the 9-band one (nir08 at
    the nir's 10 m, left out): equal rasters; the cache returns the
    existing file; a missing required band raises."""
    paths, _ = make_band_files(tmp_path / "bands", rng)
    if bands == 9:
        with TiffReader(paths["nir"]) as r:
            g = r.grid
        write_geotiff(paths["nir08"],
                      (rng.random((1, 120, 120)) * 8000).astype(np.uint16),
                      g, nodata=0)
    got = ts2.build_s2_spectral_stack(paths, tmp_path / "port.tif",
                                      device="cpu")
    want = js2.build_s2_spectral_stack(paths, tmp_path / "jax.tif")
    _same_raster(got, want)
    with TiffReader(got) as r:
        assert r.count == bands
    assert ts2.build_s2_spectral_stack(paths, got, device="cpu") == got
    with pytest.raises(ValueError, match="Missing required assets"):
        ts2.build_s2_spectral_stack({"blue": paths["blue"]},
                                    tmp_path / "x.tif", device="cpu")


def test_crop_s2_stack_to_te_equal(tmp_path, rng):
    """A crop snapped inward to the stack's lattice, in 32 px chunks:
    equal rasters; an extent inside one pixel raises in both."""
    paths, g10 = make_band_files(tmp_path / "bands", rng)
    stack = ts2.build_s2_spectral_stack(paths, tmp_path / "stack.tif",
                                        device="cpu")
    left, bottom = g10.bounds[:2]
    te = (left + 203.0, bottom + 155.0, left + 797.0, bottom + 751.0)
    got = ts2.crop_s2_stack_to_te(stack, tmp_path / "port.tif", *te,
                                  chunk=32)
    want = js2.crop_s2_stack_to_te(stack, tmp_path / "jax.tif", *te,
                                   chunk=32)
    _same_raster(got, want)
    for mod in (ts2, js2):
        with pytest.raises(ValueError, match="Snapped extent is invalid"):
            mod.crop_s2_stack_to_te(stack, tmp_path / "e.tif", left + 1.0,
                                    bottom + 1.0, left + 2.0, bottom + 2.0)


class FakeStac:
    """``download_asset(item, key, dest)`` copying a local band file."""

    def __init__(self, files):
        self.files = files
        self.calls = []

    def download_asset(self, item, key, dest):
        self.calls.append(key)
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(self.files[key], dest)
        return dest


def test_download_s2_spectral_stack_and_truecolor_equal(tmp_path, rng):
    """The download functions on a fake client that copies local files:
    the same assets fetched, equal stacks and composites, the visual
    asset taken when the item has one."""
    paths, _ = make_band_files(tmp_path / "bands", rng)
    item = {"id": "S2X", "assets": {k: {"href": f"https://x/{k}.tif?sig=1"}
                                    for k in paths}}
    outs = []
    for d, fn, kw in (("port", ts2, {"device": "cpu"}), ("jax", js2, {})):
        stac = FakeStac(paths)
        s = fn.download_s2_spectral_stack(item, tmp_path / d, stac, **kw)
        t = fn.download_s2_truecolor(item, tmp_path / d, stac)
        outs.append((s, t, stac.calls))
    assert outs[0][2] == outs[1][2]
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert a.name == b.name
        _same_raster(a, b)
    vis = dict(item, assets=dict(item["assets"], visual={"href": "v.tif"}))
    stac = FakeStac(dict(paths, visual=paths["red"]))
    out = ts2.download_s2_truecolor(vis, tmp_path / "vis", stac)
    assert stac.calls == ["visual"] and out.exists()
    with pytest.raises(ValueError, match="missing band"):
        ts2.download_s2_truecolor({"id": "y", "assets": {}},
                                  tmp_path / "none", FakeStac(paths))

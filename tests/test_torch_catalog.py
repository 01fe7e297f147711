"""The port's catalog (``hyperres_torch.catalog``: geometry, the CMR /
STAC clients, SCL cloud metrics, pair discovery) and the HTTP range
reader of ``hyperres_torch.io.tiff`` against the JAX package's
originals, on the same inputs (seeded with NumPy).

Tolerance: exact equality everywhere. Both sides run the same host code
(NumPy, JSON, ``requests``): the copies are verbatim, and the one
rewrite, ``LonLatPolygon.contains_points`` (matplotlib's crossing test
in NumPy), makes the same float64 comparisons. The HTTP tests run
against a server on 127.0.0.1 (port 0), with a timeout on every request
and the server shut down in the fixture's teardown; proxies are cleared
so that the requests stay on the loopback interface."""

import dataclasses
import datetime as dt
import json
import shutil
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

pytest.importorskip("torch")

import hyperres.catalog as jcat  # noqa: E402
import hyperres.catalog.clients as jclients  # noqa: E402
from hyperres.core.config import PairSearchConfig as JPairSearchConfig  # noqa: E402
from hyperres.core.crs import CRS as JCRS  # noqa: E402
from hyperres.core.grid import Grid as JGrid  # noqa: E402
from hyperres.io import tiff as jtiff  # noqa: E402

import hyperres_torch.catalog as tcat  # noqa: E402
import hyperres_torch.catalog.clients as tclients  # noqa: E402
from hyperres_torch.core.config import PairSearchConfig as TPairSearchConfig  # noqa: E402
from hyperres_torch.core.crs import CRS as TCRS  # noqa: E402
from hyperres_torch.core.grid import Grid as TGrid  # noqa: E402
from hyperres_torch.io import tiff as ttiff  # noqa: E402


def _grids(kind, x0, y0, dx, dy, w, h):
    """The same grid in both packages: (JAX's, the port's)."""
    jc = JCRS.geographic() if kind == "geo" else JCRS.utm(33, True)
    tc = TCRS.geographic() if kind == "geo" else TCRS.utm(33, True)
    return (JGrid(jc, x0, y0, dx, dy, w, h), TGrid(tc, x0, y0, dx, dy, w, h))


def _ring(p):
    return None if p is None else tuple(p.ring)


# ---------------------------------------------------------- own classes ---

@pytest.mark.parametrize("name", ["LonLatPolygon", "CmrClient", "StacClient",
                                  "CatalogUnavailableError"])
def test_catalog_classes_are_the_ports_own(name):
    """Each copied class is defined in the port (its ``__module__`` under
    ``hyperres_torch``), not re-exported from the JAX package."""
    cls = getattr(tcat, name)
    assert cls.__module__.startswith("hyperres_torch.catalog.")
    assert cls is not getattr(jcat, name)


def test_http_range_source_is_the_ports_own():
    """``HttpRangeSource`` is the port's, and ``TiffReader.open_url``
    returns the port's reader."""
    assert ttiff.HttpRangeSource.__module__ == "hyperres_torch.io.tiff"
    assert ttiff.TiffReader.open_url.__qualname__ == "TiffReader.open_url"


# ------------------------------------------------------------- geometry ---

@pytest.mark.parametrize("bounds", [(0.0, 0.0, 1.0, 1.0),
                                    (13.0, 52.0, 14.0, 53.0),
                                    (-120.5, -33.2, -119.9, -32.7)])
def test_polygon_area_equal(bounds):
    """``area_m2`` (EPSG:6933) of a box, and its bounds and centroid,
    equal JAX's; the square degree at the equator is ~12308.5 km^2."""
    j = jcat.LonLatPolygon.from_bounds(*bounds)
    t = tcat.LonLatPolygon.from_bounds(*bounds)
    assert t.area_m2() == j.area_m2()
    assert t.bounds() == j.bounds() and t.centroid() == j.centroid()
    if bounds == (0.0, 0.0, 1.0, 1.0):
        assert abs(t.area_m2() / 1e6 - 12308.5) < 5.0


CLIP_CASES = {
    "half": ((0.0, 0.0, 1.0, 1.0), (0.5, 0.0, 1.5, 1.0)),
    "disjoint": ((0.0, 0.0, 1.0, 1.0), (5.0, 5.0, 6.0, 6.0)),
    "inside": ((0.0, 0.0, 1.0, 1.0), (-1.0, -1.0, 2.0, 2.0)),
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_overlap_emit_fraction_equal(case):
    """The EMIT-overlap fraction and the clipped ring equal JAX's (half,
    disjoint: (0, None), and an S2 tile that holds the footprint)."""
    e, s = CLIP_CASES[case]
    jf, ji = jcat.overlap_emit_fraction(jcat.LonLatPolygon.from_bounds(*e),
                                        jcat.LonLatPolygon.from_bounds(*s))
    tf, ti = tcat.overlap_emit_fraction(tcat.LonLatPolygon.from_bounds(*e),
                                        tcat.LonLatPolygon.from_bounds(*s))
    assert tf == jf and _ring(ti) == _ring(ji)
    if case == "half":
        assert abs(tf - 0.5) < 0.01
    if case == "disjoint":
        assert tf == 0.0 and ti is None


def test_polygon_intersection_rotated_quad():
    """A ground-track quadrilateral clipped by an S2 box, and the reverse,
    equal JAX's; 0.5 < fraction <= 1."""
    quad = ((0.2, 0.0), (1.0, 0.4), (0.8, 1.2), (0.0, 0.8))
    jq, tq = jcat.LonLatPolygon(quad), tcat.LonLatPolygon(quad)
    jb = jcat.LonLatPolygon.from_bounds(0.0, 0.0, 1.0, 1.0)
    tb = tcat.LonLatPolygon.from_bounds(0.0, 0.0, 1.0, 1.0)
    jf, ji = jcat.overlap_emit_fraction(jq, jb)
    tf, ti = tcat.overlap_emit_fraction(tq, tb)
    assert tf == jf and _ring(ti) == _ring(ji)
    assert 0.5 < tf <= 1.0
    assert _ring(tb.intersection(tq)) == _ring(jb.intersection(jq))


def test_nonconvex_clip_uses_hull(rng):
    """A non-convex clip polygon is clipped against its convex hull, as
    the reference documents; hull, convexity and the clip equal JAX's
    on seeded polygons."""
    for _ in range(20):
        pts = [tuple(p) for p in rng.uniform(0.0, 1.0, (7, 2))]
        j, t = jcat.LonLatPolygon(tuple(pts)), tcat.LonLatPolygon(tuple(pts))
        assert t.is_convex() == j.is_convex()
        assert t.convex_hull().ring == j.convex_hull().ring
        jb = jcat.LonLatPolygon.from_bounds(0.2, 0.1, 0.9, 0.7)
        tb = tcat.LonLatPolygon.from_bounds(0.2, 0.1, 0.9, 0.7)
        assert _ring(tb.intersection(t)) == _ring(jb.intersection(j))


@pytest.mark.parametrize("decimals", [None, 2])
def test_contains_points_equal(rng, decimals):
    """Point-in-polygon on 20 seeded polygons x 3000 seeded points
    (unrounded, and rounded to 2 decimals so that points fall on edges
    and vertices) equals JAX's (matplotlib's ``contains_points``), with
    the points' shape kept; a point with a NaN coordinate is outside."""
    for _ in range(20):
        n = int(rng.integers(3, 9))
        ring = rng.uniform(0.0, 1.0, (n, 2))
        pts = rng.uniform(-0.2, 1.2, (60, 50, 2))
        if decimals is not None:
            ring, pts = ring.round(decimals), pts.round(decimals)
        ring = tuple(map(tuple, ring))
        want = jcat.LonLatPolygon(ring).contains_points(pts[..., 0],
                                                        pts[..., 1])
        got = tcat.LonLatPolygon(ring).contains_points(pts[..., 0],
                                                       pts[..., 1])
        assert got.shape == (60, 50) and got.dtype == bool
        np.testing.assert_array_equal(got, want)
    sq = tcat.LonLatPolygon.from_bounds(0.0, 0.0, 1.0, 1.0)
    assert sq.contains_points(np.array([0.5, np.nan]),
                              np.array([0.5, 0.5])).tolist() == [True, False]


def test_from_points_and_geojson_equal():
    """``from_points`` (closing duplicate dropped, None coordinates
    skipped, < 3 points -> None) and ``from_geojson`` (Polygon, the
    largest ring of a MultiPolygon, other types and None -> None) equal
    JAX's."""
    cases = [
        [(0, 0), (1, 0), (1, 1), (0, 0)],
        [(0, 0), (None, 3), (1, 0), (1, 1)],
        [(0, 0), (1, 1)],
    ]
    for pts in cases:
        assert (_ring(tcat.LonLatPolygon.from_points(pts))
                == _ring(jcat.LonLatPolygon.from_points(pts)))
    small = [[0, 0], [1, 0], [1, 1], [0, 1], [0, 0]]
    big = [[5, 5], [8, 5], [8, 9], [5, 9], [5, 5]]
    geoms = [{"type": "Polygon", "coordinates": [small]},
             {"type": "MultiPolygon", "coordinates": [[small], [big]]},
             {"type": "Point", "coordinates": [0, 0]}, None]
    for g in geoms:
        assert (_ring(tcat.LonLatPolygon.from_geojson(g))
                == _ring(jcat.LonLatPolygon.from_geojson(g)))
    assert tcat.LonLatPolygon.from_geojson(geoms[1]).bounds() == (5, 5, 8, 9)


def _umm_polys(*rings):
    return {"SpatialExtent": {"HorizontalSpatialDomain": {"Geometry": {
        "GPolygons": [{"Boundary": {"Points": [
            {"Longitude": x, "Latitude": y} for x, y in r]}}
            for r in rings]}}}}


def test_umm_polygon_parse_equal():
    """``emit_geom_wgs84_from_umm``: one GPolygon (closed ring), the
    largest of two, a degenerate one and none, equal to JAX's."""
    sq = [(13.0, 52.0), (14.0, 52.0), (14.0, 53.0), (13.0, 53.0),
          (13.0, 52.0)]
    small = [(13.1, 52.1), (13.2, 52.1), (13.2, 52.2)]
    for umm in (_umm_polys(sq), _umm_polys(small, sq),
                _umm_polys([(1.0, 1.0), (2.0, 2.0)]), {}):
        assert (_ring(tcat.emit_geom_wgs84_from_umm(umm))
                == _ring(jcat.emit_geom_wgs84_from_umm(umm)))
    g = tcat.emit_geom_wgs84_from_umm(_umm_polys(sq))
    assert g.bounds() == (13.0, 52.0, 14.0, 53.0)
    cx, cy = g.centroid()
    assert abs(cx - 13.5) < 1e-9 and abs(cy - 52.5) < 1e-9


@pytest.mark.parametrize("lon,lat,m", [(13.4, 52.5, 10000.0),
                                       (-70.2, -33.4, 2500.0),
                                       (151.0, 0.0, 50000.0)])
def test_point_buffer_bbox_equal(lon, lat, m):
    """The AEQD point-buffer bbox equals JAX's (~20 km at 52.5 N for a
    10 km buffer)."""
    got = tcat.point_buffer_bbox(lon, lat, m)
    assert got == jcat.point_buffer_bbox(lon, lat, m)
    if m == 10000.0:
        le, b, r, t = got
        assert 0.25 < r - le < 0.35 and 0.16 < t - b < 0.20


def test_local_solar_time_equal(rng):
    """``local_solar_time_hours`` (tz-aware, naive and non-UTC
    datetimes) and ``circ_hours_diff`` on seeded inputs equal JAX's."""
    base = dt.datetime(2023, 8, 19, tzinfo=dt.timezone.utc)
    plus2 = dt.timezone(dt.timedelta(hours=2))
    for s, lon in zip(rng.integers(0, 86400 * 30, 50),
                      rng.uniform(-180.0, 180.0, 50)):
        d = base + dt.timedelta(seconds=int(s))
        for dd in (d, d.replace(tzinfo=None), d.astimezone(plus2)):
            assert (tcat.local_solar_time_hours(dd, float(lon))
                    == jcat.local_solar_time_hours(dd, float(lon)))
    for a, b in rng.uniform(-30.0, 30.0, (50, 2)):
        assert tcat.circ_hours_diff(a, b) == jcat.circ_hours_diff(a, b)
    d = dt.datetime(2023, 8, 19, 11, 0, 0, tzinfo=dt.timezone.utc)
    assert abs(tcat.local_solar_time_hours(d, 15.0) - 12.0) < 1e-9
    assert tcat.circ_hours_diff(23.5, 0.5) == 1.0


# ---------------------------------------------------------------- cloud ---

def _scl_file(tmp_path, rng):
    """A seeded 100 x 100 SCL raster (classes 0-11) on a UTM 20 m grid,
    written tiled by the port's writer; (path, the array, both grids)."""
    scl = rng.integers(0, 12, size=(100, 100)).astype(np.uint8)
    scl[:20] = 9
    jg, tg = _grids("utm", 399960.0, 5800020.0, 20.0, 20.0, 100, 100)
    p = ttiff.write_geotiff(tmp_path / "scl.tif", scl[None], tg, tiled=True,
                            blockxsize=32, blockysize=32)
    return p, scl, jg, tg


def _roi_pair(g, frac_rows):
    """The same lon/lat box over the top ``frac_rows`` of ``g`` in both
    packages."""
    le, b, r, t = g.bounds
    lon1, lat1 = g.crs.to_geographic(le, t)
    lon2, lat2 = g.crs.to_geographic(r, t - frac_rows * (t - b))
    box = (float(lon1), float(lat2), float(lon2), float(lat1))
    return (jcat.LonLatPolygon.from_bounds(*box),
            tcat.LonLatPolygon.from_bounds(*box))


def test_scl_metrics_and_count_equal(tmp_path, rng):
    """``count_cloud_pixels`` and ``scl_metrics`` from a GeoTIFF path and
    from an array with its grid, without and with a lon/lat ROI, equal
    JAX's; the counts match NumPy's over the whole raster."""
    p, scl, jg, tg = _scl_file(tmp_path, rng)
    jroi, troi = _roi_pair(jg, 0.3)
    for jargs, targs in (((p,), (p,)), ((p, jroi), (p, troi)),
                         ((scl, None, jg), (scl, None, tg)),
                         ((scl, jroi, jg), (scl, troi, tg)),
                         ((scl,), (scl,))):
        assert (tcat.count_cloud_pixels(*targs)
                == jcat.count_cloud_pixels(*jargs))
        assert tcat.scl_metrics(*targs) == jcat.scl_metrics(*jargs)
    clouds, valid = tcat.count_cloud_pixels(p)
    assert valid == int((scl != 0).sum())
    assert clouds == int(np.isin(scl, (8, 9, 10, 11)).sum())
    m = tcat.scl_metrics(p)
    assert m["class_counts_named"]["CLOUD_HIGH_PROB"] == int((scl == 9).sum())


def test_open_remote_scl_equal(tmp_path, rng):
    """``open_remote_scl`` through an injected ``fetch_range`` over the
    file's bytes equals JAX's and the whole-file read (array and grid),
    and the ROI count over it equals the count from the file."""
    p, scl, jg, tg = _scl_file(tmp_path, rng)
    blob = p.read_bytes()
    calls = []

    def fetch_range(url, start, end):
        calls.append((start, end))
        return blob[start:end + 1]

    arr, grid = tcat.open_remote_scl("https://fake/scl.tif",
                                     fetch_range=fetch_range)
    jarr, jgrid = jcat.open_remote_scl("https://fake/scl.tif",
                                       fetch_range=fetch_range)
    np.testing.assert_array_equal(arr, scl)
    np.testing.assert_array_equal(arr, jarr)
    assert dataclasses.astuple(grid) == dataclasses.astuple(jgrid)
    assert dataclasses.astuple(grid) == dataclasses.astuple(tg)
    assert calls
    _, troi = _roi_pair(jg, 0.5)
    assert (tcat.count_cloud_pixels(arr, troi, grid)
            == tcat.count_cloud_pixels(p, troi))


def test_open_url_window_reads_fewer_bytes(tmp_path, rng):
    """``TiffReader.open_url`` over an injected fetcher: a windowed read
    equals the local reader's and JAX's and transfers under 60 % of the
    file; a second read of the window is served from the block cache."""
    data = rng.integers(0, 60000, size=(4, 256, 256)).astype(np.uint16)
    _, tg = _grids("utm", 399960.0, 5800020.0, 10.0, 10.0, 256, 256)
    p = ttiff.write_geotiff(tmp_path / "cog.tif", data, tg, tiled=True,
                            blockxsize=64, blockysize=64)
    blob = p.read_bytes()
    moved = {"bytes": 0}

    def fetch_range(url, start, end):
        moved["bytes"] += min(end + 1, len(blob)) - start
        return blob[start:end + 1]

    win = ttiff.Window(70, 10, 40, 30)
    with ttiff.TiffReader.open_url("https://fake/cog.tif", fetch_range,
                                   block_size=4096) as r:
        got = r.read(window=win, bands=[1, 3])
        first = moved["bytes"]
        again = r.read(window=win, bands=[1, 3])
        assert moved["bytes"] == first
    with jtiff.TiffReader.open_url("https://fake/cog.tif", fetch_range,
                                   block_size=4096) as r:
        want = r.read(window=jtiff.Window(70, 10, 40, 30), bands=[1, 3])
    np.testing.assert_array_equal(got, data[[1, 3], 10:40, 70:110])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, got)
    assert first < 0.6 * len(blob)


def test_http_range_source_blocks_equal():
    """``HttpRangeSource.pread`` across block edges and past the end of
    the data returns JAX's bytes and fetches the same blocks."""
    blob = bytes(np.random.default_rng(3).integers(0, 256, 10_000,
                                                   dtype=np.uint8))
    seen = {"jax": [], "torch": []}

    def fetcher(key):
        def fetch(url, start, end):
            seen[key].append((start, end))
            return blob[start:end + 1]
        return fetch

    js = jtiff.HttpRangeSource("u", fetcher("jax"), block_size=1000)
    ts = ttiff.HttpRangeSource("u", fetcher("torch"), block_size=1000)
    for off, size in ((0, 10), (995, 20), (2500, 3000), (9990, 50),
                      (12_000, 5), (4, 8)):
        assert ts.pread(off, size) == js.pread(off, size)
        assert ts.pread(off, size) == blob[off:off + size]
    assert seen["torch"] == seen["jax"]
    ts.close()
    assert ts._cache == {}


# -------------------------------------------------------------- clients ---

def make_umm_item(begin, cloud=10.0, granule="G1", lon0=13.0):
    return {
        "meta": {"native-id": granule, "concept-id": f"C-{granule}"},
        "umm": {
            "GranuleUR": granule,
            "CloudCover": cloud,
            "TemporalExtent": {"RangeDateTime": {
                "BeginningDateTime": begin, "EndingDateTime": begin}},
            "SpatialExtent": {"HorizontalSpatialDomain": {"Geometry": {
                "GPolygons": [{"Boundary": {"Points": [
                    {"Longitude": lon0, "Latitude": 52.0},
                    {"Longitude": lon0 + 0.8, "Latitude": 52.0},
                    {"Longitude": lon0 + 0.8, "Latitude": 52.7},
                    {"Longitude": lon0, "Latitude": 52.7},
                ]}}]}}},
            "RelatedUrls": [
                {"Type": "GET DATA",
                 "URL": f"https://x/EMIT_L2A_RFL_001_{granule}.nc"},
                {"Type": "GET DATA VIA DIRECT ACCESS",
                 "URL": f"s3://x/EMIT_L2A_MASK_001_{granule}.nc"},
                {"Type": "GET DATA",
                 "URL": f"https://x/EMIT_L2A_RFL_001_{granule}.png"},
                {"Type": "VIEW RELATED INFORMATION",
                 "URL": "https://x/doc.pdf"},
            ],
        },
    }


def make_stac_item(item_id, datetime_str, bbox, cloud=5.0, assets=None):
    le, b, r, t = bbox
    return {
        "id": item_id,
        "properties": {"datetime": datetime_str, "eo:cloud_cover": cloud},
        "bbox": list(bbox),
        "geometry": {"type": "Polygon", "coordinates": [[
            [le, b], [r, b], [r, t], [le, t], [le, b]]]},
        "assets": assets or {"scl": {"href": f"https://x/{item_id}_SCL.tif"}},
    }


@pytest.mark.parametrize("n_items,page_size", [(3, 3), (7, 3), (2, 5)])
def test_cmr_search_pagination_and_urls_equal(n_items, page_size):
    """``CmrClient.search``: the pages asked for and their parameters,
    and the items returned, equal JAX's (a full last page asks for one
    more); ``data_urls`` keeps the RFL / MASK ``.nc`` links."""
    items = [make_umm_item("2023-08-19T11:01:26Z", granule=f"g{i}")
             for i in range(n_items)]
    seen = {"jax": [], "torch": []}

    def fetcher(key):
        def fetch(url, params=None, **kw):
            seen[key].append((url, dict(params)))
            p = params["page_num"]
            return {"items": items[(p - 1) * page_size:p * page_size]}
        return fetch

    kw = dict(bbox=[13, 52, 14, 53], temporal=("2023-08-01", "2023-08-31"),
              cloud_cover=(0, 40), page_size=page_size)
    got = tcat.CmrClient(fetch_json=fetcher("torch")).search(**kw)
    want = jcat.CmrClient(fetch_json=fetcher("jax")).search(**kw)
    assert got == want == items
    assert seen["torch"] == seen["jax"]
    for it in items:
        assert tcat.CmrClient.data_urls(it) == jcat.CmrClient.data_urls(it)
        assert tcat.CmrClient.data_urls(it, ("_MASK_",)) == [
            f"s3://x/EMIT_L2A_MASK_001_{it['umm']['GranuleUR']}.nc"]


def test_download_granule_files_equal(tmp_path):
    """``download_granule_files`` through an injected ``download``: the
    same URLs and destinations as JAX's, and a second call served from
    the files already there."""
    item = make_umm_item("2023-08-19T11:01:26Z", granule="A1")
    calls = {"jax": [], "torch": []}

    def downloader(key):
        def download(url, dst):
            calls[key].append((url, dst.name))
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(url.encode())
            return dst
        return download

    tc = tcat.CmrClient(download=downloader("torch"))
    jc = jcat.CmrClient(download=downloader("jax"))
    got = tc.download_granule_files(item, tmp_path / "t")
    want = jc.download_granule_files(item, tmp_path / "j")
    assert [p.name for p in got] == [p.name for p in want]
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 2
    tc.download_granule_files(item, tmp_path / "t")
    assert len(calls["torch"]) == 2
    tc.download_granule_files(item, tmp_path / "t", overwrite=True)
    assert len(calls["torch"]) == 4


def test_choose_helpers_equal(rng):
    """``granule_datetime``, ``choose_best_emit_per_date`` (a missing
    cloud cover counts as 999) and ``choose_nearest`` (tz-aware and
    naive targets) on 40 seeded items equal JAX's."""
    base = dt.datetime(2023, 8, 1, tzinfo=dt.timezone.utc)
    items = []
    for i in range(40):
        d = base + dt.timedelta(seconds=int(rng.integers(0, 86400 * 10)))
        it = make_umm_item(d.isoformat().replace("+00:00", "Z"),
                           cloud=float(rng.integers(0, 100)),
                           granule=f"g{i}")
        if i % 7 == 0:
            del it["umm"]["CloudCover"]
        items.append(it)
    items.append({"umm": {}})
    for it in items:
        assert tcat.granule_datetime(it) == jcat.granule_datetime(it)
    got = tcat.choose_best_emit_per_date(items)
    want = jcat.choose_best_emit_per_date(items)
    assert {k: v["umm"]["GranuleUR"] for k, v in got.items()} == {
        k: v["umm"]["GranuleUR"] for k, v in want.items()}
    for s in rng.integers(0, 86400 * 10, 10):
        target = base + dt.timedelta(seconds=int(s))
        for tt in (target, target.replace(tzinfo=None)):
            assert (tcat.choose_nearest(items, tt)
                    is jcat.choose_nearest(items, tt))
    assert tcat.choose_nearest([{"umm": {}}], base) is None


def test_stac_search_pagination_equal():
    """``StacClient.search``: POST bodies, a ``merge`` link (the token
    merged into the original filters), a replacing link body, a GET link
    and ``max_items`` give JAX's requests and items."""
    pages = {
        "https://stac.test/search": {
            "features": [{"id": "a"}, {"id": "b"}],
            "links": [{"rel": "next", "href": "https://stac.test/p2",
                       "merge": True, "body": {"token": "t2"}}]},
        "https://stac.test/p2": {
            "features": [{"id": "c"}],
            "links": [{"rel": "next", "href": "https://stac.test/p3",
                       "body": {"token": "t3"}}]},
        "https://stac.test/p3": {
            "features": [{"id": "d"}, {"id": "e"}],
            "links": [{"rel": "next", "href": "https://stac.test/p4",
                       "method": "GET"}]},
        "https://stac.test/p4": {"features": [{"id": "f"}], "links": []},
    }
    seen = {"jax": [], "torch": []}

    def fetcher(key):
        def fetch(url, method="GET", body=None, **kw):
            seen[key].append((url, method, body))
            return pages[url]
        return fetch

    kw = dict(collections=["sentinel-2-l2a"], bbox=(10, 45, 11, 46),
              datetime_range="2023-08-01/2023-08-31")
    for max_items in (500, 4):
        got = tcat.StacClient("https://stac.test/", fetch_json=fetcher(
            "torch")).search(max_items=max_items, **kw)
        want = jcat.StacClient("https://stac.test/", fetch_json=fetcher(
            "jax")).search(max_items=max_items, **kw)
        assert got == want
        assert seen["torch"] == seen["jax"]
    assert [i["id"] for i in got] == ["a", "b", "c", "d"]
    assert seen["torch"][1][2] == {"collections": ["sentinel-2-l2a"],
                                   "limit": 100, "bbox": [10.0, 45.0, 11.0,
                                                          46.0],
                                   "datetime": "2023-08-01/2023-08-31",
                                   "token": "t2"}


def test_stac_download_asset_cached(tmp_path):
    """``download_asset`` fetches the asset's href to ``dst`` once and
    then returns the file there, as JAX's does."""
    calls = []

    def download(url, dst):
        calls.append(url)
        dst.write_bytes(b"x")
        return dst

    item = make_stac_item("s1", "2023-08-19T10:26:00Z", (0, 0, 1, 1))
    for mod in (tcat, jcat):
        c = mod.StacClient("https://x", download=download)
        p = c.download_asset(item, "scl", tmp_path / f"{mod.__name__}.tif")
        assert p.read_bytes() == b"x"
        c.download_asset(item, "scl", tmp_path / f"{mod.__name__}.tif")
    assert calls == ["https://x/s1_SCL.tif"] * 2


@pytest.mark.parametrize("assets", [
    {"scl": {}, "scl-jp2": {}}, {"SCL": {}}, {"visual": {}},
    {"scl-cog": {}, "scl-jp2": {}}, {"scl-jp2": {}}, {"scl_20m": {}}])
def test_best_asset_key_equal(assets):
    """``best_asset_key`` prefers the COG variant, as JAX's."""
    assert (tcat.best_asset_key(assets, "scl")
            == jcat.best_asset_key(assets, "scl"))


def test_search_emit_granules_equal():
    """``search_emit_granules``: the CMR parameters (AEQD buffer bbox,
    temporal, cloud cover) equal JAX's."""
    seen = {"jax": [], "torch": []}

    def fetcher(key):
        def fetch(url, params=None, **kw):
            seen[key].append(dict(params))
            return {"items": []}
        return fetch

    for key, mod in (("jax", jcat), ("torch", tcat)):
        mod.search_emit_granules(
            mod.CmrClient(fetch_json=fetcher(key)), 13.4, 52.5, 10000.0,
            temporal=("2023-08-01T00:00:00Z", "2023-08-31T00:00:00Z"),
            cloud_cover=(0, 50))
    assert seen["torch"] == seen["jax"]
    bbox = [float(v) for v in seen["torch"][0]["bounding_box"].split(",")]
    assert bbox[0] < 13.4 < bbox[2] and bbox[1] < 52.5 < bbox[3]


# -------------------------------------------------------------- pairing ---

S2_ITEMS = [
    make_stac_item("cloudy", "2023-08-19T10:26:00Z", (12.9, 51.9, 14.1, 53.0),
                   cloud=2.0),
    make_stac_item("clear", "2023-08-20T10:26:00Z", (12.9, 51.9, 14.1, 53.0),
                   cloud=30.0),
    make_stac_item("night", "2023-08-19T22:00:00Z", (12.9, 51.9, 14.1, 53.0)),
    make_stac_item("faraway", "2023-08-19T10:26:00Z", (15.0, 51.9, 16.0, 53.0)),
    make_stac_item("partial", "2023-08-18T10:20:00Z", (13.3, 51.9, 14.1, 53.0)),
    make_stac_item("jp2only", "2023-08-19T10:29:00Z", (12.9, 51.9, 14.1, 53.0),
                   assets={"scl-jp2": {"href": "https://x/j.jp2"}}),
]


def _scl_fetchers(fail=()):
    """(JAX's, the port's) ``scl_fetcher``: a seeded cloud field per item
    on a geographic grid over the EMIT box; ids in ``fail`` raise
    ValueError."""
    jg, tg = _grids("geo", 12.9, 53.0, 0.012, 0.011, 100, 100)

    def scl_for(item):
        if item["id"] in fail:
            raise ValueError("unreadable SCL")
        r = np.random.default_rng(sum(map(ord, item["id"])))
        scl = np.full((100, 100), 4, dtype=np.uint8)
        scl[r.random((100, 100)) < {"cloudy": 0.7}.get(item["id"], 0.02)] = 9
        return scl

    return ((lambda it, key: (scl_for(it), jg)),
            (lambda it, key: (scl_for(it), tg)))


def _stac_pair(items):
    def fetch(url, method="GET", body=None, **kw):
        assert method == "POST"
        lo, hi = body["datetime"].split("/")
        keep = [it for it in items
                if lo[:10] <= it["properties"]["datetime"][:10] <= hi[:10]]
        return {"features": keep, "links": []}
    return (jcat.StacClient("https://x", fetch_json=fetch),
            tcat.StacClient("https://x", fetch_json=fetch))


def _best_both(emit_item, items, fail=(), **cfg):
    js, ts = _stac_pair(items)
    jf, tf = _scl_fetchers(fail)
    want = jcat.find_best_s2_for_emit_item(
        emit_item, stac=js, config=JPairSearchConfig(**cfg), scl_fetcher=jf)
    got = tcat.find_best_s2_for_emit_item(
        emit_item, stac=ts, config=TPairSearchConfig(**cfg), scl_fetcher=tf)
    return got, want


@pytest.mark.parametrize("top_k", [1, 3, 5])
def test_find_best_s2_equal(top_k):
    """``find_best_s2_for_emit_item``: the item picked, its SCL cloud
    fraction and the debug dict equal JAX's (prefilter by time of day
    and overlap, rank, re-rank the top k by the SCL count). With k = 1
    the one candidate kept has only a JP2 SCL, so none is read."""
    emit_item = make_umm_item("2023-08-19T10:30:00Z", lon0=13.0)
    got, want = _best_both(emit_item, S2_ITEMS, top_k_scl=top_k)
    assert (got[0] or {}).get("id") == (want[0] or {}).get("id")
    assert got[1] == want[1] and got[2] == want[2]
    if top_k == 1:
        assert got[0] is None and got[2]["reason"] == "all_scl_failed"
    else:
        assert got[0]["id"] == "clear" and got[1] < 0.05


@pytest.mark.parametrize("case", ["no_items", "no_candidates", "all_failed",
                                  "no_begin", "no_polygon", "bounds_only"])
def test_find_best_s2_reasons_equal(case):
    """Each early return of the reason ledger equals JAX's: no S2 items,
    none after the time-of-day and overlap filters, every SCL read
    failing, no begin time, no polygon, and a degenerate polygon whose
    bounds still give a box."""
    emit_item = make_umm_item("2023-08-19T10:30:00Z")
    items, fail = S2_ITEMS, ()
    if case == "no_items":
        items = []
    elif case == "no_candidates":
        items = [S2_ITEMS[2], S2_ITEMS[3]]
    elif case == "all_failed":
        fail = {it["id"] for it in S2_ITEMS}
    elif case == "no_begin":
        del emit_item["umm"]["TemporalExtent"]
    elif case == "no_polygon":
        del emit_item["umm"]["SpatialExtent"]
    else:
        geo = emit_item["umm"]["SpatialExtent"]["HorizontalSpatialDomain"]
        pts = geo["Geometry"]["GPolygons"][0]["Boundary"]["Points"]
        pts[2:] = []
    got, want = _best_both(emit_item, items, fail=fail)
    assert (got[0] or {}).get("id") == (want[0] or {}).get("id")
    assert got[1:] == want[1:]
    if case != "bounds_only":
        assert got[0] is None and "reason" in got[2]


def test_find_best_s2_default_download_equal(tmp_path, rng):
    """Without ``scl_fetcher`` the SCL asset is downloaded into
    ``workdir`` through the client's ``download`` and counted from the
    file: the same pick and debug dict as JAX's."""
    jg, tg = _grids("geo", 12.9, 53.0, 0.012, 0.011, 100, 100)
    files = {}
    for it in S2_ITEMS:
        scl = np.where(rng.random((100, 100)) < rng.random(), 8, 5)
        files[it["id"]] = ttiff.write_geotiff(
            tmp_path / f"src_{it['id']}.tif", scl.astype(np.uint8)[None], tg)

    def download(url, dst):
        shutil.copyfile(files[url.rsplit("/", 1)[-1][:-8]], dst)
        return dst

    def fetch(url, method="GET", body=None, **kw):
        return {"features": S2_ITEMS, "links": []}

    emit_item = make_umm_item("2023-08-19T10:30:00Z")
    want = jcat.find_best_s2_for_emit_item(
        emit_item, stac=jcat.StacClient("https://x", fetch, download),
        workdir=tmp_path / "j")
    got = tcat.find_best_s2_for_emit_item(
        emit_item, stac=tcat.StacClient("https://x", fetch, download),
        workdir=tmp_path / "t")
    assert got[0]["id"] == want[0]["id"]
    assert got[1:] == want[1:]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_discover_pairs_equal():
    """``discover_pairs``: CMR search -> least-cloudy granule per date ->
    best S2 match -> kept within ``max_s2_cloud_frac``; every record
    (date, items, cloud fraction, debug, kept) equals JAX's."""
    emit_items = [
        make_umm_item("2023-08-19T10:30:00Z", cloud=20.0, granule="a"),
        make_umm_item("2023-08-19T11:30:00Z", cloud=5.0, granule="b"),
        make_umm_item("2023-08-21T10:30:00Z", cloud=15.0, granule="c"),
        make_umm_item("2023-08-25T10:30:00Z", cloud=15.0, granule="d"),
    ]

    def cmr_fetch(url, params=None, **kw):
        return {"items": emit_items if params["page_num"] == 1 else []}

    s2_items = S2_ITEMS + [make_stac_item(
        "late", "2023-08-24T10:26:00Z", (12.9, 51.9, 14.1, 53.0))]
    js, ts = _stac_pair(s2_items)
    jf, tf = _scl_fetchers()
    kw = dict(bbox=[12.9, 51.9, 14.1, 53.0],
              temporal=("2023-08-18T00:00:00Z", "2023-08-26T00:00:00Z"))
    want = jcat.discover_pairs(cmr=jcat.CmrClient(fetch_json=cmr_fetch),
                               stac=js, config=JPairSearchConfig(
                                   max_s2_cloud_frac=0.5),
                               scl_fetcher=jf, **kw)
    got = tcat.discover_pairs(cmr=tcat.CmrClient(fetch_json=cmr_fetch),
                              stac=ts, config=TPairSearchConfig(
                                  max_s2_cloud_frac=0.5),
                              scl_fetcher=tf, **kw)
    assert got == want
    assert [p["date"] for p in got] == ["2023-08-19", "2023-08-21",
                                        "2023-08-25"]
    assert got[0]["emit_item"]["umm"]["GranuleUR"] == "b"
    assert [p["kept"] for p in got] == [True, True, True]


# -------------------------------------------------- loopback HTTP paths ---

def _cmr_item(name, day, cloud):
    return {"meta": {"native-id": name}, "umm": {
        "CloudCover": cloud,
        "TemporalExtent": {"RangeDateTime": {
            "BeginningDateTime": f"2023-08-{day:02d}T11:01:26Z"}},
        "RelatedUrls": [
            {"Type": "GET DATA", "URL": f"/files/EMIT_L2A_RFL_{name}.nc"},
            {"Type": "GET DATA", "URL": f"/files/EMIT_L2A_MASK_{name}.nc"}]}}


class _Handler(BaseHTTPRequestHandler):
    payload = b"granule-bytes-" + bytes(range(256)) * 40

    def log_message(self, *a):
        pass

    def _send(self, code, body, ctype="application/octet-stream",
              extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        u = urlparse(self.path)
        q = parse_qs(u.query)
        blob = self.server.blob
        if u.path == "/search/granules.umm_json":
            self.server.seen.append(("cmr", dict(q)))
            page = int(q.get("page_num", ["1"])[0])
            self._json({"items": [_cmr_item("A1", 19, 12.0),
                                  _cmr_item("A2", 19, 5.0)]
                        if page == 1 else []})
        elif u.path.startswith("/files/"):
            self.server.seen.append(("download",
                                     self.headers.get("Authorization")))
            self._send(200, self.payload)
        elif u.path == "/noranged.bin":
            self.server.seen.append(("norange", self.headers.get("Range")))
            self._send(200, blob)
        elif u.path == "/ranged.bin":
            start, end = map(int, self.headers["Range"].split("=")[1]
                             .split("-"))
            self.server.seen.append(("range", (start, end)))
            chunk = blob[start:end + 1]
            self._send(206, chunk, extra=[(
                "Content-Range",
                f"bytes {start}-{start + len(chunk) - 1}/{len(blob)}")])
        else:
            self._json({"error": "not found"}, code=404)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(n) or b"{}")
        if urlparse(self.path).path != "/stac/search":
            self._json({}, code=404)
            return
        self.server.seen.append(("stac", body))
        if "token" not in body:
            self._json({"features": [{"id": "S2A_1", "assets": {}}],
                        "links": [{"rel": "next", "merge": True,
                                   "href": f"http://{self.headers['Host']}"
                                           "/stac/search",
                                   "body": {"token": "next:page2"}}]})
        elif body.get("collections"):
            self._json({"features": [{"id": "S2B_2", "assets": {}}],
                        "links": []})
        else:
            self._json({"features": [{"id": "JUNK", "assets": {}}],
                        "links": []})


@pytest.fixture()
def live_server(monkeypatch, tmp_path):
    """A threading HTTP server on 127.0.0.1 (port 0) serving canned CMR,
    STAC, download and ranged responses, and a GeoTIFF as ``blob``;
    shut down and joined on teardown."""
    for var in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy",
                "https_proxy", "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    monkeypatch.delenv("EARTHDATA_TOKEN", raising=False)
    data = np.random.default_rng(7).integers(0, 12, (1, 300, 300)).astype(
        np.uint8)
    _, tg = _grids("utm", 399960.0, 5800020.0, 20.0, 20.0, 300, 300)
    p = ttiff.write_geotiff(tmp_path / "blob.tif", data, tg, tiled=True,
                            blockxsize=64, blockysize=64)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    srv.seen, srv.blob, srv.data = [], p.read_bytes(), data[0]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


def test_default_fetch_json_cmr_search_equal(live_server, monkeypatch):
    """``CmrClient.search`` with the default ``fetch_json`` (GET over
    ``requests``): the same items and wire parameters as JAX's."""
    base, srv = live_server
    url = f"{base}/search/granules.umm_json"
    monkeypatch.setattr(tclients, "CMR_GRANULE_SEARCH", url)
    monkeypatch.setattr(jclients, "CMR_GRANULE_SEARCH", url)
    kw = dict(bbox=(10.0, 45.0, 11.0, 46.0),
              temporal=("2023-08-01", "2023-08-31"),
              cloud_cover=(0.0, 50.0), page_size=2)
    got = tcat.CmrClient().search(**kw)
    n = len(srv.seen)
    want = jcat.CmrClient().search(**kw)
    assert got == want
    assert [i["meta"]["native-id"] for i in got] == ["A1", "A2"]
    assert srv.seen[:n] == srv.seen[n:]
    q = srv.seen[0][1]
    assert q["bounding_box"] == ["10.00000000,45.00000000,"
                                 "11.00000000,46.00000000"]
    assert q["cloud_cover"] == ["0.0,50.0"]


@pytest.mark.parametrize("how", ["env", "argument"])
def test_default_download_with_earthdata_token(live_server, tmp_path,
                                               monkeypatch, how):
    """``download_granule_files`` with the default ``download`` streams
    both files and sends the Earthdata bearer token (from
    ``EARTHDATA_TOKEN`` or the argument), as JAX's does."""
    base, srv = live_server
    item = _cmr_item("A1", 19, 12.0)
    for u in item["umm"]["RelatedUrls"]:
        u["URL"] = base + u["URL"]
    if how == "env":
        monkeypatch.setenv("EARTHDATA_TOKEN", "tok-123")
        kw = {}
    else:
        kw = {"token": "tok-123"}
    for key, mod in (("torch", tclients), ("jax", jclients)):
        client = mod.CmrClient(download=lambda url, dst: mod._default_download(
            url, dst, timeout=10.0, **kw))
        paths = client.download_granule_files(item, tmp_path / key)
        assert [p.name for p in paths] == ["EMIT_L2A_RFL_A1.nc",
                                           "EMIT_L2A_MASK_A1.nc"]
        assert paths[0].read_bytes() == _Handler.payload
    auths = [a for k, a in srv.seen if k == "download"]
    assert auths == ["Bearer tok-123"] * 4


def test_default_fetch_json_stac_pagination_equal(live_server):
    """``StacClient.search`` with the default ``fetch_json`` (POST): the
    ``merge`` token link keeps the filters; items and bodies equal
    JAX's."""
    base, srv = live_server
    got = tcat.StacClient(f"{base}/stac").search(
        collections=["sentinel-2-l2a"], bbox=(10, 45, 11, 46),
        datetime_range="2023-08-01/2023-08-31")
    n = len(srv.seen)
    want = jcat.StacClient(f"{base}/stac").search(
        collections=["sentinel-2-l2a"], bbox=(10, 45, 11, 46),
        datetime_range="2023-08-01/2023-08-31")
    assert got == want and [i["id"] for i in got] == ["S2A_1", "S2B_2"]
    assert srv.seen[:n] == srv.seen[n:]
    assert srv.seen[1][1]["token"] == "next:page2"
    assert srv.seen[1][1]["collections"] == ["sentinel-2-l2a"]


def _closed_port_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}/x"


@pytest.mark.parametrize("what", ["json_404", "json_refused", "json_post_404",
                                  "download_404", "download_refused"])
def test_failures_wrapped(live_server, tmp_path, what):
    """An HTTP error or a refused connection raises
    ``CatalogUnavailableError`` (the port's class) from the default
    fetchers, with JAX's message."""
    base, _ = live_server
    url = _closed_port_url() if what.endswith("refused") else f"{base}/missing"
    msgs = []
    for mod in (tclients, jclients):
        with pytest.raises(mod.CatalogUnavailableError) as e:
            if what.startswith("json"):
                mod._default_fetch_json(
                    url, method="POST" if "post" in what else "GET",
                    body={}, timeout=10.0)
            else:
                mod._default_download(url, tmp_path / "x.bin", timeout=10.0)
        msgs.append(str(e.value).split(" failed: ")[0])
    assert msgs[0] == msgs[1]
    assert not issubclass(tclients.CatalogUnavailableError,
                          jclients.CatalogUnavailableError)


def test_http_range_source_default_fetch(live_server):
    """``HttpRangeSource`` with its default fetcher against a ranged-GET
    server: exact bytes, one request per block touched, the cache
    serving repeats, as JAX's."""
    base, srv = live_server
    blob = srv.blob
    bs = 1 << 12
    for mod in (ttiff, jtiff):
        srv.seen.clear()
        src = mod.HttpRangeSource(f"{base}/ranged.bin", block_size=bs)
        assert src.pread(0, 16) == blob[:16]
        assert src.pread(bs - 8, 32) == blob[bs - 8:bs + 24]
        assert src.pread(4, 8) == blob[4:12]
        assert src.pread(len(blob) - 5, 50) == blob[-5:]
        ranges = [r for k, r in srv.seen if k == "range"]
        nb = (len(blob) - 5) // bs
        assert ranges == [(0, bs - 1), (bs, 2 * bs - 1),
                          (nb * bs, (nb + 1) * bs - 1)]


def test_http_range_source_server_ignores_range(live_server):
    """A server that answers 200 with the whole body: each block is
    sliced from it at its own offset (the cache holds no misplaced
    bytes), as JAX's."""
    base, srv = live_server
    blob = srv.blob
    for mod in (ttiff, jtiff):
        src = mod.HttpRangeSource(f"{base}/noranged.bin", block_size=1 << 12)
        assert src.pread(10_000, 32) == blob[10_000:10_032]
        assert src.pread(0, 8) == blob[:8]
        assert src.pread(len(blob) - 3, 10) == blob[-3:]


def test_open_remote_scl_over_http(live_server):
    """``open_remote_scl`` with the default fetcher reads the served
    GeoTIFF whole: equal to the data written and to JAX's read."""
    base, srv = live_server
    arr, grid = tcat.open_remote_scl(f"{base}/ranged.bin")
    jarr, jgrid = jcat.open_remote_scl(f"{base}/ranged.bin")
    np.testing.assert_array_equal(arr, srv.data)
    np.testing.assert_array_equal(arr, jarr)
    assert dataclasses.astuple(grid) == dataclasses.astuple(jgrid)

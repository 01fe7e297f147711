"""The granule toolkit (``ortho.toolkit``) on the full-width granule and a
second full-width ``make_scene`` granule, and pair discovery
(``catalog.discover_pairs``) over canned catalog responses written to
disk around the first granule's swath; every fetch goes through the
clients' injected callables (no ``requests``, no socket)."""

import dataclasses
import datetime as dt
import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from card_inputs import ORTHO_BANDS, ORTHO_RAW

pytestmark = pytest.mark.gpu

#: the second granule: seed TOOLKIT_SEED, its swath centre TOOLKIT_SHIFT_M
#: (x, y) metres from the first's (about half a scene along the track, as
#: consecutive EMIT scenes overlap), its own small S2 stack (unused); the
#: subset polygon's half sides, as fractions of the ortho grid's extent
TOOLKIT_SEED = 3
TOOLKIT_SHIFT_M = (9000.0, -42000.0)
TOOLKIT_S2_PX = 120
TOOLKIT_SUBSET_HALF = 0.29
#: CATALOG_DATES dates of EMIT granules, two a date, over the first
#: granule; S2 L2A items on the 20 m MGRS tile that holds it (5490 x 5490
#: SCL, tiled CATALOG_BLOCK px, deflate): the whole tile every 5 days,
#: strips from two other orbits (two baselines each) between, at 10:00
#: UTC; on CATALOG_MATCH_DAYS an EMIT granule lies in the time-of-day
#: window (a day costs one SCL count, ~23 s on the card's host, per
#: full-tile acquisition in the days window: one day, two counts);
#: CATALOG_CLOUD: each full-tile acquisition's cloud share
CATALOG_DATES = 30
CATALOG_TILE = (399960.0, 5800020.0, 20.0, 5490)
CATALOG_MATCH_DAYS = (13,)
CATALOG_CLOUD = {0: 0.2, 5: 0.45, 10: 0.62, 15: 0.31, 20: 0.15, 25: 0.74,
                 30: 0.56}
CATALOG_BLOCK = 512
T0_DAY = dt.datetime(2023, 6, 1, tzinfo=dt.timezone.utc)


def iso(d):
    return d.isoformat().replace("+00:00", "Z")


def catalog_setup(scene, workdir):
    """Host only: the canned CMR page and STAC items, the SCL rasters, and
    what whole-file ``TiffReader`` counts of each SCL over the overlap of
    the footprint and the tile say (its cloud share)."""
    from hyperres_torch.catalog import (
        LonLatPolygon, emit_geom_wgs84_from_umm, overlap_emit_fraction,
    )
    from hyperres_torch.core.constants import SCL_CLOUD_CLASSES
    from hyperres_torch.core.grid import Grid
    from hyperres_torch.io.tiff import TiffReader, write_geotiff

    utm = scene.utm_crs
    x0, y0, res, n = CATALOG_TILE
    tile = Grid(utm, x0, y0, res, res, n, n)

    def lonlat(xs, ys):
        lon, lat = utm.to_geographic(np.asarray(xs), np.asarray(ys))
        return [[float(a), float(b)] for a, b in zip(lon, lat)]

    # EMIT footprint: the raw swath's corners, as a UMM GPolygon
    h, w = ORTHO_RAW
    ring = lonlat(*scene.raw_pixel_utm(np.array([0, 0, h - 1, h - 1]),
                                       np.array([0, w - 1, w - 1, 0])))
    umm_geo = {"HorizontalSpatialDomain": {"Geometry": {"GPolygons": [{
        "Boundary": {"Points": [{"Longitude": a, "Latitude": b}
                                for a, b in ring + ring[:1]]}}]}}}
    rng = np.random.default_rng(17)
    emit_items = []
    for day in range(1, CATALOG_DATES + 1):
        for k in range(2):
            if day in CATALOG_MATCH_DAYS and k == 0:
                hour = 9.0 + rng.random()          # in the ToD window
            else:
                hour = 12.5 + 8.0 * rng.random()   # out of it
            emit_items.append({
                "meta": {"native-id": f"EMIT_{day:02d}_{k}"},
                "umm": {"GranuleUR": f"EMIT_{day:02d}_{k}",
                        "CloudCover": float(10 + 40 * k + rng.integers(0, 9)),
                        "TemporalExtent": {"RangeDateTime": {
                            "BeginningDateTime": iso(T0_DAY + dt.timedelta(
                                days=day, hours=hour))}},
                        "SpatialExtent": umm_geo}})

    def tile_item(item_id, day, xa, xb, scl_day):
        xs = [x0 + xa * n * res, x0 + xb * n * res]
        c = lonlat([xs[0], xs[1], xs[1], xs[0]],
                   [y0, y0, y0 - n * res, y0 - n * res])
        lons, lats = [p[0] for p in c], [p[1] for p in c]
        return {"id": item_id,
                "properties": {"datetime": iso(T0_DAY + dt.timedelta(
                    days=day, hours=10)), "eo:cloud_cover": 30.0},
                "bbox": [min(lons), min(lats), max(lons), max(lats)],
                "geometry": {"type": "Polygon", "coordinates": [c + [c[0]]]},
                "assets": {"scl": {"href": f"canned://scl/{scl_day:02d}.tif"},
                           "scl-jp2": {"href": f"canned://jp2/{item_id}"}}}

    s2_items = []
    for day in range(0, CATALOG_DATES + 4):
        if day % 5 == 0:
            s2_items.append(tile_item(f"S2_T33_{day:02d}_full", day, 0.0,
                                      1.0, day))
        elif day % 5 in (2, 4):   # partial strips, two baselines each
            xa, xb = (0.0, 0.4) if day % 5 == 2 else (0.6, 1.0)
            for base in (0, 1):
                s2_items.append(tile_item(f"S2_T33_{day:02d}_strip_{base}",
                                          day, xa, xb, 5 * (day // 5)))
    cat = workdir / "canned"
    for sub in ("cmr", "scl"):
        (cat / sub).mkdir(parents=True)
    (cat / "cmr" / "page_1.json").write_text(json.dumps({"items":
                                                          emit_items}))
    (cat / "stac_items.json").write_text(json.dumps(s2_items))

    # SCL rasters of the full-tile acquisitions: land classes per pixel,
    # clouds in 640 m cells at each acquisition's share, a nodata corner
    cells = -(-n // 32)
    land_of = np.repeat(np.array([4, 5, 6, 7], np.uint8), [55, 25, 10, 10])
    ii = np.arange(n)
    corner = (ii[:, None] + (n - ii)[None, :]) < n // 8
    scl_paths = {}
    for day, frac in CATALOG_CLOUD.items():
        r = np.random.default_rng(day)
        cloud = np.where(r.random((cells, cells)) < frac,
                         r.integers(8, 11, (cells, cells), dtype=np.uint8), 0)
        cloud = np.repeat(np.repeat(cloud, 32, 0), 32, 1)[:n, :n]
        scl = np.where(cloud > 0, cloud,
                       land_of[r.integers(0, 100, (n, n), dtype=np.uint8)])
        scl[corner] = 0
        scl_paths[day] = write_geotiff(
            cat / "scl" / f"{day:02d}.tif", scl[None], tile, nodata=0,
            tiled=True, blockxsize=CATALOG_BLOCK, blockysize=CATALOG_BLOCK)

    emit_geom = emit_geom_wgs84_from_umm(emit_items[0]["umm"])
    _, roi = overlap_emit_fraction(
        emit_geom, LonLatPolygon.from_geojson(s2_items[0]["geometry"]))
    gx, gy = np.meshgrid(*tile.pixel_center_coords())
    lon, lat = utm.to_geographic(gx, gy)
    mask = roi.contains_points(np.asarray(lon), np.asarray(lat))
    del gx, gy, lon, lat
    expected = {}
    for day, p in scl_paths.items():
        with TiffReader(p) as rd:
            a = rd.read()[0]
        valid = mask & (a != 0)
        expected[day] = (int((valid & np.isin(a, SCL_CLOUD_CLASSES)).sum())
                         / int(valid.sum()))
    return dict(cat=cat, tile=tile, emit_geom=emit_geom, scl_paths=scl_paths,
                expected=expected, workdir=workdir)


@pytest.fixture(scope="module")
def catalog(granule, tmp_path_factory):
    """``catalog_setup`` started in a thread at once (it runs beside the
    toolkit case, which asks for this fixture first)."""
    d = tmp_path_factory.mktemp("catalog")
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(catalog_setup, granule.scene, d)
    shutil.rmtree(d, ignore_errors=True)


def test_toolkit(card, granule, catalog, workdir):
    """``merge_emit`` on the card of the two granules, cold then warm: two
    runs equal, the mosaic (H, W, 285) valid on > 0.3 of its cells, >
    0.05 filled by the second granule, and ``array_equal`` to
    ``merge_emit(device="cpu")`` on the same grid; ``spatial_subset`` of
    the first granule over a box of 0.3-0.7 of its footprint, whose ortho
    on the card equals the full ortho's crop on every valid cell;
    ``ortho_browse`` of a u8 RGB equal to the card's gather."""
    from hyperres_torch.catalog.geometry import LonLatPolygon
    from hyperres_torch.core.constants import GLT_NODATA_VALUE, NO_DATA_VALUE
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.kernels.glt import orthorectify
    from hyperres_torch.kernels.warp import resample_tensor_to_grid
    from hyperres_torch.ortho.toolkit import (
        merge_emit, ortho_browse, spatial_subset,
    )
    from hyperres_torch.testing.scenes import make_scene

    scene = granule.scene
    cx, cy = scene.swath_center_utm
    half = TOOLKIT_S2_PX * 10.0 / 2.0
    scene2 = make_scene(
        workdir / "scene2", raw_shape=ORTHO_RAW, n_bands=ORTHO_BANDS,
        compress_granule=False, s2_size=TOOLKIT_S2_PX, seed=TOOLKIT_SEED,
        s2_origin=(cx + TOOLKIT_SHIFT_M[0] - half,
                   cy + TOOLKIT_SHIFT_M[1] + half))
    with EmitGranule(scene.emit_nc_path) as g1, \
            EmitGranule(scene2.emit_nc_path) as g2:
        mosaic, grid = merge_emit([g1, g2])
        again, _ = merge_emit([g1, g2])
        assert np.array_equal(mosaic, again)
        del again
        valid = mosaic[..., 0] != NO_DATA_VALUE
        # the first granule's cells, placed as merge_emit places them:
        # the mosaic's other valid cells are the second granule's
        band0 = orthorectify(g1.read_bands(0, 1), g1.glt, device=card)
        first = (resample_tensor_to_grid(
            band0, g1.ortho_grid, grid, method="nearest",
            nodata=NO_DATA_VALUE, fill=NO_DATA_VALUE)[..., 0]
            != NO_DATA_VALUE).cpu().numpy()
        assert mosaic.shape == (grid.height, grid.width, ORTHO_BANDS)
        assert valid.mean() > 0.3 and float((valid & ~first).mean()) > 0.05
        cpu, cgrid = merge_emit([g1, g2], device="cpu")
        assert np.array_equal(mosaic, cpu)
        assert dataclasses.astuple(cgrid) == dataclasses.astuple(grid)
        del cpu, mosaic, valid, first

        og = g1.ortho_grid
        le, b, r, t = og.bounds
        mx, my = (le + r) / 2, (b + t) / 2
        hx, hy = (r - le) * TOOLKIT_SUBSET_HALF, (t - b) * TOOLKIT_SUBSET_HALF
        poly = LonLatPolygon.from_bounds(mx - hx, my - hy, mx + hx, my + hy)
        sub = spatial_subset(g1, poly)
        lon, lat = np.meshgrid(*og.pixel_center_coords())
        gvalid = np.all(g1.glt != GLT_NODATA_VALUE, axis=-1)
        share = float((gvalid & poly.contains_points(lon, lat)).sum()
                      / gvalid.sum())
        full = orthorectify(g1.read_cube(), g1.glt, device=card)
        so = orthorectify(sub.data, sub.glt, device=card)
        oy0 = round((og.y0 - sub.ortho_grid.y0) / og.dy)
        ox0 = round((sub.ortho_grid.x0 - og.x0) / og.dx)
        crop = full[oy0:oy0 + sub.ortho_grid.height,
                    ox0:ox0 + sub.ortho_grid.width]
        ok = so[..., 0] != NO_DATA_VALUE
        assert 0.3 < share < 0.7 and int(ok.sum()) > 0, share
        assert torch.equal(so[ok], crop[ok])
        del full, so, crop, ok, sub

        wl = np.asarray(g1.wavelengths)
        idx = [int(np.argmin(np.abs(wl - w))) for w in (650.0, 560.0, 470.0)]
        rgb = np.concatenate([g1.read_bands(i, i + 1) for i in idx], axis=-1)
        rgb = np.clip(rgb / 0.4 * 255.0, 0, 255).astype(np.uint8)
        browse = ortho_browse(rgb, g1.glt)
        want = orthorectify(rgb.astype(np.float32), g1.glt, fill_value=0.0,
                            device=card).clamp(0, 255).to(torch.uint8)
        assert browse.dtype == np.uint8
        assert np.array_equal(browse, want.cpu().numpy())


def test_discover_pairs(catalog):
    """``discover_pairs`` over ``catalog_setup``'s canned responses and
    SCL rasters through the injected ``fetch_json`` / ``download``: one
    entry a date, the pairs kept those the whole-file counts say (each
    match day's full-tile acquisition in the days window with the least
    cloud, kept within ``max_s2_cloud_frac``); ``open_remote_scl``'s
    ranged reads (``fetch_range``) of each SCL it counted equal the whole
    read, on the tile's grid."""
    from hyperres_torch.catalog import (
        CmrClient, StacClient, discover_pairs, open_remote_scl,
    )
    from hyperres_torch.catalog.clients import CMR_GRANULE_SEARCH
    from hyperres_torch.core.config import PairSearchConfig
    from hyperres_torch.io.tiff import TiffReader

    setup = catalog.result()
    cfg, cat = PairSearchConfig(), setup["cat"]
    scl_paths, expected = setup["scl_paths"], setup["expected"]

    def path_of(href):
        return scl_paths[int(href.rsplit("/", 1)[-1][:2])]

    downloads = []

    def fetch_json(url, params=None, method="GET", body=None, **kw):
        if url == CMR_GRANULE_SEARCH:
            page = cat / "cmr" / f"page_{params['page_num']}.json"
            return json.loads(page.read_text()) if page.exists() else {
                "items": []}
        lo, hi = body["datetime"].split("/")
        bl, bb, br, bt = body["bbox"]
        keep = [it for it in json.loads((cat / "stac_items.json").read_text())
                if lo <= it["properties"]["datetime"] <= hi
                and it["bbox"][0] <= br and it["bbox"][2] >= bl
                and it["bbox"][1] <= bt and it["bbox"][3] >= bb]
        return {"features": keep, "links": []}

    def download(url, dst):
        downloads.append(url)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path_of(url), dst)
        return dst

    pairs = discover_pairs(
        cmr=CmrClient(fetch_json=fetch_json, download=download),
        stac=StacClient(cfg.stac_api, fetch_json=fetch_json,
                        download=download),
        bbox=setup["emit_geom"].bounds(),
        temporal=(iso(T0_DAY), iso(T0_DAY + dt.timedelta(
            days=CATALOG_DATES + 1))),
        config=cfg, workdir=setup["workdir"] / "scl_cache")
    # (the S2 time, 10:00, lies past the days window's end on its last day)
    want = {}
    for day in CATALOG_MATCH_DAYS:
        date = (T0_DAY + dt.timedelta(days=day)).date().isoformat()
        cands = [d for d in expected if abs(d - day) <= cfg.days_window
                 and d != day + cfg.days_window]
        best = min(cands, key=lambda d: expected[d])
        want[date] = (f"S2_T33_{best:02d}_full", expected[best],
                      expected[best] <= cfg.max_s2_cloud_frac)
    got = {p["date"]: (p["s2_item"]["id"], p["cloud_frac"], p["kept"])
           for p in pairs if p["s2_item"] is not None}
    assert got == want
    assert [p["date"] for p in pairs] == sorted(
        {(T0_DAY + dt.timedelta(days=d)).date().isoformat()
         for d in range(1, CATALOG_DATES + 1)})
    assert not any(p["kept"] for p in pairs if p["date"] not in want)

    def fetch_range(url, start, end):
        with open(path_of(url), "rb") as f:
            f.seek(start)
            return f.read(end - start + 1)

    for url in downloads:
        arr, grid = open_remote_scl(url, fetch_range=fetch_range)
        with TiffReader(path_of(url)) as rd:
            assert np.array_equal(arr, rd.read()[0])
            assert grid == rd.grid == setup["tile"]

"""The port's paired tiling (``hyperres_torch.tiling``) against the JAX
reference on the CPU, on rasters made with NumPy from a seed and on
GeoTIFFs the test writes; the port runs with ``device="cpu"``.

Tolerances: the black masks and per-tile fractions are equal (the same
f32 comparisons; each fraction an exact count divided once); the tile
lists equal (windows, fractions, order, ``max_tiles``); the tile
GeoTIFFs decode to equal arrays (the EMIT tile's u16 codes within one
code: both packages compute ``rint(x * scale)`` in f32, but the bound
allows a different rounding of a tie); the ``_b32`` subsets the same
indices and data."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres.tiling import tiles as jtiles  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.io.tiff import TiffReader, write_geotiff  # noqa: E402
from hyperres_torch.tiling import tiles as ttiles  # noqa: E402

NODATA_U16 = 65535


def _raster(rng, b, h, w, nodata=None):
    """Reflectance-like (B, H, W) f32 with planted black pixels: all
    bands at nodata (if given), at the masked value -0.01, at 0, and
    near misses of each."""
    a = (0.05 + 0.5 * rng.random((b, h, w))).astype(np.float32)
    pick = rng.random((h, w))
    if nodata is not None:
        a[:, pick < 0.05] = nodata
        a[0, (pick >= 0.05) & (pick < 0.06)] = nodata + 2e-3
    a[:, (pick >= 0.1) & (pick < 0.14)] = -0.01
    a[:, (pick >= 0.2) & (pick < 0.25)] = 0.0
    a[1, (pick >= 0.25) & (pick < 0.27)] = 5e-7
    a[-1, (pick >= 0.3) & (pick < 0.32)] = -0.0105
    return a


@pytest.mark.parametrize("nodata", [None, -9999.0, 65535.0])
def test_black_mask_and_fractions_equal(rng, nodata):
    """``is_black_mask`` and ``tile_black_fractions`` (tiles of 8 and
    of 10 px, the latter with ragged edges): equal to the reference's."""
    a = _raster(rng, 4, 43, 57, nodata)
    got = ttiles.is_black_mask(torch.from_numpy(a), nodata)
    want = np.asarray(jtiles.is_black_mask(jnp.asarray(a), nodata))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    for tile in (8, 10):
        f = ttiles.tile_black_fractions(got, tile)
        assert f.dtype == torch.float32
        np.testing.assert_array_equal(
            f.numpy(), np.asarray(jtiles.tile_black_fractions(
                jnp.asarray(want), tile)))


def _pair(rng, he=40, we=52, scale=3):
    """An EMIT-like (6, he, we) and an S2-like (3, he*scale - 2, we*scale)
    raster (the S2 side one row short of the last tile)."""
    emit = _raster(rng, 6, he, we, -9999.0)
    s2 = _raster(rng, 3, he * scale - 2, we * scale)
    emit[:, :, :8] = 0.2  # a clean band of tiles
    s2[:, :, :8 * scale] = 0.3
    return emit, s2


def _plain(tiles):
    return [{k: (vars(v) if hasattr(v, "col_off") else v)
             for k, v in t.items()} for t in tiles]


@pytest.mark.parametrize("frac,max_tiles", [(0.0, None), (0.35, None),
                                            (0.35, 3), (1.0, 5)])
def test_find_valid_paired_tiles_equal(rng, frac, max_tiles):
    """The same tile list (order, windows, fractions, index) from
    in-memory arrays, at several thresholds and ``max_tiles``."""
    emit, s2 = _pair(rng)
    kw = dict(emit_tile_size=8, scale=3, max_black_frac=frac,
              max_tiles=max_tiles, emit_nodata=-9999.0)
    got = ttiles.find_valid_paired_tiles(emit, s2, device="cpu", **kw)
    want = jtiles.find_valid_paired_tiles(emit, s2, **kw)
    assert _plain(got) == _plain(want)
    assert got and all(type(t["emit_window"]).__module__.startswith(
        "hyperres_torch") for t in got)
    if max_tiles is not None:
        assert len(got) == max_tiles


@pytest.fixture
def tile_files(tmp_path, rng):
    """The pair as GeoTIFFs: EMIT f32 with nodata -9999, tags and
    descriptions; S2 u16 on a 3x finer grid."""
    emit, s2 = _pair(rng)
    utm = CRS.utm(33, True)
    ge = Grid(utm, 400000.0, 5800000.0, 30.0, 30.0, emit.shape[2],
              emit.shape[1])
    gs = Grid(utm, 400000.0, 5800000.0, 10.0, 10.0, s2.shape[2],
              s2.shape[1])
    ep, sp = tmp_path / "emit.tif", tmp_path / "s2.tif"
    write_geotiff(ep, emit, ge, nodata=-9999.0,
                  descriptions=[f"{400 + 10 * i}.00 nm" for i in range(6)],
                  tags={"units": "reflectance"},
                  band_tags=[{"fwhm": str(i)} for i in range(6)])
    write_geotiff(sp, (s2 * 10000).astype(np.uint16), gs, nodata=0,
                  descriptions=["B02_blue", "B03_green", "B04_red"])
    return ep, sp


def test_tiles_from_files_save_and_b32_equal(tile_files, tmp_path):
    """From GeoTIFFs: the same tiles; each saved pair decodes to the
    reference's (EMIT codes within one, S2 equal, same grids, nodata,
    descriptions, tags); the ``_b32`` subset (here 4 of 6 bands) the same
    indices, data and descriptions."""
    ep, sp = tile_files
    kw = dict(emit_tile_size=8, scale=3, max_black_frac=0.35)
    got = ttiles.find_valid_paired_tiles(ep, sp, device="cpu", **kw)
    want = jtiles.find_valid_paired_tiles(ep, sp, **kw)
    assert _plain(got) == _plain(want) and len(got) >= 3
    for g, w in zip(got[:3], want[:3]):
        te, ts = ttiles.save_tile_pair(ep, sp, g, tmp_path / "port",
                                       device="cpu")
        je, js = jtiles.save_tile_pair(ep, sp, w, tmp_path / "jax")
        assert (te.name, ts.name) == (je.name, js.name)
        for a, b, codes in ((te, je, 1), (ts, js, 0)):
            with TiffReader(a) as ra, TiffReader(b) as rb:
                qa, qb = ra.read(), rb.read()
                assert qa.dtype == qb.dtype
                assert (ra.grid, ra.nodata, ra.descriptions,
                        ra.dataset_tags, ra.band_tags) == (
                    rb.grid, rb.nodata, rb.descriptions, rb.dataset_tags,
                    rb.band_tags)
            d = np.abs(qa.astype(np.int64) - qb.astype(np.int64))
            assert d.max() <= codes
            np.testing.assert_array_equal(qa == NODATA_U16,
                                          qb == NODATA_U16)
        tb, ti = ttiles.write_emit_b32_tile(te, num_keep=4)
        jb, ji = jtiles.write_emit_b32_tile(je, num_keep=4)
        np.testing.assert_array_equal(ti, ji)
        assert tb.name == jb.name == te.stem + "_b4.tif"
        with TiffReader(tb) as ra, TiffReader(jb) as rb:
            np.testing.assert_array_equal(ra.read(), rb.read())
            assert ra.descriptions == rb.descriptions
    with pytest.raises(ValueError, match="only 6 bands"):
        ttiles.write_emit_b32_tile(te, num_keep=7)
    # the caches: an existing pair is kept without overwrite
    assert ttiles.save_tile_pair(ep, sp, got[0], tmp_path / "port",
                                 overwrite=False, device="cpu") == (
        tmp_path / "port" / "tile_000_emit.tif",
        tmp_path / "port" / "tile_000_s2.tif")

"""The port's granule toolkit (``hyperres_torch.ortho.toolkit``) against
``hyperres.ortho.toolkit`` on the same granules: ``spatial_subset`` and
``ortho_browse`` (host code in both packages) and ``merge_emit``
(``device="cpu"`` here; the port gathers, places and composites on the
device, the reference on the host after each granule).

Tolerance: exact equality (``array_equal``) everywhere: the GLT gather
and the nearest-neighbour placement copy values, and both sides pick the
same source cells (the placement's index fields are the same float64
NumPy code)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hyperres.catalog.geometry import LonLatPolygon as JPolygon  # noqa: E402
from hyperres.core.crs import CRS as JCRS  # noqa: E402
from hyperres.core.grid import Grid as JGrid  # noqa: E402
from hyperres.io.granule import EmitGranule as JGranule  # noqa: E402
from hyperres.ortho import toolkit as jtk  # noqa: E402
from hyperres.testing.scenes import make_scene  # noqa: E402

from hyperres_torch.catalog.geometry import LonLatPolygon as TPolygon  # noqa: E402
from hyperres_torch.core.crs import CRS as TCRS  # noqa: E402
from hyperres_torch.core.grid import Grid as TGrid  # noqa: E402
from hyperres_torch.io.granule import EmitGranule as TGranule  # noqa: E402
from hyperres_torch.io.granule import apply_glt  # noqa: E402
from hyperres_torch.ortho import toolkit as ttk  # noqa: E402


def _t(grid):
    return dataclasses.astuple(grid)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two small ``make_scene`` granules (12 bands; the second rotated
    35 degrees, partly overlapping the first) and an 8-band one."""
    d = tmp_path_factory.mktemp("tk")
    return {
        "a": make_scene(d / "a", raw_shape=(40, 46), n_bands=12, s2_size=200,
                        seed=1),
        "b": make_scene(d / "b", raw_shape=(36, 40), n_bands=12, s2_size=200,
                        seed=2, swath_angle_deg=35.0,
                        s2_origin=(400560.0, 5799420.0)),
        "c8": make_scene(d / "c", raw_shape=(20, 24), n_bands=8, s2_size=100),
    }


def test_raw_subset_is_the_ports_own():
    """``RawSubset`` is defined in the port, not re-exported."""
    assert ttk.RawSubset.__module__ == "hyperres_torch.ortho.toolkit"
    assert ttk.RawSubset is not jtk.RawSubset


def _centre_box(og, frac, shift=(0.0, 0.0)):
    le, b, r, t = og.bounds
    cx = (le + r) / 2 + shift[0] * (r - le)
    cy = (b + t) / 2 + shift[1] * (t - b)
    return (cx - (r - le) * frac, cy - (t - b) * frac,
            cx + (r - le) * frac, cy + (t - b) * frac)


@pytest.mark.parametrize("frac,shift", [(1 / 6, (0.0, 0.0)),
                                        (0.25, (0.2, -0.1)),
                                        (0.4, (-0.3, 0.3))])
def test_spatial_subset_equal(scenes, frac, shift):
    """The subset's data, re-based GLT, cropped ortho grid and raw window
    equal JAX's; orthorectifying the subset through its GLT equals the
    full granule's ortho cropped to the subset grid on every valid cell
    (``tests/test_toolkit_s2stack.py:93``)."""
    sc = scenes["a"]
    with JGranule(sc.emit_nc_path) as jg, TGranule(sc.emit_nc_path) as tg:
        box = _centre_box(tg.ortho_grid, frac, shift)
        want = jtk.spatial_subset(jg, JPolygon.from_bounds(*box))
        got = ttk.spatial_subset(tg, TPolygon.from_bounds(*box))
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.glt, want.glt)
        assert _t(got.ortho_grid) == _t(want.ortho_grid)
        assert got.raw_window == want.raw_window
        assert got.data.dtype == want.data.dtype
        og = tg.ortho_grid
        full = apply_glt(tg.read_cube(), tg.glt)
        sub = apply_glt(got.data, got.glt)
        oy0 = round((og.y0 - got.ortho_grid.y0) / og.dy)
        ox0 = round((got.ortho_grid.x0 - og.x0) / og.dx)
        crop = full[oy0:oy0 + got.ortho_grid.height,
                    ox0:ox0 + got.ortho_grid.width]
        valid = sub[..., 0] != -9999.0
        np.testing.assert_array_equal(sub[valid], crop[valid])
        assert valid.mean() > 0.3


def test_spatial_subset_empty_polygon(scenes):
    """A polygon that selects no valid GLT cell raises ValueError, as in
    JAX."""
    far = (100.0, 10.0, 101.0, 11.0)
    sc = scenes["c8"]
    with JGranule(sc.emit_nc_path) as jg, TGranule(sc.emit_nc_path) as tg:
        with pytest.raises(ValueError, match="no valid GLT"):
            jtk.spatial_subset(jg, JPolygon.from_bounds(*far))
        with pytest.raises(ValueError, match="no valid GLT"):
            ttk.spatial_subset(tg, TPolygon.from_bounds(*far))


@pytest.mark.parametrize("order", ["ab", "ba"])
def test_merge_emit_two_granules_equal(scenes, order):
    """``merge_emit`` of two partly overlapping granules, in both orders
    (first wins): the mosaic equals JAX's (``array_equal``, float32) and
    the grid is the same; the mosaic covers both footprints, and both
    granules fill cells."""
    names = list(order)
    paths = [scenes[n].emit_nc_path for n in names]
    jgs = [JGranule(p) for p in paths]
    tgs = [TGranule(p) for p in paths]
    try:
        want, wgrid = jtk.merge_emit(jgs)
        got, grid = ttk.merge_emit(tgs, device="cpu")
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert _t(grid) == _t(wgrid)
        ml, mb, mr, mt = grid.bounds
        for g in tgs:
            gl, gb, gr, gt = g.ortho_grid.bounds
            assert ml <= gl and mr >= gr and mb <= gb and mt >= gt
        alone, _ = ttk.merge_emit(tgs[:1], device="cpu",
                                  resolution_deg=(grid.dx, grid.dy))
        valid = got[..., 0] != -9999.0
        assert valid.mean() > 0.2
        assert valid.sum() > (alone[..., 0] != -9999.0).sum()
    finally:
        for g in jgs + tgs:
            g.close()


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_merge_emit_resolution_deg_equal(scenes, scale):
    """An explicit ``resolution_deg`` (the granules' own, and 2.5 times
    coarser) gives JAX's mosaic and grid."""
    paths = [scenes["a"].emit_nc_path, scenes["b"].emit_nc_path]
    jgs = [JGranule(p) for p in paths]
    tgs = [TGranule(p) for p in paths]
    try:
        res = (tgs[0].ortho_grid.dx * scale, tgs[0].ortho_grid.dy * scale)
        want, wgrid = jtk.merge_emit(jgs, resolution_deg=res)
        got, grid = ttk.merge_emit(tgs, resolution_deg=res, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert _t(grid) == _t(wgrid)
    finally:
        for g in jgs + tgs:
            g.close()


class _FakeGranule:
    """Duck-typed granule with an identity GLT, for exact placement."""

    def __init__(self, cube, grid):
        self._cube = cube
        self.ortho_grid = grid
        self.n_bands = cube.shape[-1]
        h, w = cube.shape[:2]
        glt = np.zeros((h, w, 2), dtype=np.int32)
        glt[..., 0] = np.arange(w)[None, :] + 1
        glt[..., 1] = np.arange(h)[:, None] + 1
        self.glt = glt

    def read_cube(self):
        return self._cube


def _fakes(cubes_grids):
    """The same fake granules on JAX grids and on the port's."""
    js, ts = [], []
    for cube, (x0, y0, dx, dy) in cubes_grids:
        h, w = cube.shape[:2]
        js.append(_FakeGranule(cube, JGrid(JCRS.geographic(), x0, y0, dx, dy,
                                           w, h)))
        ts.append(_FakeGranule(cube, TGrid(TCRS.geographic(), x0, y0, dx, dy,
                                           w, h)))
    return js, ts


def test_merge_emit_off_lattice_exact_nearest_placement():
    """An off-lattice second granule (shifted 10.4 cells) lands by
    per-destination nearest sampling: equal to JAX's and to the oracle
    (the first granule that covers a cell gives its nearest source
    cell), with no smeared border."""
    h, w = 10, 10
    vals = (np.arange(h)[:, None] * 100.0
            + np.arange(w)[None, :]).astype(np.float32)
    cube_a = np.stack([vals, vals + 0.5], axis=-1)
    cube_b = cube_a + 5000.0
    js, ts = _fakes([(cube_a, (0.0, 10.0, 1.0, 1.0)),
                     (cube_b, (10.4, 10.0, 1.0, 1.0))])
    want, _ = jtk.merge_emit(js)
    got, grid = ttk.merge_emit(ts, device="cpu")
    np.testing.assert_array_equal(got, want)
    oracle = np.full(got.shape, -9999.0, dtype=np.float32)
    xs, ys = grid.pixel_center_coords()
    for g, cube in zip(ts, (cube_a, cube_b)):
        gr = g.ortho_grid
        ci = np.round((xs - gr.x0) / gr.dx - 0.5).astype(int)
        ri = np.round((gr.y0 - ys) / gr.dy - 0.5).astype(int)
        for i, r in enumerate(ri):
            for j, c in enumerate(ci):
                if (0 <= r < gr.height and 0 <= c < gr.width
                        and oracle[i, j, 0] == -9999.0):
                    oracle[i, j] = cube[r, c]
    np.testing.assert_array_equal(got, oracle)
    edge = got[:, -1, 0]
    valid = edge != -9999.0
    assert len(np.unique(edge[valid])) == valid.sum()


def test_merge_emit_out_of_bounds_clipped_not_smeared():
    """A granule hanging past the mosaic snapped by a coarse
    ``resolution_deg`` drops its outside cells (no smear onto the edge):
    equal to JAX's."""
    cube = np.full((8, 8, 1), 7.0, dtype=np.float32)
    cube[0, :, 0] = 1.0
    cube[-1, :, 0] = 2.0
    cube_b = np.full((8, 8, 1), 9.0, dtype=np.float32)
    js, ts = _fakes([(cube, (0.0, 8.0, 1.0, 1.0)),
                     (cube_b, (0.0, 4.4, 1.0, 1.0))])
    for res in (None, (1.5, 1.5), (3.0, 2.0)):
        want, wgrid = jtk.merge_emit(js, resolution_deg=res)
        got, grid = ttk.merge_emit(ts, resolution_deg=res, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert _t(grid) == _t(wgrid)
    got, grid = ttk.merge_emit(ts, device="cpu")
    assert grid.bounds[1] <= ts[1].ortho_grid.bounds[1] + 1e-9
    assert set(np.unique(got[-1, :, 0])).issubset({9.0, -9999.0})


def test_merge_emit_nodata_sources_and_first_wins(rng):
    """Source cells at -9999 (and invalid GLT cells) never overwrite a
    mosaic cell; where two granules cover a cell the first one's value
    stays: equal to JAX's on seeded cubes."""
    a = rng.random((12, 14, 3)).astype(np.float32)
    b = rng.random((12, 14, 3)).astype(np.float32) + 10.0
    a[rng.random((12, 14)) < 0.2] = -9999.0
    js, ts = _fakes([(a, (0.0, 12.0, 1.0, 1.0)), (b, (3.0, 9.0, 1.0, 1.0))])
    for g in js + ts:
        g.glt[0, :3] = 0
    want, _ = jtk.merge_emit(js)
    got, _ = ttk.merge_emit(ts, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] >= 10.0).any() and ((got[..., 0] >= 0)
                                            & (got[..., 0] < 1)).any()


def test_merge_emit_errors(scenes):
    """An empty list and differing band counts raise ValueError with
    JAX's messages."""
    with pytest.raises(ValueError, match="No granules"):
        ttk.merge_emit([], device="cpu")
    sc8, sc12 = scenes["c8"], scenes["a"]
    with TGranule(sc8.emit_nc_path) as g1, TGranule(sc12.emit_nc_path) as g2:
        with pytest.raises(ValueError, match="differing band counts"):
            ttk.merge_emit([g1, g2], device="cpu")
    with JGranule(sc8.emit_nc_path) as g1, JGranule(sc12.emit_nc_path) as g2:
        with pytest.raises(ValueError, match="differing band counts"):
            jtk.merge_emit([g1, g2])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_ortho_browse_equal(rng, dtype):
    """``ortho_browse`` of a u8 and an f32 RGB through a seeded GLT
    (with nodata and out-of-bounds entries) equals JAX's, dtype kept."""
    if dtype == "uint8":
        rgb = (rng.random((12, 14, 3)) * 255).astype(np.uint8)
    else:
        rgb = rng.random((12, 14, 3)).astype(np.float32)
    glt = np.stack([rng.integers(0, 16, (16, 18)),
                    rng.integers(0, 14, (16, 18))], axis=-1).astype(np.int32)
    glt[4, 5] = (3, 2)
    for fill in (0.0, -9999.0):
        got = ttk.ortho_browse(rgb, glt, fill=fill)
        want = jtk.ortho_browse(rgb, glt, fill=fill)
        assert got.dtype == want.dtype == rgb.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttk.ortho_browse(rgb, glt)[4, 5], rgb[1, 2])

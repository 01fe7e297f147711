"""The port's copies of ``hyperres.core`` (constants, CRS, Grid, the
config dataclasses) against the originals on the CPU: the same defaults,
the same constants and the same float64 projection and grid arithmetic,
bit for bit (both run the same NumPy code, so any difference is a
fault, not rounding)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres.core import config as jconfig  # noqa: E402
from hyperres.core import constants as jconstants  # noqa: E402
from hyperres.core import crs as jcrs  # noqa: E402
from hyperres.core import grid as jgrid  # noqa: E402
from hyperres_torch.core import config as tconfig  # noqa: E402
from hyperres_torch.core import constants as tconstants  # noqa: E402
from hyperres_torch.core import crs as tcrs  # noqa: E402
from hyperres_torch.core import grid as tgrid  # noqa: E402

CONFIGS = [n for n, v in vars(jconfig).items()
           if dataclasses.is_dataclass(v) and v.__module__ == jconfig.__name__]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_equal(name):
    """Every config dataclass of the copy has the original's fields and
    defaults (``dataclasses.asdict`` equal), and is the port's own
    class."""
    t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert type(t).__module__ == tconfig.__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_constants_equal():
    """Every public constant of the copy equals the original's, and
    there are no others."""
    names = [n for n in vars(jconstants) if n.isupper()]
    assert names and names == [n for n in vars(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


def _points(rng, n=500):
    lon = rng.uniform(12.0, 18.0, n)
    lat = rng.uniform(-60.0, 70.0, n)
    return lon, lat


@pytest.mark.parametrize("maker", [("utm", (33, True)), ("utm", (33, False)),
                                   ("geographic", ()), ("cea6933", ()),
                                   ("from_epsg", (32632,))])
def test_crs_transforms_equal(maker, rng):
    """CRS.to_geographic / from_geographic / transform, epsg, str and
    WKT of the copy == the original's on seeded points (array_equal)."""
    fn, args = maker
    t, j = getattr(tcrs.CRS, fn)(*args), getattr(jcrs.CRS, fn)(*args)
    assert (t.epsg, str(t), t.to_wkt()) == (j.epsg, str(j), j.to_wkt())
    lon, lat = _points(rng)
    x, y = t.from_geographic(lon, lat)
    for a, b in zip((x, y), j.from_geographic(lon, lat)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcrs.transform(tcrs.CRS.geographic(), t, lon, lat),
                    jcrs.transform(jcrs.CRS.geographic(), j, lon, lat)):
        np.testing.assert_array_equal(a, b)
    if t.kind == "cea6933":   # forward only, in both packages
        return
    for a, b in zip(t.to_geographic(x, y), j.to_geographic(x, y)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcrs.transform(t, tcrs.CRS.utm(32, True), x, y),
                    jcrs.transform(j, jcrs.CRS.utm(32, True), x, y)):
        np.testing.assert_array_equal(a, b)


def test_grid_methods_equal(rng):
    """The Grid methods and helpers the ortho path uses (geotransform,
    bounds, pixel centres, xy_of / colrow_of, bounds_in, windows and the
    S2-anchored target grid) agree with the original's."""
    def grids(crs_mod, grid_mod):
        geo = grid_mod.Grid(crs_mod.CRS.geographic(), 13.5, 52.35, 0.0009,
                            0.0006, 140, 90)
        s2 = grid_mod.Grid(crs_mod.CRS.utm(33, True), 399960.0, 5800020.0,
                           10.0, 10.0, 720, 720)
        return geo, s2

    (tgeo, ts2), (jgeo, js2) = grids(tcrs, tgrid), grids(jcrs, jgrid)
    for t, j in ((tgeo, jgeo), (ts2, js2)):
        assert (t.geotransform, t.shape, t.bounds) == (j.geotransform,
                                                       j.shape, j.bounds)
        for a, b in zip(t.pixel_center_coords(), j.pixel_center_coords()):
            np.testing.assert_array_equal(a, b)
        col, row = rng.uniform(-5, 100, 300), rng.uniform(-5, 80, 300)
        for a, b in zip(t.xy_of(col, row), j.xy_of(col, row)):
            np.testing.assert_array_equal(a, b)
        x, y = t.xy_of(col, row)
        for a, b in zip(t.colrow_of(x, y), j.colrow_of(x, y)):
            np.testing.assert_array_equal(a, b)
    assert (tgeo.bounds_in(ts2.crs) == jgeo.bounds_in(js2.crs))
    tw, jw = ts2.window_of(ts2.bounds), js2.window_of(js2.bounds)
    assert dataclasses.astuple(tw) == dataclasses.astuple(jw)
    for res in (60.0, 30.0):
        t = tgrid.s2_anchored_target_grid(tgeo, ts2, res, res)
        j = jgrid.s2_anchored_target_grid(jgeo, js2, res, res)
        assert (t.geotransform, t.shape, str(t.crs)) == (j.geotransform,
                                                         j.shape, str(j.crs))

"""The port's gather warps, the tap-loop orthowarp, the generic two-pass
warp and ``resample_to_grid`` (``hyperres_torch.kernels.warp``) against
the JAX reference on the CPU. Inputs are made with NumPy from a seed and
given to both; the port runs with ``device="cpu"`` (its scanline passes
through the kernel's plain version). The kernel itself runs only on a
CUDA device (on the card: tests_gpu/).

Tolerances: the gather kernels sum the same <= 16 f32 tap products in
the same order, differing by FMA contraction and the cubic weights'
``x ** 3`` (atol 2e-6 on values < 1); the two-pass warps and the dense
separable products sum in another order (atol 1e-5, as
test_torch_warp.py states for the two-pass warp); the block mean 2e-6.
Where holes take part of a pixel's taps, the result is a quotient by the
valid weight mass m (cubic weights are signed, so m can be small), and
the rounding of numerator and mass grows by 1 / m: there the bound is
atol / m for m >= 0.05; below that only the count of such pixels that
are not fill is bounded (< 2 %), and a pixel's fill state may differ only where |m| lies
within rounding of the 1e-6 threshold (|m| < 1e-4)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres.core.crs import CRS as JCRS  # noqa: E402
from hyperres.core.grid import Grid as JGrid  # noqa: E402
from hyperres.kernels import glt as jglt  # noqa: E402
from hyperres.kernels import warp as jwarp  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.kernels import banded  # noqa: E402
from hyperres_torch.kernels import glt as tglt  # noqa: E402
from hyperres_torch.kernels import host  # noqa: E402
from hyperres_torch.kernels import warp as twarp  # noqa: E402

T = torch.from_numpy
GATHER_ATOL = 2e-6
TWO_PASS_ATOL = 1e-5
NODATA = -9999.0


def _both(kind, *args):
    """The same grid in both packages' classes."""
    if kind == "utm":
        return (Grid(CRS.utm(33, True), *args),
                JGrid(JCRS.utm(33, True), *args))
    return (Grid(CRS.geographic(), *args),
            JGrid(JCRS.geographic(), *args))


def _geo_to_utm(n_src=90, n_dst=70):
    """A geographic source around (15E, 52N) and a 60 m UTM destination
    inside it (a cross-CRS pair with a monotone row field)."""
    tgeo, jgeo = _both("geo", 14.95, 52.05, 0.0009, 0.00055, n_src, n_src)
    gx, gy = tgeo.xy_of(n_src / 2.0, n_src / 2.0)
    ux, uy = CRS.utm(33, True).from_geographic(gx, gy)
    half = 60.0 * n_dst / 2.0
    tdst, jdst = _both("utm", float(ux) - 0.8 * half, float(uy) + 0.8 * half,
                       60.0, 60.0, n_dst, n_dst)
    return tgeo, jgeo, tdst, jdst


def _field(rng, shape=(40, 44), size=(60, 64)):
    """Fractional indices into a ``size`` source, some outside it."""
    rows = (rng.random(shape) * (size[0] + 6) - 3).astype(np.float32)
    cols = (rng.random(shape) * (size[1] + 6) - 3).astype(np.float32)
    return rows, cols


def _img(rng, size=(60, 64), b=5, holes=True):
    img = rng.random(size + (b,)).astype(np.float32)
    if holes:
        img[rng.random(img.shape) < 0.08] = NODATA
        img[rng.random(img.shape) < 0.02] = np.nan
    return img


def _close(got, want, atol, fill=NODATA, mass=None):
    """Same fill pixels (NaN fills compare as NaN), values to ``atol``;
    with ``mass`` (the valid weight mass per element, see the module
    docstring) to ``atol / mass``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32

    def is_fill(x):
        return np.isnan(x) if np.isnan(fill) else x == fill

    if mass is None:
        np.testing.assert_array_equal(is_fill(got), is_fill(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   equal_nan=True)
        return
    mass = np.abs(np.broadcast_to(np.nan_to_num(np.asarray(mass)),
                                  got.shape))
    sure = mass >= 1e-4
    np.testing.assert_array_equal(is_fill(got)[sure], is_fill(want)[sure])
    ok = (mass >= 0.05) & ~is_fill(want) & ~is_fill(got)
    assert ((mass < 0.05) & ~is_fill(want)).mean() < 0.02
    err = np.abs(got[ok] - want[ok]) * mass[ok]
    assert np.nanmax(err) <= atol, np.nanmax(err)
    np.testing.assert_array_equal(np.isnan(got[ok]), np.isnan(want[ok]))


def _valid_image(img, nodata):
    """1 where ``img`` is a valid source value, 0 at a hole."""
    ok = np.isfinite(img)
    if nodata is not None:
        ok &= img != nodata
    return ok.astype(np.float32)


def _mass(img, rows, cols, nodata, method):
    """The valid weight mass of each output element of a warp of
    ``img``: the validity image warped without a nodata value (the
    in-bounds weights divide out). 1 away from holes."""
    if nodata is None:
        return None
    return np.asarray(jwarp.warp_interpolate(
        jnp.asarray(_valid_image(img, nodata)), jnp.asarray(rows),
        jnp.asarray(cols), nodata=None, method=method, fill=0.0))


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def test_glt_gather_and_orthorectify(rng):
    """``glt_gather`` / ``orthorectify``: pure gathers, bit-equal."""
    raw = rng.random((30, 34, 6)).astype(np.float32)
    glt = rng.integers(0, 36, size=(41, 45, 2)).astype(np.int32)
    want = np.asarray(jglt.orthorectify(raw, glt))
    got = tglt.orthorectify(raw, glt, device="cpu")
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    flat, valid = host.prepare_glt(glt, (30, 34))
    np.testing.assert_array_equal(
        tglt.glt_gather(T(raw), T(flat), T(valid), 7.0).numpy(),
        np.asarray(jglt.glt_gather(jnp.asarray(raw), jnp.asarray(flat),
                                   jnp.asarray(valid), fill_value=7.0)))


@pytest.mark.parametrize("nodata", [None, NODATA])
def test_warp_nearest_matches_jax(nodata, rng):
    """Nearest: a gather, bit-equal (round half to even in both), with
    half-integer positions among the indices."""
    img = _img(rng, holes=nodata is not None)
    rows, cols = _field(rng)
    rows[:5] = np.round(rows[:5]) + 0.5
    cols[:, :5] = np.round(cols[:, :5]) - 0.5
    want = np.asarray(jwarp.warp_nearest(jnp.asarray(img), jnp.asarray(rows),
                                         jnp.asarray(cols), nodata=nodata,
                                         fill=-1.0))
    got = twarp.warp_nearest(T(img), T(rows), T(cols), nodata=nodata,
                             fill=-1.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nodata", [None, NODATA])
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_warp_interpolate_matches_jax(method, nodata, rng):
    """``warp_interpolate`` and its chunked form: GATHER_ATOL, the same
    fill pixels."""
    img = _img(rng, b=7, holes=nodata is not None)
    rows, cols = _field(rng)
    args = (jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols))
    want = np.asarray(jwarp.warp_interpolate(*args, nodata=nodata,
                                             method=method))
    got = twarp.warp_interpolate(T(img), T(rows), T(cols), nodata=nodata,
                                 method=method).numpy()
    mass = _mass(img, rows, cols, nodata, method)
    _close(got, want, GATHER_ATOL, mass=mass)
    chunked = twarp.warp_interpolate_chunked(
        T(img), T(rows), T(cols), nodata=nodata, method=method,
        band_chunk=3).numpy()
    np.testing.assert_array_equal(chunked, got)
    want_c = np.asarray(jwarp.warp_interpolate_chunked(
        *args, nodata=nodata, method=method, band_chunk=3))
    _close(chunked, want_c, GATHER_ATOL, mass=mass)


@pytest.mark.parametrize("nodata", [None, NODATA])
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_warp_interpolate_taploop_matches_jax(method, nodata, rng):
    """``warp_interpolate_taploop`` against JAX's: GATHER_ATOL."""
    img = _img(rng, b=6, holes=nodata is not None)
    rows, cols = _field(rng)
    want = np.asarray(jwarp.warp_interpolate_taploop(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols),
        nodata=nodata, method=method))
    got = twarp.warp_interpolate_taploop(T(img), T(rows), T(cols),
                                         nodata=nodata,
                                         method=method).numpy()
    _close(got, want, GATHER_ATOL, mass=_mass(img, rows, cols, nodata,
                                              method))


def _glt_case(rng, raw_shape=(50, 56), ortho=(64, 70), b=9):
    raw = rng.random(raw_shape + (b,)).astype(np.float32)
    glt = np.zeros(ortho + (2,), np.int32)
    valid = rng.random(ortho) > 0.15
    glt[..., 0] = np.where(valid, rng.integers(1, raw_shape[1] + 1, ortho), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, raw_shape[0] + 1, ortho), 0)
    flat, vmask = host.prepare_glt(glt, raw_shape)
    return raw, flat, vmask


@pytest.mark.parametrize("row_chunks", [1, 4])
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_orthowarp_taploop_matches_jax(method, row_chunks, rng):
    """``orthowarp_taploop`` against JAX's at the same ``row_chunks``
    (a destination height that the chunks do not divide): GATHER_ATOL,
    the same fill pixels; and bit-equal across ``row_chunks`` (the
    blocks only partition the rows)."""
    raw, flat, vmask = _glt_case(rng)
    rows, cols = _field(rng, shape=(37, 41), size=(64, 70))
    want = np.asarray(jwarp.orthowarp_taploop(
        jnp.asarray(raw), jnp.asarray(flat), jnp.asarray(vmask),
        jnp.asarray(rows), jnp.asarray(cols), method=method,
        row_chunks=row_chunks))
    got = twarp.orthowarp_taploop(T(raw), T(flat), T(vmask), T(rows),
                                  T(cols), method=method,
                                  row_chunks=row_chunks).numpy()
    mass = np.asarray(jwarp.warp_interpolate(
        jnp.asarray(vmask.astype(np.float32)[..., None]), jnp.asarray(rows),
        jnp.asarray(cols), method=method, fill=0.0))
    _close(got, want, GATHER_ATOL, mass=mass)
    one = twarp.orthowarp_taploop(T(raw), T(flat), T(vmask), T(rows),
                                  T(cols), method=method,
                                  row_chunks=7).numpy()
    np.testing.assert_array_equal(one, got)


def test_orthowarp_taploop_equals_gather_then_interpolate(rng):
    """The fused tap loop == glt_gather + warp_interpolate with the
    fill excluded by value (the reference's own statement of it), where
    the raw cube holds no fill value: GATHER_ATOL."""
    raw, flat, vmask = _glt_case(rng)
    rows, cols = _field(rng, shape=(37, 41), size=(64, 70))
    ortho = tglt.glt_gather(T(raw), T(flat), T(vmask))
    want = twarp.warp_interpolate(ortho, T(rows), T(cols), nodata=NODATA,
                                  method="cubic").numpy()
    got = twarp.orthowarp_taploop(T(raw), T(flat), T(vmask), T(rows),
                                  T(cols)).numpy()
    mass = twarp.warp_interpolate(
        T(vmask.astype(np.float32)[..., None]), T(rows), T(cols),
        method="cubic", fill=0.0).numpy()
    _close(got, want, GATHER_ATOL, mass=mass)


def test_block_average_matches_jax(rng):
    """Block mean with nodata and NaN holes, an empty block and a ragged
    edge: 2e-6 (36-term f32 sums in another order)."""
    img = _img(rng, size=(38, 44), b=4)
    img[6:12, 12:18] = NODATA
    for nodata in (None, NODATA):
        want = np.asarray(jwarp.block_average(jnp.asarray(img), 6,
                                              nodata=nodata, fill=-1.0))
        got = twarp.block_average(T(img), 6, nodata=nodata,
                                  fill=-1.0).numpy()
        assert got.shape == (6, 7, 4)
        if nodata is not None:
            assert (got[1, 2] == -1.0).all()
        _close(got, want, 2e-6 * (1 if nodata is not None else 1e4),
               fill=-1.0)


def test_integer_factor_copy():
    """The host copy of ``_integer_factor`` against the original."""
    cases = [((0.0, 0.0, 10.0, 10.0, 60, 60), (0.0, 0.0, 60.0, 60.0, 10, 10)),
             ((0.0, 0.0, 10.0, 10.0, 60, 60), (120.0, -60.0, 60.0, 60.0, 6, 6)),
             ((0.0, 0.0, 10.0, 10.0, 60, 60), (5.0, 0.0, 60.0, 60.0, 6, 6)),
             ((0.0, 0.0, 10.0, 10.0, 60, 60), (0.0, 0.0, 25.0, 25.0, 20, 20)),
             ((0.0, 0.0, 60.0, 60.0, 10, 10), (0.0, 0.0, 10.0, 10.0, 60, 60)),
             ((0.0, 0.0, 10.0, 10.0, 60, 60), (0.0, 0.0, 60.0, 30.0, 10, 20))]
    seen = set()
    for a, b in cases:
        (ts, js), (td, jd) = _both("utm", *a), _both("utm", *b)
        got = host.integer_factor(ts, td)
        assert got == jwarp._integer_factor(js, jd)
        seen.add(got)
    assert seen == {6, None}
    tgeo, jgeo, tdst, jdst = _geo_to_utm()
    assert host.integer_factor(tgeo, tdst) is None


# ---------------------------------------------------------------------------
# the generic two-pass warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodata", [None, NODATA])
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_warp_two_pass_matches_jax(method, nodata, rng):
    """``warp_two_pass`` (both scanline passes through the kernel's plain
    version) against JAX's dense two-pass einsums: TWO_PASS_ATOL, the
    same fill pixels. With a nodata value the source carries one
    validity channel per band (2 B channels) and the holes differ per
    band."""
    ho, wo, hd, wd = 70, 76, 60, 66
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.004 * j * r / hd + 0.3).astype(np.float32)
    cols = (j * (wo / wd) + 0.003 * r - 0.2).astype(np.float32)
    cstar = host.scanline_cstar(rows, cols, ho)
    img = _img(rng, size=(ho, wo), b=6, holes=nodata is not None)
    if nodata is not None:
        img[20:32, 24:38, 2] = NODATA      # a hole in one band alone
    want = np.asarray(jwarp.warp_two_pass(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(cstar), nodata=nodata, method=method,
        precision="highest"))
    got = twarp.warp_two_pass(T(img), T(rows), T(cols), T(cstar),
                              nodata=nodata, method=method).numpy()
    _close(got, want, TWO_PASS_ATOL, mass=_mass(img, rows, cols, nodata,
                                                method))
    if nodata is not None:
        # per-band validity: the fill pattern differs between bands
        assert ((got == NODATA).any(-1) & ~(got == NODATA).all(-1)).any()


def test_warp_two_pass_counts_two_launches(rng, monkeypatch):
    """``warp_two_pass`` makes exactly two scanline passes, axis 1 then
    axis 0, each over 2 B channels with a nodata value and B + 1
    without (on a CUDA tensor each is one launch of the kernel)."""
    calls = []
    orig = banded.scanline_resample

    def spy(src, pos, axis, method="cubic"):
        calls.append((axis, src.shape[-1]))
        return orig(src, pos, axis, method)

    monkeypatch.setattr(twarp, "scanline_resample", spy)
    rows = np.linspace(0.2, 28.7, 24, dtype=np.float32)[:, None].repeat(26, 1)
    cols = np.linspace(0.1, 30.6, 26, dtype=np.float32)[None, :].repeat(24, 0)
    cstar = host.scanline_cstar(rows, cols, 30)
    img = _img(rng, size=(30, 32), b=5)
    twarp.warp_two_pass(T(img), T(rows), T(cols), T(cstar), nodata=NODATA)
    twarp.warp_two_pass(T(img), T(rows), T(cols), T(cstar))
    assert calls == [(1, 10), (0, 10), (1, 6), (0, 6)]


# ---------------------------------------------------------------------------
# resample_to_grid, route by route
# ---------------------------------------------------------------------------

def _resample_both(data, tsrc, jsrc, tdst, jdst, **kw):
    want = jwarp.resample_to_grid(data, jsrc, jdst, **kw)
    got = twarp.resample_to_grid(data, tsrc, tdst, device="cpu", **kw)
    assert isinstance(got, np.ndarray)
    return got, np.asarray(want)


def _resample_mass(data, jsrc, jdst, nodata, method):
    """The valid weight mass of a ``resample_to_grid`` call (see
    :func:`_mass`), by the reference on the validity image."""
    if nodata is None:
        return None
    return jwarp.resample_to_grid(_valid_image(data, nodata), jsrc, jdst,
                                  method=method, fill=0.0, kernel="gather")


def _spy_routes(monkeypatch):
    """Record which device function ``resample_to_grid`` reaches."""
    seen = []
    for name in ("block_average", "separable_resample_matmul",
                 "warp_two_pass", "warp_nearest", "warp_interpolate"):
        orig = getattr(twarp, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(twarp, name, spy)
    return seen


def test_resample_average_integer_contained(rng, monkeypatch):
    """Aligned 6x average inside the source, with an offset window and
    nodata holes: the exact block mean (2e-6), 2-D input squeezed."""
    seen = _spy_routes(monkeypatch)
    (ts, js), (td, jd) = (_both("utm", 0.0, 0.0, 10.0, 10.0, 60, 66),
                          _both("utm", 120.0, -60.0, 60.0, 60.0, 6, 7))
    data = _img(rng, size=(66, 60), b=3)
    got, want = _resample_both(data, ts, js, td, jd, method="average",
                               nodata=NODATA, fill=np.nan)
    assert seen == ["block_average"] and got.shape == (7, 6, 3)
    _close(got, want, 2e-6, fill=np.nan)
    got2, want2 = _resample_both(data[..., 0], ts, js, td, jd,
                                 method="average", nodata=NODATA)
    assert got2.shape == (7, 6)
    _close(got2, want2, 2e-6)


@pytest.mark.parametrize("dst", [(-30.0, 30.0, 60.0, 60.0, 8, 8),
                                 (0.0, 0.0, 25.0, 25.0, 20, 22)])
def test_resample_average_separable(dst, rng, monkeypatch):
    """A same-CRS average that is not a contained integer-ratio one (an
    aligned window that leaves the source; a 2.5x ratio): the
    area-weighted separable product, TWO_PASS_ATOL."""
    seen = _spy_routes(monkeypatch)
    (ts, js), (td, jd) = (_both("utm", 0.0, 0.0, 10.0, 10.0, 60, 60),
                          _both("utm", *dst))
    data = _img(rng, size=(60, 60), b=3)
    got, want = _resample_both(data, ts, js, td, jd, method="average",
                               nodata=NODATA, fill=np.nan)
    assert seen == ["separable_resample_matmul"]
    _close(got, want, TWO_PASS_ATOL, fill=np.nan,
           mass=_resample_mass(data, js, jd, NODATA, "average"))


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("nodata", [None, NODATA])
def test_resample_same_crs_interpolation(method, nodata, rng, monkeypatch):
    """Same-CRS bilinear / cubic: two dense products in exact f32
    against the reference's ``fast=False`` einsums, TWO_PASS_ATOL."""
    seen = _spy_routes(monkeypatch)
    (ts, js), (td, jd) = (_both("utm", 0.0, 0.0, 60.0, 60.0, 24, 20),
                          _both("utm", -35.0, 25.0, 10.0, 10.0, 150, 130))
    data = _img(rng, size=(20, 24), b=3, holes=nodata is not None)
    got, want = _resample_both(data, ts, js, td, jd, method=method,
                               nodata=nodata, fill=np.nan)
    assert seen == ["separable_resample_matmul"]
    _close(got, want, TWO_PASS_ATOL, fill=np.nan,
           mass=_resample_mass(data, js, jd, nodata, method))


def test_resample_same_crs_nearest(rng, monkeypatch):
    """Same-CRS nearest: the broadcast index axes into the gather,
    bit-equal."""
    seen = _spy_routes(monkeypatch)
    (ts, js), (td, jd) = (_both("utm", 0.0, 0.0, 60.0, 60.0, 24, 20),
                          _both("utm", -35.0, 25.0, 20.0, 20.0, 80, 70))
    data = _img(rng, size=(20, 24), b=3)
    got, want = _resample_both(data, ts, js, td, jd, method="nearest",
                               nodata=NODATA)
    assert seen == ["warp_nearest"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["bilinear", "cubic", "average",
                                    "nearest"])
def test_resample_cross_crs_gather(method, rng, monkeypatch):
    """Cross-CRS below 256 x 256 destination pixels: the gather kernels
    (``average`` runs as bilinear), GATHER_ATOL; nearest bit-equal."""
    seen = _spy_routes(monkeypatch)
    tgeo, jgeo, tdst, jdst = _geo_to_utm()
    data = _img(rng, size=(90, 90), b=4)
    got, want = _resample_both(data, tgeo, jgeo, tdst, jdst, method=method,
                               nodata=NODATA)
    assert seen == ["warp_nearest" if method == "nearest"
                    else "warp_interpolate"]
    assert (got != NODATA).mean() > 0.5
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        m = "bilinear" if method == "average" else method
        _close(got, want, GATHER_ATOL,
               mass=_resample_mass(data, jgeo, jdst, NODATA, m))


@pytest.mark.parametrize("nodata", [None, NODATA])
def test_resample_cross_crs_two_pass(nodata, rng, monkeypatch):
    """Cross-CRS with ``kernel="two_pass"``, with and without a nodata
    value: ``warp_two_pass`` against the reference's, TWO_PASS_ATOL;
    ``kernel="gather"`` keeps the gather kernel on the same pair."""
    seen = _spy_routes(monkeypatch)
    tgeo, jgeo, tdst, jdst = _geo_to_utm()
    data = _img(rng, size=(90, 90), b=4, holes=nodata is not None)
    got, want = _resample_both(data, tgeo, jgeo, tdst, jdst, method="cubic",
                               nodata=nodata, kernel="two_pass")
    assert seen == ["warp_two_pass"]
    _close(got, want, TWO_PASS_ATOL,
           mass=_resample_mass(data, jgeo, jdst, nodata, "cubic"))
    twarp.resample_to_grid(data, tgeo, tdst, method="cubic", nodata=nodata,
                           kernel="gather", device="cpu")
    assert seen[-1] == "warp_interpolate"


def test_resample_auto_routes_big_monotone_to_two_pass(rng, monkeypatch):
    """``kernel="auto"``: a cross-CRS destination of 256 x 256 pixels
    goes to the two-pass warp, one of 255 x 256 to the gather kernel
    (the reference's ``big`` rule), and the two agree to 2e-3 away from
    the source's edge (the reference's bound for its two kernels)."""
    seen = _spy_routes(monkeypatch)
    tgeo, _, _, _ = _geo_to_utm(n_src=300)
    gx, gy = tgeo.xy_of(150.0, 150.0)
    ux, uy = CRS.utm(33, True).from_geographic(gx, gy)
    data = np.random.default_rng(1).random((300, 300, 1)).astype(np.float32)
    outs = []
    for h in (256, 255):
        dst = Grid(CRS.utm(33, True), float(ux) - 7000.0, float(uy) + 7000.0,
                   55.0, 55.0, 256, h)
        outs.append(twarp.resample_to_grid(data, tgeo, dst, method="cubic",
                                           device="cpu"))
    assert seen == ["warp_two_pass", "warp_interpolate"]
    a, b = outs[0][:255], outs[1]
    ok = (a != NODATA) & (b != NODATA)
    assert ok.mean() > 0.9
    assert np.abs(a[ok] - b[ok]).max() < 2e-3


def test_resample_band_chunk(rng):
    """``band_chunk`` on the gather route: the same result as one
    block, and the reference's."""
    tgeo, jgeo, tdst, jdst = _geo_to_utm()
    data = _img(rng, size=(90, 90), b=7)
    got, want = _resample_both(data, tgeo, jgeo, tdst, jdst,
                               method="bilinear", nodata=NODATA,
                               band_chunk=3)
    whole = twarp.resample_to_grid(data, tgeo, tdst, method="bilinear",
                                   nodata=NODATA, device="cpu")
    np.testing.assert_array_equal(got, whole)
    _close(got, want, GATHER_ATOL,
           mass=_resample_mass(data, jgeo, jdst, NODATA, "bilinear"))


@pytest.mark.parametrize("nodata", [None, NODATA])
def test_reproject_stack_to_grid(nodata, rng):
    """The (C, H, W) wrapper: NaN fill without a nodata value, the
    nodata value with one."""
    (ts, js), (td, jd) = (_both("utm", 0.0, 0.0, 60.0, 60.0, 20, 20),
                          _both("utm", -50.0, 50.0, 10.0, 10.0, 130, 130))
    stack = np.moveaxis(_img(rng, size=(20, 20), b=3,
                             holes=nodata is not None), -1, 0)
    want = jwarp.reproject_stack_to_grid(stack, js, jd, nodata=nodata)
    got = twarp.reproject_stack_to_grid(stack, ts, td, nodata=nodata,
                                        device="cpu")
    assert got.shape == (3, 130, 130)
    mass = (None if nodata is None else np.moveaxis(_resample_mass(
        np.moveaxis(stack, 0, -1), js, jd, nodata, "bilinear"), -1, 0))
    _close(got, want, TWO_PASS_ATOL, fill=np.nan if nodata is None
           else nodata, mass=mass)

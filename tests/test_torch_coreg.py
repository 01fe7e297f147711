"""The port's coregistration (``hyperres_torch.kernels.phasecorr``,
``hyperres_torch.coreg``) against the JAX reference on the CPU. Inputs
are made with NumPy / SciPy from a seed and given to both packages; the
port runs with ``device="cpu"``.

Tolerances:

- ``phase_correlate_batch``: (dy, dx) within 1e-4 px and the
  reliability within 1e-3 of JAX's, on textures with 1e-3 of noise; on
  an uncorrelated pair the correlation surface is all noise, its peak
  and std carry the FFT's rounding ~1e3-fold, and the reliability is
  held to 1e-2 (3e-4 of its value).
  The two packages' FFTs round differently (~1e-7 relative), and the
  whitened cross-power spectrum turns that into ~1e-5 px where every
  frequency carries signal. On a noiseless band-limited texture the
  whitening amplifies the FFT's own rounding noise beyond the texture's
  band, and the reference itself moves by ~1e-2 px when one input is
  scaled by 1 + 2^-20: there the bound is 0.05 px, and the test shows
  the reference's own spread beside it.
- ``coregister_local``: the same tie points (row, col, ``used``,
  ``reject_reason``), shifts and the affine within 1e-4 (they are means
  and least squares of the per-window shifts).
- ``ransac_affine_filter``, ``_tie_point_grid``, ``tps_*``,
  ``shift_field``: host NumPy copies on the same inputs, equal (the
  fields to 1e-4 where the tie points come from each package's own
  match).
- ``deshift``: the gather warp sums the same 16 taps in the same order
  (atol 2e-6 on values < 1); beside holes the result is a quotient by the
  valid weight mass m, and the bound is atol / m for m >= 0.05, as
  ``tests/test_torch_resample.py`` states.
- ``coregister_s2_to_emit``: the same final dict (band, match bands),
  ``mean_shift_px`` within 1e-3 px, the written u16 stack within one
  code."""

import sys
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres.core.config import CoregConfig as JCoregConfig  # noqa: E402
from hyperres.coreg import granule as jgranule  # noqa: E402
from hyperres.coreg import local as jlocal  # noqa: E402
from hyperres.kernels import phasecorr as jpc  # noqa: E402
from hyperres.kernels import warp as jwarp  # noqa: E402
from hyperres.ortho import orthorectify_granule as j_ortho  # noqa: E402
from hyperres.testing.scenes import make_scene  # noqa: E402
from hyperres_torch.core.config import CoregConfig  # noqa: E402
from hyperres_torch.coreg import granule as tgranule  # noqa: E402
from hyperres_torch.coreg import local as tlocal  # noqa: E402
from hyperres_torch.io.tiff import TiffReader, write_geotiff  # noqa: E402
from hyperres_torch.kernels import phasecorr as tpc  # noqa: E402

SHIFT_TOL = 1e-4
REL_TOL = 1e-3
UNCORRELATED_REL_TOL = 1e-2
NOISELESS_TOL = 0.05
GATHER_ATOL = 2e-6


def smooth_image(rng, h, w, scale=4):
    """Band-limited random texture: a coarse normal field, cubic-spline
    zoomed by ``scale``."""
    f = rng.normal(size=(h // scale + 2, w // scale + 2))
    return ndimage.zoom(f, (h / f.shape[0], w / f.shape[1]),
                        order=3)[:h, :w].astype(np.float32)


def shift_image(img, dy, dx):
    """tgt(r, c) = img(r - dy, c - dx), cubic spline, reflected edges."""
    return ndimage.shift(img, (dy, dx), order=3,
                         mode="reflect").astype(np.float32)


def noisy(rng, img, sigma=1e-3):
    return img + (sigma * rng.standard_normal(img.shape)).astype(np.float32)


def both_pc(ref, tgt, lowpass_frac=1.0):
    want = [np.asarray(v) for v in jpc.phase_correlate_batch(
        jnp.asarray(ref), jnp.asarray(tgt), lowpass_frac=lowpass_frac)]
    got = [v.numpy() for v in tpc.phase_correlate_batch(
        ref, tgt, lowpass_frac=lowpass_frac, device="cpu")]
    return got, want


def assert_pc_close(got, want):
    """Shifts within SHIFT_TOL (so the same integer peak on every
    window), reliability within REL_TOL; on an uncorrelated window
    (reliability < 50) within UNCORRELATED_REL_TOL."""
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=SHIFT_TOL)
    tol = np.where(want[2] < 50.0, UNCORRELATED_REL_TOL, REL_TOL)
    assert (np.abs(got[2] - want[2]) <= tol).all(), (got[2], want[2])


# ---------------------------------------------------------------------------
# phase correlation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dy,dx", [(3.0, -5.0), (0.0, 0.0), (-7.25, 2.5)])
def test_phase_correlation_matches_jax(rng, dy, dx):
    """The three shifts of tests/test_coreg.py:29 on a 256 px noisy
    texture: within SHIFT_TOL / REL_TOL of JAX, and the shift recovered
    to 0.25 px as the reference's test asks."""
    img = smooth_image(rng, 256, 256)
    ref = noisy(rng, img)[None]
    tgt = noisy(rng, shift_image(img, dy, dx))[None]
    got, want = both_pc(ref, tgt)
    assert_pc_close(got, want)
    assert abs(got[0][0] - dy) < 0.25 and abs(got[1][0] - dx) < 0.25
    assert got[2][0] > 50.0
    assert tpc.estimate_shift(ref[0], tgt[0], device="cpu") == pytest.approx(
        (float(got[0][0]), float(got[1][0]), float(got[2][0])))


def test_phase_correlation_batch_and_lowpass_match_jax(rng):
    """A batch of six 128 px windows (shifts up to 8 px, one pair
    uncorrelated) at ``lowpass_frac`` 1 and 1/6 (the EMIT-on-S2 case,
    and 1/12 on an odd-sized window): within SHIFT_TOL / REL_TOL."""
    shifts = [(2.0, 3.0), (-4.0, 1.0), (8.0, -6.0), (0.5, -2.25),
              (0.0, 0.0), (-7.25, 2.5)]
    imgs = [smooth_image(rng, 128, 128) for _ in shifts]
    ref = np.stack([noisy(rng, im) for im in imgs])
    tgt = np.stack([noisy(rng, shift_image(im, dy, dx))
                    for im, (dy, dx) in zip(imgs, shifts)])
    tgt[-1] = noisy(rng, smooth_image(rng, 128, 128))
    for frac in (1.0, 1.0 / 6.0):
        assert_pc_close(*both_pc(ref, tgt, frac))
    assert_pc_close(*both_pc(ref[:, :, :-1], tgt[:, :, :-1], 1.0 / 12.0))


def test_phase_correlation_uncorrelated_low_reliability(rng):
    """Uncorrelated windows: the same low reliability as JAX's (REL_TOL),
    well under a correlated pair's."""
    a = noisy(rng, smooth_image(rng, 128, 128))
    b = noisy(rng, smooth_image(np.random.default_rng(99), 128, 128))
    got, want = both_pc(np.stack([a, a]),
                        np.stack([b, shift_image(a, 2.0, 2.0)]))
    assert_pc_close(got, want)
    assert got[2][1] > got[2][0] + 10.0


def test_phase_correlation_noiseless_texture_conditioning(rng):
    """On a noiseless band-limited texture (tests/test_coreg.py's inputs)
    the port lies within NOISELESS_TOL of JAX, and JAX moves by a like
    amount under a 2^-20 relative change of one input: the spread is the
    problem's, not the port's (module docstring)."""
    imgs = [smooth_image(rng, 256, 256, scale=12) for _ in range(3)]
    ref = np.stack(imgs)
    tgt = np.stack([shift_image(im, 3.0, -5.0) for im in imgs])
    got, want = both_pc(ref, tgt)
    pert = [np.asarray(v) for v in jpc.phase_correlate_batch(
        jnp.asarray(ref * np.float32(1 + 2 ** -20)), jnp.asarray(tgt))]
    for g, w, p in zip(got[:2], want[:2], pert[:2]):
        assert np.abs(g - w).max() < NOISELESS_TOL
        assert np.abs(p - w).max() > SHIFT_TOL
    np.testing.assert_allclose(got[0], 3.0, atol=0.25)
    np.testing.assert_allclose(got[1], -5.0, atol=0.25)


def test_reliability_tau_is_the_reference_s():
    assert tpc.RELIABILITY_TAU == jpc.RELIABILITY_TAU
    np.testing.assert_array_equal(tpc._hann2d(7, 10), jpc._hann2d(7, 10))


# ---------------------------------------------------------------------------
# local coregistration
# ---------------------------------------------------------------------------

def _configs(**kw):
    return CoregConfig(**kw), JCoregConfig(**kw)


def _tie_points(res):
    return [(t.row, t.col, t.used, t.reject_reason) for t in res.tie_points]


def _assert_same_result(got, want):
    assert got.success == want.success
    assert _tie_points(got) == _tie_points(want)
    for g, w in zip(got.tie_points, want.tie_points):
        assert abs(g.dy - w.dy) <= SHIFT_TOL and abs(g.dx - w.dx) <= SHIFT_TOL
        assert abs(g.reliability - w.reliability) <= REL_TOL
    np.testing.assert_allclose(got.mean_shift_px, want.mean_shift_px,
                               atol=SHIFT_TOL)
    if want.affine is not None:
        np.testing.assert_allclose(got.affine, want.affine, atol=SHIFT_TOL)
    assert got.info == want.info


def test_coregister_local_matches_jax(rng):
    """A 600 x 640 noisy texture shifted by (4.5, -3.25) with a hole of
    nodata: the same tie points and filters, shifts and affine within
    SHIFT_TOL; the shift recovered to 0.3 px."""
    img = smooth_image(rng, 600, 640, scale=6)
    ref = noisy(rng, img)
    tgt = noisy(rng, shift_image(img, 4.5, -3.25))
    tgt[:200, :200] = -9999.0
    tcfg, jcfg = _configs(window_size=(256, 256), grid_res=150,
                          max_points=20, min_reliability=40)
    got = tlocal.coregister_local(ref, tgt, config=tcfg, tgt_nodata=-9999.0,
                                  device="cpu")
    want = jlocal.coregister_local(ref, tgt, config=jcfg,
                                   tgt_nodata=-9999.0)
    _assert_same_result(got, want)
    assert got.success and abs(got.mean_shift_px[0] - 4.5) < 0.3
    assert abs(got.mean_shift_px[1] + 3.25) < 0.3


def test_coregister_local_filters_match_jax(rng):
    """Filter level 3 with a corrupted corner (MAD / RANSAC rejections),
    and the failures: too small an image, every window masked."""
    img = smooth_image(rng, 500, 500, scale=6)
    tgt = noisy(rng, shift_image(img, 2.0, 2.0))
    tgt[:160, :160] = rng.normal(size=(160, 160))
    ref = noisy(rng, img)
    tcfg, jcfg = _configs(window_size=(128, 128), grid_res=120,
                          max_points=30, min_reliability=45,
                          tie_point_filter_level=3)
    got = tlocal.coregister_local(ref, tgt, config=tcfg, device="cpu")
    want = jlocal.coregister_local(ref, tgt, config=jcfg)
    _assert_same_result(got, want)
    assert any(not t.used for t in got.tie_points)
    for r, t in ((ref[:10, :10], tgt[:10, :10]),
                 (ref, np.full_like(tgt, np.nan))):
        g = tlocal.coregister_local(r, t, config=tcfg, device="cpu")
        w = jlocal.coregister_local(r, t, config=jcfg)
        assert (g.success, g.info) == (w.success, w.info)
        assert g.success is False


def _points(rng, n=24, outliers=4):
    pts = []
    for i in range(n):
        r, c = float(rng.integers(0, 900)), float(rng.integers(0, 900))
        dy = 1.5 + 1e-3 * r - 5e-4 * c + 0.05 * rng.standard_normal()
        dx = -2.0 + 2e-4 * r + 1e-3 * c + 0.05 * rng.standard_normal()
        if i < outliers:
            dy += 8.0 + 4.0 * abs(rng.standard_normal())
        pts.append((int(c), int(r), dy, dx, 80.0))
    return pts


def test_ransac_affine_filter_bit_equal(rng):
    """The seeded RANSAC on the same points: the same points marked,
    with the same reasons (host NumPy, bit-equal)."""
    pts = _points(rng)
    tps = [tlocal.TiePoint(*p) for p in pts]
    jps = [jlocal.TiePoint(*p) for p in pts]
    tlocal.ransac_affine_filter(tps, thresh_px=1.0, seed=3)
    jlocal.ransac_affine_filter(jps, thresh_px=1.0, seed=3)
    assert [astuple(t) for t in tps] == [astuple(t) for t in jps]
    assert sum(not t.used for t in tps) >= 4


@pytest.mark.parametrize("shift", [(4.5, -6.0), (0.4, -0.3)])
def test_ransac_affine_filter_on_a_grid_equal(rng, shift):
    """The tie-point grid the match gives (13 x 13 points at 600 px,
    thresh 3 px): many triples are collinear, so the stacked solve takes
    rank-deficient systems, and with a sub-threshold shift every model
    ties. The same points marked as the reference's loop marks them."""
    pts = []
    for i, (r, c) in enumerate(tlocal._tie_point_grid(
            7800, 7800, 600.0, (512, 512), 500)):
        dy = shift[0] + 2e-4 * r - 1e-4 * c + 0.05 * rng.standard_normal()
        dx = shift[1] + 1e-4 * c + 0.05 * rng.standard_normal()
        if i % 17 == 0:
            dx += 6.0 + 4.0 * abs(rng.standard_normal())
        pts.append((c, r, dy, dx, 80.0))
    tps = [tlocal.TiePoint(*p) for p in pts]
    jps = [jlocal.TiePoint(*p) for p in pts]
    tlocal.ransac_affine_filter(tps, thresh_px=3.0)
    jlocal.ransac_affine_filter(jps, thresh_px=3.0)
    assert [astuple(t) for t in tps] == [astuple(t) for t in jps]
    assert sum(not t.used for t in tps) >= len(pts) // 17


def test_lstsq_stack_matches_lstsq(rng):
    """``_lstsq_stack`` against ``np.linalg.lstsq`` system by system:
    full-rank, collinear (rank 2) and repeated (rank 1) triples, and
    ``_ransac_picks`` the generator's successive draws."""
    g = np.stack([rng.integers(0, 9000, (60, 3)),
                  rng.integers(0, 9000, (60, 3)),
                  np.ones((60, 3))], axis=2).astype(np.float64)
    g[20:40, :, 0] = 300.0
    g[40:, :, :2] = g[40:, :1, :2]
    d = rng.standard_normal((60, 3, 2))
    want = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                     for a, b in zip(g, d)])
    np.testing.assert_allclose(tlocal._lstsq_stack(g, d), want,
                               rtol=1e-9, atol=1e-12)
    gen = np.random.default_rng(5)
    draws = [gen.choice(40, size=3, replace=False) for _ in range(30)]
    np.testing.assert_array_equal(tlocal._ransac_picks(40, 30, 5), draws)


def test_tie_point_grid_equal():
    for args in ((600, 640, 150.0, (256, 256), 20),
                 (9600, 9600, 600.0, (512, 512), 500),
                 (100, 90, 7.5, (16, 18), None)):
        assert tlocal._tie_point_grid(*args) == jlocal._tie_point_grid(*args)
    with pytest.raises(ValueError):
        tlocal._tie_point_grid(10, 10, 0.0, (4, 4), None)


def _results(rng):
    """One CoregResult per package from the same tie points and affine."""
    pts = _points(rng, outliers=0)
    G = np.array([[p[1], p[0], 1.0] for p in pts])
    D = np.array([[p[2], p[3]] for p in pts])
    A = np.linalg.lstsq(G, D, rcond=None)[0].T
    mean = (float(D[:, 0].mean()), float(D[:, 1].mean()))
    return (tlocal.CoregResult(True, None, [tlocal.TiePoint(*p) for p in pts],
                               mean, A),
            jlocal.CoregResult(True, None, [jlocal.TiePoint(*p) for p in pts],
                               mean, A))


@pytest.mark.parametrize("mode", ["affine", "idw", "tps"])
def test_shift_field_equal(rng, mode):
    """``shift_field`` (affine only, plus IDW or TPS residuals) on the
    same result: equal (NumPy copies on the same inputs)."""
    tres, jres = _results(rng)
    kw = ({} if mode == "affine"
          else {"local_residuals": True, "mode": mode})
    got = tlocal.shift_field(tres, (50, 60), **kw)
    want = jlocal.shift_field(jres, (50, 60), **kw)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def _mass(img_bhw, result, nodata):
    """The valid weight mass of each deshifted element (the validity image
    warped without a nodata value; 1 away from holes)."""
    b, h, w = img_bhw.shape
    dy, dx = jlocal.shift_field(result, (h, w))
    rows = dy + np.arange(h, dtype=np.float32)[:, None]
    cols = dx + np.arange(w, dtype=np.float32)[None, :]
    ok = (np.isfinite(img_bhw) & (img_bhw != nodata)).astype(np.float32)
    m = jwarp.warp_interpolate(jnp.asarray(np.moveaxis(ok, 0, -1)),
                               jnp.asarray(rows), jnp.asarray(cols),
                               nodata=None, method="cubic", fill=0.0)
    return np.moveaxis(np.asarray(m), -1, 0)


def test_deshift_matches_jax(rng):
    """``deshift`` of a 3-band stack with nodata holes by an affine
    field, cubic: the same fill pixels where the mass is sure, values
    within GATHER_ATOL / mass; and without a nodata value, within
    GATHER_ATOL everywhere."""
    tres, jres = _results(rng)
    stack = rng.random((3, 70, 80)).astype(np.float32)
    holes = stack.copy()
    holes[:, 20:30, 30:45] = 0.0
    holes[1, 50:55, :] = np.nan
    got = tlocal.deshift(holes, tres, nodata=0.0, device="cpu")
    want = jlocal.deshift(holes, jres, nodata=0.0)
    assert got.shape == want.shape and got.dtype == np.float32
    mass = np.abs(np.nan_to_num(_mass(holes, jres, 0.0)))
    sure = mass >= 1e-4
    np.testing.assert_array_equal((got == 0.0)[sure], (want == 0.0)[sure])
    ok = (mass >= 0.05) & (want != 0.0) & (got != 0.0)
    assert np.nanmax(np.abs(got[ok] - want[ok]) * mass[ok]) <= GATHER_ATOL
    got = tlocal.deshift(stack, tres, device="cpu")
    want = jlocal.deshift(stack, jres)
    np.testing.assert_allclose(got, want, rtol=0, atol=GATHER_ATOL,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# the granule level
# ---------------------------------------------------------------------------

#: tests/test_pipeline_e2e.py:99's shift and matching settings: rows,
#: columns of 10 m px; its max_shift (8 px) rejects the spurious matches
#: of this small scene's few windows
S2_SHIFT = (2, -3)
COREG_KW = dict(window_size=(256, 256), grid_res=120, max_points=9,
                min_reliability=20, max_shift=8.0)


def shifted_stack(src, dst, shift=S2_SHIFT):
    """The S2 stack of ``src`` rolled by ``shift`` (tgt(r, c) =
    src(r - dy, c - dx)), nodata (0) on the rolled-in edges, written
    uncompressed to ``dst``."""
    with TiffReader(src) as r:
        stack = r.read()
        grid, nodata, descs = r.grid, r.nodata, r.descriptions
    dy, dx = shift
    out = np.roll(stack, (dy, dx), axis=(1, 2))
    fill = 0 if nodata is None else nodata
    if dy > 0:
        out[:, :dy] = fill
    elif dy < 0:
        out[:, dy:] = fill
    if dx > 0:
        out[:, :, :dx] = fill
    elif dx < 0:
        out[:, :, dx:] = fill
    write_geotiff(dst, out, grid, nodata=nodata, descriptions=descs,
                  compress=None)
    return dst


@pytest.fixture(scope="module")
def coreg_scene(tmp_path_factory):
    """A small scene, its ortho u16 product (by the reference, the one
    EMIT reference both packages read) and its S2 stack shifted by
    S2_SHIFT."""
    from hyperres.core.config import OrthoConfig
    d = tmp_path_factory.mktemp("torch_coreg")
    sc = make_scene(d / "scene", raw_shape=(90, 100), n_bands=24,
                    s2_size=480, noise=0.001)
    res = j_ortho(sc.emit_nc_path, d / "ortho", sc.s2_tif_path,
                  config=OrthoConfig(write_xml=False))
    return (sc, res.info["outputs"]["data_utm_tif"],
            shifted_stack(sc.s2_tif_path, d / "s2_shifted.tif"), d)


def test_coregister_s2_to_emit_matches_jax(coreg_scene):
    """Both packages' ``coregister_s2_to_emit`` on the same files: the same final dict (band, match
    bands, wavelength, tie points used), ``mean_shift_px`` within 1e-3
    px of JAX's and within 1.5 px of the injected shift, the written u16
    stack within one code, the same attempts ledger."""
    sc, emit_tif, s2_tif, d = coreg_scene
    tcfg, jcfg = _configs(**COREG_KW)
    kw = dict(emit_ref_tif=emit_tif, s2_tgt_tif=s2_tif,
              emit_nc_path=sc.emit_nc_path)
    got = tgranule.coregister_s2_to_emit(
        **kw, out_s2_tif=d / "port.tif", config=tcfg, device="cpu")
    want = jgranule.coregister_s2_to_emit(
        **kw, out_s2_tif=d / "jax.tif", config=jcfg)
    gf, wf = got["final"], want["final"]
    assert gf["success"] and wf["success"]
    shift_g, shift_w = gf.pop("mean_shift_px"), wf.pop("mean_shift_px")
    assert gf == wf
    np.testing.assert_allclose(shift_g, shift_w, rtol=0, atol=1e-3)
    assert abs(shift_g[0] - S2_SHIFT[0]) < 1.5
    assert abs(shift_g[1] - S2_SHIFT[1]) < 1.5
    assert len(got["attempts"]) == len(want["attempts"])
    with TiffReader(d / "port.tif") as a, TiffReader(d / "jax.tif") as b:
        qa, qb = a.read(), b.read()
        assert (a.grid, a.nodata, a.descriptions) == (
            b.grid, b.nodata, b.descriptions)
    assert qa.dtype == qb.dtype == np.uint16
    assert np.abs(qa.astype(np.int32) - qb.astype(np.int32)).max() <= 1


def test_coregister_s2_to_emit_records_data_errors(coreg_scene,
                                                   monkeypatch):
    """A data error of an attempt (here a ValueError) is recorded in the
    ledger and the next band is tried, as in the reference."""
    sc, emit_tif, s2_tif, d = coreg_scene

    def bad_match(*a, **k):
        raise ValueError("no texture")

    monkeypatch.setattr(tgranule, "coregister_local", bad_match)
    out = tgranule.coregister_s2_to_emit(
        emit_ref_tif=emit_tif, s2_tgt_tif=s2_tif,
        emit_nc_path=sc.emit_nc_path, out_s2_tif=d / "x.tif",
        config=CoregConfig(**COREG_KW), device="cpu")
    assert out["final"] == {"success": False, "error": "no texture"}
    assert [a["s2_code"] for a in out["attempts"]] == ["B08", "B04"]


def test_coregister_s2_to_emit_propagates_device_errors(coreg_scene,
                                                        monkeypatch):
    """The port's one departure: an attempt that raises anything but a
    data error (a RuntimeError, as a failed kernel launch or a CUDA
    error raises) propagates instead of being recorded."""
    sc, emit_tif, s2_tif, d = coreg_scene

    def launch_fails(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tgranule, "resample_to_grid", launch_fails)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tgranule.coregister_s2_to_emit(
            emit_ref_tif=emit_tif, s2_tgt_tif=s2_tif,
            emit_nc_path=sc.emit_nc_path, out_s2_tif=d / "y.tif",
            config=CoregConfig(**COREG_KW), device="cpu")
    assert tgranule.ATTEMPT_ERRORS == (ValueError, KeyError, OSError,
                                       np.linalg.LinAlgError)


def test_band_helpers_equal():
    descs = ["B02_blue", None, "b08_nir", "B8A_nir08", ""]
    assert (tgranule.s2_bandmap_from_descriptions(descs)
            == jgranule.s2_bandmap_from_descriptions(descs))
    wl = np.linspace(380.0, 2500.0, 285)
    for nm in (665.0, 842.0, 100.0, 3000.0):
        assert (tgranule.closest_band_1based(wl, nm)
                == jgranule.closest_band_1based(wl, nm))
    with pytest.raises(ValueError):
        tgranule.s2_bandmap_from_descriptions([None, None])

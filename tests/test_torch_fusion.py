"""The PyTorch port's fusion phases against the JAX reference on the
CPU — SRF synthesis, the shared percentile stretch, the sampler, the
Sinkhorn barycentric targets, the polynomial fit — and the slice as a
whole: the port's FusedOrthoFusionPlan against the reference's on the
bench scene at scale 0.05. Inputs are made with NumPy from a seed and
given to both packages."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import chip_smoke  # noqa: E402
from hyperres.core import config as jconfig  # noqa: E402
from hyperres.fusion.fused import FusedFusionPlan as JaxFusionPlan  # noqa: E402
from hyperres.fusion.fused import FusedOrthoFusionPlan as JaxPlan  # noqa: E402
from hyperres.kernels import lstsq as jlstsq  # noqa: E402
from hyperres.kernels import sinkhorn as jsink  # noqa: E402
from hyperres.kernels import srf as jsrf  # noqa: E402
from hyperres.kernels import stats as jstats  # noqa: E402
from hyperres_torch.core.config import OTConfig, PolyFusionConfig  # noqa: E402
from hyperres_torch.fusion import fused as tfused  # noqa: E402
from hyperres_torch.fusion.sampling import sample_valid_pixels_device  # noqa: E402
from hyperres_torch.kernels import lstsq as tlstsq  # noqa: E402
from hyperres_torch.kernels import sinkhorn as tsink  # noqa: E402
from hyperres_torch.kernels import srf as tsrf  # noqa: E402
from hyperres_torch.kernels import stats as tstats  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402
from hyperres_torch.testing.bench_scene import generate_scene  # noqa: E402

T = torch.from_numpy
CFG = PolyFusionConfig(ot=OTConfig(n_samples=1500, num_itermax=120))
#: the same configuration in the reference's classes, for its plans
JCFG = jconfig.PolyFusionConfig(ot=jconfig.OTConfig(n_samples=1500,
                                                    num_itermax=120))


def test_srf_synthesize_matches_jax(rng):
    """f32 matmul against XLA's f32 dot: 2e-6 (285-term sums of values
    < 1 in another order)."""
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.testing.bench_scene import emit_wavelength_grid

    wl, good = emit_wavelength_grid(285)
    W, _, _ = build_srf_weight_matrix(wl, builtin_srf("S2A"), good)
    cube = rng.random((17, 23, 285)).astype(np.float32)
    valid = rng.random((17, 23)) > 0.3
    want = np.asarray(jsrf.srf_synthesize(jnp.asarray(cube), jnp.asarray(W),
                                          jnp.asarray(valid), fast=True))
    got = tsrf.srf_synthesize(T(cube), T(W), T(valid)).numpy()
    np.testing.assert_array_equal(got == -9999.0, want == -9999.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _stretch_case(rng):
    img = rng.random((41, 53, 3)).astype(np.float32)
    img[..., 1] = np.round(img[..., 1] * 50) / 50       # ties
    img[rng.random(img.shape) < 0.05] = np.nan
    mask = rng.random((41, 53)) > 0.2
    return img, mask


def _jax_order_stats(img, mask, qs):
    """The reference's ranks and bit-searched order statistics
    (stats.py:98-112), without the final combine."""
    c = img.shape[-1]
    flat = jnp.asarray(img).reshape(-1, c)
    valid = (jnp.broadcast_to(jnp.asarray(mask).reshape(-1, 1), flat.shape)
             & ~jnp.isnan(flat))
    nn = jnp.sum(valid, axis=0, dtype=jnp.int32)
    pos = (jnp.asarray(qs, jnp.float32) / 100.0)[None, :] * (
        jnp.maximum(nn - 1, 0).astype(jnp.float32)[:, None])
    nm1 = jnp.maximum(nn - 1, 0)[:, None]
    j = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, nm1)
    jp = jnp.clip(jnp.ceil(pos).astype(jnp.int32), 0, nm1)
    keys = jstats._bitsearch_kth_keys(jstats._f32_order_keys(flat), valid,
                                      jnp.stack([j, jp], axis=-1))
    vals = np.asarray(jstats._f32_from_order_keys(keys))
    return vals[..., 0], vals[..., 1]


@pytest.mark.parametrize("qs", [(2.0, 98.0), (0.0, 37.5, 100.0)])
def test_percentiles_match_bitsearch(qs, rng):
    """Order statistics bit-equal to the reference's bit search, and the
    percentiles too (the port evaluates the rank and combine as the
    reference's XLA CPU program does); np.percentile to 1e-6."""
    img, mask = _stretch_case(rng)
    lo, hi, _, n = tstats.masked_order_stats(T(img), T(mask), qs)
    jlo, jhi = _jax_order_stats(img, mask, qs)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert (n == (mask[..., None] & ~np.isnan(img)).sum((0, 1))).all()
    got = tstats.masked_percentile_channels(T(img), T(mask), qs)
    want = np.asarray(jstats.masked_percentile_channels(
        jnp.asarray(img), jnp.asarray(mask), jnp.asarray(qs)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.stack([np.percentile(img[..., c][mask & ~np.isnan(img[..., c])],
                                     qs) for c in range(3)]),
        rtol=1e-6)


def test_shared_percentile_stretch_matches_jax(rng):
    """Stretched values within 1 ulp of the stretch formula applied to
    the reference's percentiles; NaNs where the input is NaN. Against
    the reference's jitted stretch itself, 3e-8 absolute (a few ulp of
    inputs < 1): XLA fuses the percentile combine into the subtraction
    (x - lo), which rounds at the scale of x — up to ~135 ulp for
    outputs near 0."""
    img, mask = _stretch_case(rng)
    want = np.asarray(jstats.shared_percentile_stretch(
        jnp.asarray(img), jnp.asarray(mask), 2.0, 98.0))
    got = tstats.shared_percentile_stretch(T(img), T(mask), 2.0,
                                           98.0).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-8)
    lohi = np.asarray(jstats.masked_percentile_channels(
        jnp.asarray(img), jnp.asarray(mask), jnp.asarray([2.0, 98.0])))
    lo, hi = lohi[:, 0], lohi[:, 1]
    ref = np.clip((img - lo) / (hi - lo + np.float32(1e-12)), 0.0, 1.0)
    np.testing.assert_array_max_ulp(np.nan_to_num(got), np.nan_to_num(ref),
                                    maxulp=1)


def test_percentiles_empty_channel():
    img = np.ones((4, 5, 2), np.float32)
    img[..., 1] = np.nan
    out = tstats.masked_percentile_channels(T(img), T(np.ones((4, 5), bool)),
                                            [2.0, 98.0])
    np.testing.assert_array_equal(out[0], [1.0, 1.0])
    assert np.isnan(out[1]).all()


def test_erode_mask_matches_jax(rng):
    m = rng.random((37, 29)) > 0.15
    for it in (1, 2):
        np.testing.assert_array_equal(
            tstats.erode_mask(T(m), it).numpy(),
            np.asarray(jstats.erode_mask(jnp.asarray(m), it)))


@pytest.mark.parametrize("n_samples", [200, 2000])
def test_sampler_with_injected_noise(n_samples, rng):
    """Gumbel top-k with the same noise == a NumPy argsort: the valid
    pixels with the largest noise, best first; weight 1 for real slots,
    0 for padding beyond the valid count."""
    img = rng.random((30, 40, 3)).astype(np.float32)
    img[rng.random((30, 40)) < 0.1, 1] = np.nan
    mask = rng.random((30, 40)) > 0.3
    noise = rng.gumbel(size=1200).astype(np.float32)
    X, w = sample_valid_pixels_device(T(img), T(mask), n_samples,
                                      noise=T(noise))
    flat = img.reshape(-1, 3)
    valid = mask.reshape(-1) & np.isfinite(flat).all(-1)
    order = np.argsort(-np.where(valid, noise, -np.inf), kind="stable")
    k = min(n_samples, int(valid.sum()))
    assert X.shape == (min(n_samples, 1200), 3)
    np.testing.assert_array_equal(X.numpy()[:k], flat[order[:k]])
    np.testing.assert_array_equal(w.numpy()[:k], 1.0)
    np.testing.assert_array_equal(w.numpy()[k:], 0.0)


def test_sampler_generator_is_reproducible(rng):
    img = T(rng.random((20, 20, 3)).astype(np.float32))
    mask = T(rng.random((20, 20)) > 0.5)
    a = sample_valid_pixels_device(img, mask, 50,
                                   generator=torch.Generator().manual_seed(3))
    b = sample_valid_pixels_device(img, mask, 50,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        sample_valid_pixels_device(img, mask, 50)


@pytest.mark.parametrize("debias", [False, True])
def test_ot_barycentric_targets_matches_jax(debias, rng):
    """Same samples and slot weights (with NaN padding rows) into both
    packages: targets to 5e-6 — 120 Sinkhorn iterations of f32
    logsumexps summed in another order (measured ~5e-7)."""
    X = rng.random((400, 3)).astype(np.float32)
    Y = (rng.random((400, 3)) ** 1.3).astype(np.float32)
    wx = (np.arange(400) < 370).astype(np.float32)
    wy = (np.arange(400) < 390).astype(np.float32)
    X[380] = np.nan
    want = np.asarray(jsink.ot_barycentric_targets(
        jnp.asarray(X), jnp.asarray(Y), 0.05, 120, 1e-6, jnp.asarray(wx),
        jnp.asarray(wy), debias=debias))
    got = tsink.ot_barycentric_targets(T(X), T(Y), 0.05, 120, 1e-6, T(wx),
                                       T(wy), debias=debias).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_sinkhorn_stops_like_jax(rng):
    """Stopping rule: err checked every 10 iterations; a loose stop_thr
    stops both packages at the same check, with the same plan."""
    X = rng.random((60, 3)).astype(np.float32)
    Y = rng.random((50, 3)).astype(np.float32)
    a = np.full(60, 1 / 60, np.float32)
    b = np.full(50, 1 / 50, np.float32)
    M = np.asarray(jsink.sqeuclidean_cdist(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(
        tsink.sqeuclidean_cdist(T(X), T(Y)).numpy(), M, rtol=0, atol=1e-6)
    for thr in (1e-2, 1e-4):
        Pj, ej = jsink.sinkhorn_log(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(M), 0.05, 300, thr)
        Pt, et = tsink.sinkhorn_log(T(a), T(b), T(M), 0.05, 300, thr)
        assert float(et) <= thr and float(ej) <= thr
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=0,
                                   atol=1e-6)


def test_polyfit_and_polyval_match_jax(rng):
    """Weighted degree-4 QR fit: the fitted curves agree to 1e-5 over
    [0, 1] (coefficients of a Vandermonde least squares from two
    LAPACK QRs agree to ~1e-5); Horner evaluation of the same
    coefficients to 1 ulp-level (1e-6)."""
    x = rng.random(1500).astype(np.float32)
    y = (0.2 + 0.5 * x + 0.3 * x ** 3
         + 0.01 * rng.standard_normal(1500)).astype(np.float32)
    w = (rng.random(1500) > 0.1).astype(np.float32)
    want = np.asarray(jlstsq.polyfit(jnp.asarray(x), jnp.asarray(y), 4,
                                     w=jnp.asarray(w)))
    got = tlstsq.polyfit(T(x), T(y), 4, w=T(w)).numpy()
    xx = np.linspace(0.0, 1.0, 101)
    assert np.abs(np.polyval(got, xx) - np.polyval(want, xx)).max() < 1e-5
    coeffs = rng.standard_normal((3, 5)).astype(np.float32)
    img = rng.random((11, 13, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlstsq.polyval_channels(T(coeffs), T(img)).numpy(),
        np.asarray(jlstsq.polyval_channels(jnp.asarray(coeffs),
                                           jnp.asarray(img))),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_run():
    sc = generate_scene(0.05, 0)
    srf = builtin_srf("S2A", bands=["B2", "B3", "B4"])
    args = (sc["ortho_grid"], sc["utm60"], sc["s2_grid"],
            sc["raw"].shape[:2], sc["glt"], sc["wavelengths"],
            sc["good_mask"])
    kw = dict(s2_nodata=65535.0, s2_scale=1e-4, config=CFG, srf=srf)
    jplan = JaxPlan(*args, warp_kernel="two_pass", **dict(kw, config=JCFG))
    js2 = jplan.prepare_s2(sc["s2_dn"])
    jout = {k: np.asarray(v) for k, v in jplan(sc["raw"], js2).items()}
    jref = np.asarray(jplan.s2_reference_10m(jout["utm_cube"], js2))
    tplan = tfused.FusedOrthoFusionPlan(*args, device="cpu", **kw)
    ts2 = tplan.prepare_s2(sc["s2_dn"])
    tout = tplan(sc["raw"], ts2)
    tref = tplan.s2_reference_10m(tout["utm_cube"], ts2)
    return dict(scene=sc, jplan=jplan, jout=jout, jref=jref, tplan=tplan,
                ts2=ts2, tout=tout, tref=tref, js2=np.asarray(js2))


def test_slice_utm_cube_and_masks(slice_run):
    """utm_cube to atol 1e-5 (f32 rounding of the two passes' sums and
    the validity division; measured ~5e-7), the same fill pixels, the
    same 60 m valid count and the same 10 m finite mask; the prepared
    S2 input is bit-identical."""
    j, t = slice_run["jout"], slice_run["tout"]
    np.testing.assert_array_equal(slice_run["ts2"].numpy(),
                                  slice_run["js2"])
    u = t["utm_cube"].numpy()
    assert u.shape == j["utm_cube"].shape
    np.testing.assert_array_equal(u == -9999.0, j["utm_cube"] == -9999.0)
    np.testing.assert_allclose(u, j["utm_cube"], rtol=0, atol=1e-5)
    assert int(t["n_valid_60m"]) == int(j["n_valid_60m"])
    np.testing.assert_array_equal(
        np.isfinite(t["fused_10m"].numpy()).all(-1),
        np.isfinite(j["fused_10m"]).all(-1))


def test_slice_fused_product_statistically_equal(slice_run):
    """The two packages draw their 1500-pixel OT samples from different
    random streams, so the fused products agree statistically (as
    test_bench_workload.py:54-68): PSNR > 35 dB and fitted curves within
    0.05 over the stretched domain."""
    from hyperres.pipeline import psnr

    j, t = slice_run["jout"], slice_run["tout"]
    fa, fb = t["fused_10m"].numpy(), j["fused_10m"]
    va, vb = np.isfinite(fa).all(-1), np.isfinite(fb).all(-1)
    assert psnr(fa[va], fb[vb]) > 35.0
    assert t["coeffs"].shape == j["coeffs"].shape
    x = np.linspace(0.05, 0.95, 64)
    for c in range(3):
        ya = np.polyval(t["coeffs"][c].numpy(), x)
        yb = np.polyval(j["coeffs"][c], x)
        assert np.max(np.abs(ya - yb)) < 0.05


def test_slice_audit_target(slice_run):
    """s2_reference_10m to atol 2e-6 (1-ulp stretch differences through
    the bilinear upsample), identical NaN masks."""
    a, b = slice_run["tref"].numpy(), slice_run["jref"]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


def _jax_state(jplan):
    f = jplan._fusion
    return {"flat_idx": np.asarray(jplan._flat),
            "valid": np.asarray(jplan._valid),
            "wr": np.asarray(jplan._wr), "wc": np.asarray(jplan._wc),
            "cstar": np.asarray(jplan._cstar),
            "Wsrf": np.asarray(f._Wsrf),
            "down_fast": jplan.statics.down_fast,
            "up_fast": jplan.statics.up_fast}


def _plan_args(sc):
    return (sc["ortho_grid"], sc["utm60"], sc["s2_grid"],
            sc["raw"].shape[:2], sc["glt"], sc["wavelengths"],
            sc["good_mask"])


def test_plan_from_jax_state(slice_run):
    """A port plan built from the reference plan's arrays computes
    exactly what the natively built port plan computes; so does one
    from a reference plan built with ``warp_kernel="pallas"``, whose
    ``WarpStatics.backend`` carries across and selects the dense
    route."""
    jplan, tplan = slice_run["jplan"], slice_run["tplan"]
    state = _jax_state(jplan)
    native = tplan.state_dict_numpy()
    assert set(native) == set(state)
    for k, v in state.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(native[k], v)
        else:
            assert native[k] == v
    plan = tfused.FusedOrthoFusionPlan.from_state(state, tplan.statics,
                                                  device="cpu")
    out = plan(slice_run["scene"]["raw"], slice_run["ts2"])
    for k, v in slice_run["tout"].items():
        torch.testing.assert_close(out[k], v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)

    sc = slice_run["scene"]
    kw = dict(s2_nodata=65535.0, s2_scale=1e-4, config=CFG,
              srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]))
    jdense = JaxPlan(*_plan_args(sc), warp_kernel="pallas",
                     **dict(kw, config=JCFG))
    jw = jdense.warp_statics
    assert jw.backend == "pallas"
    tdense = tfused.FusedOrthoFusionPlan(*_plan_args(sc),
                                         warp_kernel="pallas", device="cpu",
                                         **kw)
    plan = tfused.FusedOrthoFusionPlan.from_state(
        _jax_state(jdense), tplan.statics,
        warp_statics=tfused.WarpStatics(jw.resampling, jw.backend),
        device="cpu")
    assert plan.warp_statics == tdense.warp_statics
    out = plan(sc["raw"], slice_run["ts2"])
    for k, v in tdense(sc["raw"], slice_run["ts2"]).items():
        torch.testing.assert_close(out[k], v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_plan_warp_kernels(slice_run):
    """``warp_kernel="pallas"`` (the dense route) gives the default
    plan's utm_cube to 1e-5 with the same fill pixels (the dense and the
    tap sums agree to f32 rounding); ``"pallas_banded"`` is the default
    banded route, bit for bit. A bad backend in carried-over statics
    raises."""
    sc = slice_run["scene"]
    kw = dict(s2_nodata=65535.0, s2_scale=1e-4, config=CFG,
              srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]))
    base = slice_run["tout"]["utm_cube"]
    for wk, backend in (("pallas", "pallas"),
                        ("pallas_banded", "pallas_banded")):
        plan = tfused.FusedOrthoFusionPlan(*_plan_args(sc), warp_kernel=wk,
                                           device="cpu", **kw)
        assert plan.warp_statics.backend == backend
        u = plan.warp(sc["raw"])
        assert torch.equal(u == -9999.0, base == -9999.0)
        atol = 1e-5 if wk == "pallas" else 0.0
        torch.testing.assert_close(u, base, rtol=0, atol=atol)
    with pytest.raises(ValueError, match="backend"):
        tfused.FusedOrthoFusionPlan.from_state(
            slice_run["tplan"].state_dict_numpy(),
            slice_run["tplan"].statics,
            warp_statics=tfused.WarpStatics("cubic", "taploop"),
            device="cpu")


@pytest.fixture(scope="module")
def affine_run(slice_run):
    """Both packages' fusion plans with ``fusion_method="ot_affine"`` on
    their own slice utm_cube (equal to 1e-5) and the same S2 input."""
    sc = slice_run["scene"]
    args = (sc["utm60"], sc["s2_grid"], sc["wavelengths"], sc["good_mask"])
    kw = dict(fusion_method="ot_affine", s2_nodata=65535.0, s2_scale=1e-4,
              config=CFG, srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]))
    jout = JaxFusionPlan(*args, **dict(kw, config=JCFG))(
        slice_run["jout"]["utm_cube"],
                                      slice_run["js2"])
    tplan = tfused.FusedFusionPlan(*args, device="cpu", **kw)
    tout = tplan(slice_run["tout"]["utm_cube"], slice_run["ts2"])
    return dict(jout={k: np.asarray(v) for k, v in jout.items()},
                tout=tout, tplan=tplan)


def test_slice_ot_affine_statistically_equal(affine_run):
    """``ot_affine``: the (C+1, C) affine parameters (A over t), and the
    fused product. The packages draw their OT samples from different
    random streams, so the products agree statistically, as for
    ``ot_poly``: PSNR > 35 dB for the 10 m products and for the 60 m
    matched pixels, identical finite masks, values in [0, 1]."""
    from hyperres.pipeline import psnr

    j, t = affine_run["jout"], affine_run["tout"]
    assert t["coeffs"].shape == j["coeffs"].shape == (4, 3)
    fa, fb = t["fused_10m"].numpy(), j["fused_10m"]
    va, vb = np.isfinite(fa).all(-1), np.isfinite(fb).all(-1)
    np.testing.assert_array_equal(va, vb)
    assert psnr(fa[va], fb[vb]) > 35.0
    assert np.nanmax(fa) <= 1.0 and np.nanmin(fa) >= 0.0
    ma, mb = t["matched_60m"].numpy(), j["matched_60m"]
    ok = np.isfinite(ma).all(-1) & np.isfinite(mb).all(-1)
    assert ok.mean() > 0.5
    assert psnr(ma[ok], mb[ok]) > 35.0
    assert ma[ok].max() <= 1.0 and ma[ok].min() >= 0.0


def test_ot_affine_identity_fallback(slice_run, affine_run):
    """Under 2 valid 60 m pixels the affine parameters are the identity
    over a zero translation, exactly, whatever the rank-deficient fit
    gave."""
    cube = np.full(slice_run["jout"]["utm_cube"].shape, np.nan, np.float32)
    cube[5, 7] = slice_run["jout"]["utm_cube"][5, 7]
    out = affine_run["tplan"](cube, slice_run["ts2"])
    assert int(out["n_valid_60m"]) < 2
    want = np.concatenate([np.eye(3), np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_array_equal(out["coeffs"].numpy(), want)


def test_plan_rejects_unported_configs(slice_run):
    sc = slice_run["scene"]
    args = (sc["ortho_grid"], sc["utm60"], sc["s2_grid"],
            sc["raw"].shape[:2], sc["glt"], sc["wavelengths"])
    with pytest.raises(tfused.FusedUnsupported):
        tfused.FusedOrthoFusionPlan(*args, fusion_method="linear",
                                    device="cpu")
    with pytest.raises(tfused.FusedUnsupported):
        tfused.FusedOrthoFusionPlan(*args, fusion_method="histogram",
                                    device="cpu")
    with pytest.raises(tfused.FusedUnsupported):
        tfused.FusedOrthoFusionPlan(*args, warp_kernel="taploop",
                                    device="cpu")
    with pytest.raises(tfused.FusedUnsupported):
        tfused.FusedOrthoFusionPlan(*args, synth_method="box",
                                    device="cpu")


def test_identity_fallback_below_min_pixels(slice_run):
    """Fewer valid 60 m pixels than min_pixels: identity polynomial;
    return_intermediates adds the 60 m synthesis and S2 inputs."""
    sc = slice_run["scene"]
    cfg = PolyFusionConfig(min_pixels=10 ** 9, ot=CFG.ot)
    plan = tfused.FusedFusionPlan(
        sc["utm60"], sc["s2_grid"], sc["wavelengths"], sc["good_mask"],
        config=cfg, s2_nodata=65535.0, s2_scale=1e-4,
        return_intermediates=True,
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), device="cpu")
    out = plan(slice_run["tout"]["utm_cube"], slice_run["ts2"])
    ident = np.zeros((3, 5), np.float32)
    ident[:, -2] = 1.0
    np.testing.assert_array_equal(out["coeffs"].numpy(), ident)
    h, w = sc["utm60"].height, sc["utm60"].width
    assert out["synth_60m"].shape == out["s2_60m"].shape == (h, w, 3)


def test_chip_smoke_accuracy_metrics(slice_run):
    """chip_smoke's gate metrics equal bench.py's formulas (computed
    here in NumPy f64) on the slice's output: 1e-4 relative, and SAM to
    5e-6 rad absolute (arccos near 1 turns the f32 rounding of the
    cosine into ~sqrt(2 * 6e-8) rad per pixel)."""
    fused = slice_run["tout"]["fused_10m"]
    target = slice_run["tref"]
    coeffs = slice_run["tout"]["coeffs"]
    got = chip_smoke.accuracy_metrics(fused, target, coeffs)
    f, t = fused.numpy().astype(np.float64), target.numpy().astype(np.float64)
    c = coeffs.numpy().astype(np.float64)
    vf = np.isfinite(f).all(-1)
    e = np.asarray(jstats.erode_mask(jnp.asarray(vf & np.isfinite(t).all(-1)),
                                     2))
    n = max(e.sum(), 1)
    tt = np.nan_to_num(t)
    mapped = np.clip(np.stack([np.polyval(c[k], tt[..., k])
                               for k in range(3)], -1), 0.0, 1.0)

    def psnr_vs(ref):
        d = np.where(e[..., None], f - ref, 0.0)
        return 10 * np.log10(1.0 / (np.sum(d * d) / (n * 3)))

    cosang = np.sum(np.nan_to_num(f) * mapped, -1) / (
        np.linalg.norm(np.nan_to_num(f), axis=-1)
        * np.linalg.norm(mapped, axis=-1) + 1e-12)
    sam = np.sum(np.where(e, np.arccos(np.clip(cosang, -1, 1)), 0)) / n
    want = (vf.mean(), np.nanmax(f), psnr_vs(mapped), psnr_vs(t), sam)
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-4)
    assert abs(got[4] - want[4]) <= 5e-6

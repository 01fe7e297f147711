"""The port's ``fuse_pair`` (``hyperres_torch.pipeline``) and what it
stands on — the masked statistics, the linear fit, the box synthesis,
the histogram match and the linear calibration — against the JAX
reference on the CPU. Inputs are made with NumPy from a seed and given
to both packages; the port runs with ``device="cpu"``.

``engine="phases"`` samples its OT pixels with NumPy's generator in both
packages, so from one seed the two results agree to rounding; the fused
engines draw from different random streams and agree statistically for
the OT methods (the pin of ROADMAP.md's Queue 3), tightly for the two
methods that draw nothing."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres import pipeline as jpipe  # noqa: E402
from hyperres.core import config as jconfig  # noqa: E402
from hyperres.fusion import histogram as jhist  # noqa: E402
from hyperres.fusion.linear import calibrate_linear as j_calibrate  # noqa: E402
from hyperres.kernels import lstsq as jlstsq  # noqa: E402
from hyperres.kernels import srf as jsrf  # noqa: E402
from hyperres.kernels import stats as jstats  # noqa: E402
from hyperres_torch import pipeline as tpipe  # noqa: E402
from hyperres_torch.core.config import OTConfig, PolyFusionConfig  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.crs import transform as crs_transform  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.fusion import fused as tfused  # noqa: E402
from hyperres_torch.fusion import histogram as thist  # noqa: E402
from hyperres_torch.fusion.linear import calibrate_linear  # noqa: E402
from hyperres_torch.kernels import host  # noqa: E402
from hyperres_torch.kernels import lstsq as tlstsq  # noqa: E402
from hyperres_torch.kernels import srf as tsrf  # noqa: E402
from hyperres_torch.kernels import stats as tstats  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402
from hyperres_torch.testing.bench_scene import (  # noqa: E402
    emit_wavelength_grid, generate_scene,
)

T = torch.from_numpy
METHODS = ("ot_poly", "ot_affine", "linear", "histogram")
CFG = PolyFusionConfig(ot=OTConfig(n_samples=1500, num_itermax=120))
JCFG = jconfig.PolyFusionConfig(ot=jconfig.OTConfig(n_samples=1500,
                                                    num_itermax=120))


@pytest.fixture(autouse=True)
def parametric_srf(monkeypatch):
    """Both packages resolve the parametric SRF model, whatever this
    machine's cache holds."""
    monkeypatch.setenv("HYPERRES_SRF_SOURCE", "parametric")


# ---------------------------------------------------------------------------
# statistics and fits
# ---------------------------------------------------------------------------

def _masked_case(rng, shape=(31, 37)):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = np.nan
    return x, rng.random(shape) > 0.3


def test_masked_minmax_matches_jax(rng):
    """Bit-equal (a min and a max); (inf, -inf) for an empty mask."""
    x, mask = _masked_case(rng)
    x = np.nan_to_num(x)
    for m in (mask, np.zeros_like(mask)):
        want = jstats.masked_minmax(jnp.asarray(x), jnp.asarray(m))
        got = tstats.masked_minmax(T(x), T(m))
        assert [float(v) for v in got] == [float(v) for v in want]
    assert float(got[0]) == np.inf and float(got[1]) == -np.inf


def test_masked_percentile_matches_jax(rng):
    """``masked_percentile`` against ``jnp.nanpercentile`` of the masked
    values: rtol 1e-6 (the same order statistics, the linear combine in
    another f32 form); NaN for an empty mask."""
    x, mask = _masked_case(rng)
    qs = [0.0, 2.0, 37.5, 98.0, 100.0]
    want = np.asarray(jstats.masked_percentile(jnp.asarray(x),
                                               jnp.asarray(mask),
                                               jnp.asarray(qs)))
    got = tstats.masked_percentile(T(x), T(mask), qs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    empty = tstats.masked_percentile(T(x), T(np.zeros_like(mask)), qs)
    assert torch.isnan(empty).all()


def test_robust_norms_match_jax(rng):
    """``robust_norm`` / ``robust_norm_rgb``: atol 1e-6 on values in
    [0, 1] (percentiles to 1e-6 relative, then one division); NaN where
    the input is NaN or, for the rgb form, masked out."""
    x, mask = _masked_case(rng)
    want = np.asarray(jstats.robust_norm(jnp.asarray(x)))
    got = tstats.robust_norm(T(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    img = np.stack([x, 2.0 * x + 1.0, np.nan_to_num(x) ** 2], axis=-1)
    want = np.asarray(jstats.robust_norm_rgb(jnp.asarray(img),
                                             jnp.asarray(mask)))
    got = tstats.robust_norm_rgb(T(img), T(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[~mask]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("erode", [0, 2])
def test_cube_psnr_sam_matches_jax(erode, rng):
    """(valid fraction, PSNR, SAM): 1e-5 relative, SAM 5e-6 rad absolute
    (f32 sums over ~1e4 pixels in another order; arccos near 1)."""
    truth = rng.random((40, 46, 12)).astype(np.float32)
    cube = (truth + 0.01 * rng.standard_normal(truth.shape)).astype(
        np.float32)
    cube[rng.random((40, 46)) < 0.2] = -9999.0
    want = [float(v) for v in jstats.cube_psnr_sam(
        jnp.asarray(cube), jnp.asarray(truth), fill=-9999.0, erode=erode)]
    got = [float(v) for v in tstats.cube_psnr_sam(
        T(cube), T(truth), fill=-9999.0, erode=erode)]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    assert abs(got[2] - want[2]) <= 5e-6
    assert 35.0 < got[1] < 45.0


def test_linear_fit_masked_matches_jax(rng):
    """(a, b) in f32 against the reference's closed form on 20,000
    samples of which ~70 % valid: 2e-5 absolute (the five sums run in
    another order; the denominator n sxx - sx^2 keeps ~4 digits). The
    ``min_count`` fallback and the zero-denominator fallback are the
    identity, exactly."""
    x = rng.random(20000).astype(np.float32)
    y = (0.7 * x + 0.1 + 0.01 * rng.standard_normal(20000)).astype(
        np.float32)
    v = rng.random(20000) > 0.3
    want = [float(t) for t in jlstsq.linear_fit_masked(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(v))]
    got = [float(t) for t in tlstsq.linear_fit_masked(T(x), T(y), T(v))]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, [0.7, 0.1], atol=2e-3)
    few = np.zeros(20000, bool)
    few[:49] = True
    for valid, kw in ((few, {}), (v, {"min_count": 10 ** 6})):
        a, b = tlstsq.linear_fit_masked(T(x), T(y), T(valid), **kw)
        assert (float(a), float(b)) == (1.0, 0.0)
    a, b = tlstsq.linear_fit_masked(T(x), T(y), T(few), min_count=49)
    ja, jb = jlstsq.linear_fit_masked(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(few), min_count=49)
    np.testing.assert_allclose([float(a), float(b)], [float(ja), float(jb)],
                               atol=2e-4)
    # a constant x: the denominator vanishes -> a = 1, b = 0
    const = np.full(200, 0.0, np.float32)
    a, b = tlstsq.linear_fit_masked(T(const), T(y[:200]),
                                    T(np.ones(200, bool)))
    ja, jb = jlstsq.linear_fit_masked(jnp.asarray(const),
                                      jnp.asarray(y[:200]),
                                      jnp.asarray(np.ones(200, bool)))
    assert (float(a), float(b)) == (float(ja), float(jb)) == (1.0, 0.0)


def test_box_weights_and_pseudo_s2(rng):
    """``build_box_weight_matrix`` is a copy (array_equal), also with a
    band the good mask empties; ``pseudo_s2_srf_integral`` to 2e-6 with
    None for a band outside the EMIT range; ``pseudo_s2_rgb`` stacks
    B4, B3, B2 and refuses a missing band."""
    wl, good = emit_wavelength_grid(285)
    for gm, bands in ((None, None), (good, ["B2", "B3", "B4"])):
        a = host.build_box_weight_matrix(wl, good_mask=gm, bands=bands)
        b = jsrf.build_box_weight_matrix(wl, good_mask=gm, bands=bands)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
    none_good = np.zeros_like(good)
    assert not host.build_box_weight_matrix(wl, good_mask=none_good)[2].any()
    srf = builtin_srf("S2A", bands=["B2", "B3", "B4"])
    srf["far"] = (np.array([3000.0, 3010.0]), np.array([1.0, 1.0]))
    R = rng.random((9, 11, 285)).astype(np.float32)
    want = jsrf.pseudo_s2_srf_integral(R, wl, srf, good_mask=good)
    got = tsrf.pseudo_s2_srf_integral(R, wl, srf, good_mask=good,
                                      device="cpu")
    assert list(got) == list(want) and got["far"] is None is want["far"]
    for k in ("B2", "B3", "B4"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6)
    rgb = tsrf.pseudo_s2_rgb(got)
    np.testing.assert_array_equal(rgb, np.stack([got["B4"], got["B3"],
                                                 got["B2"]], axis=-1))
    with pytest.raises(ValueError, match="far"):
        tsrf.pseudo_s2_rgb(got, order=("B4", "far", "B2"))


# ---------------------------------------------------------------------------
# histogram match and linear calibration
# ---------------------------------------------------------------------------

def _hist_pair(src, sm, ref, rm):
    want = np.asarray(jhist._match_channel_device(
        jnp.asarray(src), jnp.asarray(sm), jnp.asarray(ref),
        jnp.asarray(rm)))
    got = thist._match_channel_device(T(src), T(sm), T(ref), T(rm)).numpy()
    return got, want


def test_histogram_channel_edge_cases(rng):
    """``torch.sort`` / ``searchsorted(right=True)`` against
    ``jnp.sort`` / ``searchsorted(side="right")`` where they could part:
    ties, +-inf among the valid values, NaN at unmasked positions (which
    pass through), another shape and mask for the reference. 1e-6
    absolute on values in [0, 1] (the rank quotient and one lerp in
    f32); masked-out pixels bit-equal."""
    src = rng.random((23, 29)).astype(np.float32)
    src = np.round(src * 20) / 20                       # ties
    sm = rng.random(src.shape) > 0.3
    src[~sm & (rng.random(src.shape) < 0.3)] = np.nan   # NaN, unmasked
    ref = rng.random((17, 13)).astype(np.float32) ** 2
    rm = rng.random(ref.shape) > 0.2
    got, want = _hist_pair(src, sm, ref, rm)
    np.testing.assert_array_equal(got[~sm], want[~sm])
    assert np.isnan(got[~sm]).any()
    np.testing.assert_allclose(got[sm], want[sm], rtol=0, atol=1e-6)
    # +-inf among the masked source values: the top and bottom ranks
    src2 = np.nan_to_num(src)
    idx = np.argwhere(sm)
    src2[tuple(idx[0])] = np.inf
    src2[tuple(idx[1])] = -np.inf
    got, want = _hist_pair(src2, sm, ref, rm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, equal_nan=True)
    assert np.isfinite(got[sm]).all()


def test_histogram_empty_masks(rng):
    """An empty reference mask (``n_ref = 0``: the clips index position
    0 of an all-inf array): every masked source pixel is NaN in both
    packages, the others pass through. An empty source mask: the source
    unchanged."""
    src = rng.random((9, 8)).astype(np.float32)
    ref = rng.random((9, 8)).astype(np.float32)
    sm = rng.random(src.shape) > 0.4
    none = np.zeros_like(sm)
    got, want = _hist_pair(src, sm, ref, none)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[sm]).all()
    np.testing.assert_array_equal(got[~sm], src[~sm])
    got, want = _hist_pair(src, none, ref, sm)
    np.testing.assert_array_equal(got, src)
    np.testing.assert_array_equal(want, src)


def test_histogram_match_rgb_matches_jax(rng):
    """The NumPy API, with and without ``ref_mask``: 1e-6, in [0, 1]."""
    src = rng.random((40, 36, 3)).astype(np.float32)
    ref = (rng.random((20, 18, 3)) ** 1.5).astype(np.float32)
    mask = rng.random((40, 36)) > 0.25
    rmask = rng.random((20, 18)) > 0.25
    want = jhist.histogram_match_rgb(src, ref, mask, ref_mask=rmask)
    got = thist.histogram_match_rgb(src, ref, mask, ref_mask=rmask,
                                    device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0
    same = rng.random((40, 36, 3)).astype(np.float32)
    np.testing.assert_allclose(
        thist.histogram_match_rgb(src, same, mask, device="cpu"),
        jhist.histogram_match_rgb(src, same, mask), rtol=0, atol=1e-6)


def test_calibrate_linear_matches_jax(rng):
    """Per-band (a, b) to 2e-5 and the corrected stack to 5e-5; the
    identity for a band under ``min_count`` valid pixels. A band with
    NaNs outside its valid pixels is NaN in the reference (see
    test_linear_fit_ignores_nan_outside_the_mask) and fitted here."""
    pseudo = rng.random((3, 60, 50)).astype(np.float32)
    real = (0.8 * pseudo + 0.05
            + 0.01 * rng.standard_normal(pseudo.shape)).astype(np.float32)
    real[1, :5] = np.nan
    pseudo[2] = -1.0                 # nothing above min_valid: identity
    valid = rng.random((60, 50)) > 0.2
    wc, wp = j_calibrate(pseudo, real, valid)
    gc, gp = calibrate_linear(pseudo, real, valid, device="cpu")
    gp, wp = np.asarray(gp), np.asarray(wp)
    np.testing.assert_allclose(gp[[0, 2]], wp[[0, 2]], rtol=0, atol=2e-5)
    assert tuple(gp[2]) == (1.0, 0.0)
    assert np.isnan(wp[1]).all()
    np.testing.assert_allclose(gp[1], [0.8, 0.05], atol=5e-3)
    np.testing.assert_allclose(gc[[0, 2]], wc[[0, 2]], rtol=0, atol=5e-5)
    assert gc.dtype == np.float32 and np.isfinite(gc).all()


def test_metric_copies(rng):
    """``psnr`` / ``sam`` are copies: equal floats, NaN pixels skipped,
    inf for equal inputs."""
    a = rng.random((20, 21, 4))
    b = a + 0.01 * rng.standard_normal(a.shape)
    b[3, 4] = np.nan
    assert tpipe.psnr(a, b) == jpipe.psnr(a, b)
    assert tpipe.sam(a, b) == jpipe.sam(a, b)
    assert tpipe.psnr(a, a) == float("inf")


# ---------------------------------------------------------------------------
# fuse_pair
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The bench scene at scale 0.05: the UTM cube (the port's default
    plan's warp, given to both packages), the S2 stack and the grids."""
    sc = generate_scene(0.05, 0)
    plan = tfused.FusedOrthoFusionPlan(
        sc["ortho_grid"], sc["utm60"], sc["s2_grid"], sc["raw"].shape[:2],
        sc["glt"], sc["wavelengths"], sc["good_mask"],
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), device="cpu")
    cube = plan.warp(sc["raw"]).numpy()
    args = (cube, sc["wavelengths"], sc["utm60"], sc["s2_dn"], sc["s2_grid"])
    kw = dict(good_mask=sc["good_mask"], s2_scale=1e-4, s2_nodata=65535.0)
    return dict(scene=sc, args=args, kw=kw)


def _run_both(pair, **kw):
    """One ``fuse_pair`` call per package; both must warn that the SRF
    model is the parametric one. (Module-scoped fixtures run before the
    function-scoped ``parametric_srf``, so the variable is set here.)"""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPERRES_SRF_SOURCE", "parametric")
        with pytest.warns(UserWarning, match="PARAMETRIC"):
            want = jpipe.fuse_pair(*pair["args"], config=JCFG,
                                   **dict(pair["kw"], **kw))
        with pytest.warns(UserWarning, match="PARAMETRIC"):
            got = tpipe.fuse_pair(*pair["args"], config=CFG, device="cpu",
                                  **dict(pair["kw"], **kw))
    return got, want


class _Runs:
    """``fuse_pair`` by one engine, each method run once per package
    when a test first asks for it: ``runs[method]`` is (port, jax)."""

    def __init__(self, pair, engine):
        self.pair, self.engine, self.done = pair, engine, {}

    def __getitem__(self, method):
        if method not in self.done:
            self.done[method] = _run_both(self.pair, fusion_method=method,
                                          engine=self.engine)
        return self.done[method]


@pytest.fixture(scope="module")
def phase_runs(pair):
    return _Runs(pair, "phases")


@pytest.fixture(scope="module")
def fused_runs(pair):
    return _Runs(pair, "fused")


def _hist_close(a, b):
    """The histogram products' bound (see
    test_fuse_pair_phases_matches_jax)."""
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    d = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
    assert (d <= 2e-5).mean() >= 0.98
    assert tpipe.psnr(a, b) > 60.0


def _same_masks(got, want):
    va = np.isfinite(got.fused_10m).all(-1)
    np.testing.assert_array_equal(va, np.isfinite(want.fused_10m).all(-1))
    assert 0.3 < va.mean() < 1.0
    return va


@pytest.mark.parametrize("method", METHODS)
def test_fuse_pair_phases_matches_jax(phase_runs, method):
    """Phase-wise engine, same seed: the same 60 m valid count and 10 m
    mask, the same info keys, ``engine == "phases"``; coefficients to
    2e-3 (an ill-conditioned degree-4 basis: the fitted curves agree to
    1e-4 over [0, 1]) and the products to 2e-4 for the OT methods (120
    Sinkhorn sweeps and a QR in another f32 order), 5e-5 for ``linear``.
    ``histogram`` is a step function of its input at ties: the stretch
    clips ~2 % of the pixels to exactly 0 and to exactly 1, and a 10 m
    value that is 1 in one package and 1 - 1e-7 in the other leaves or
    joins that tie group, which moves its rank by the group's size. So
    its bound is 2e-5 for 98 % of the values and PSNR > 60 dB in all."""
    got, want = phase_runs[method]
    assert got.info["engine"] == want.info["engine"] == "phases"
    assert sorted(got.info) == sorted(want.info)
    assert sorted(got.info["stages"]) == sorted(want.info["stages"])
    assert got.info["n_valid_60m"] == want.info["n_valid_60m"]
    assert got.info["srf_source"] == want.info["srf_source"] == "parametric"
    assert got.coeffs.shape == want.coeffs.shape
    va = _same_masks(got, want)
    if method == "histogram":
        _hist_close(got.fused_10m[va], want.fused_10m[va])
        _hist_close(got.matched_60m, want.matched_60m)
    else:
        atol = 5e-5 if method == "linear" else 2e-4
        np.testing.assert_allclose(got.fused_10m[va], want.fused_10m[va],
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(got.matched_60m, want.matched_60m,
                                   rtol=0, atol=atol, equal_nan=True)
    if method == "ot_poly":
        x = np.linspace(0.0, 1.0, 101)
        for c in range(3):
            assert np.abs(np.polyval(got.coeffs[c], x)
                          - np.polyval(want.coeffs[c], x)).max() < 1e-4
    else:
        np.testing.assert_allclose(got.coeffs, want.coeffs, rtol=0,
                                   atol=2e-3)
    assert np.nanmin(got.fused_10m) >= 0.0 and np.nanmax(got.fused_10m) <= 1.0


@pytest.mark.parametrize("method", METHODS)
def test_fuse_pair_fused_matches_jax(fused_runs, method):
    """Fused engine: ``engine == "fused"``, the same masks and info keys
    (``fused_program_includes_compile`` is False in the port). The OT
    methods draw their samples from different random streams in the two
    packages and agree statistically: PSNR > 35 dB. ``linear`` and
    ``histogram`` draw nothing: the phase-wise engine's bounds."""
    got, want = fused_runs[method]
    assert got.info["engine"] == want.info["engine"] == "fused"
    assert sorted(got.info) == sorted(want.info)
    assert sorted(got.info["stages"]) == sorted(want.info["stages"])
    assert got.info["stages"]["fused_program_includes_compile"] is False
    assert got.info["n_valid_60m"] == want.info["n_valid_60m"]
    assert got.coeffs.shape == want.coeffs.shape
    assert got.coeffs.dtype == np.float64
    va = _same_masks(got, want)
    if method.startswith("ot_"):
        assert tpipe.psnr(got.fused_10m[va], want.fused_10m[va]) > 35.0
    elif method == "histogram":
        _hist_close(got.fused_10m[va], want.fused_10m[va])
    else:
        np.testing.assert_allclose(got.fused_10m[va], want.fused_10m[va],
                                   rtol=0, atol=5e-5)
        np.testing.assert_allclose(got.coeffs, want.coeffs, rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("method", METHODS)
def test_fuse_pair_engines_agree(phase_runs, fused_runs, method):
    """The port's two engines on one input: PSNR >= 40 dB (the
    reference's own ``fused_psnr_gate``), the same 10 m mask."""
    fa, fb = fused_runs[method][0], phase_runs[method][0]
    va = np.isfinite(fa.fused_10m).all(-1)
    np.testing.assert_array_equal(va, np.isfinite(fb.fused_10m).all(-1))
    assert tpipe.psnr(fa.fused_10m[va], fb.fused_10m[va]) >= 40.0


@pytest.mark.parametrize("engine", ["phases", "fused"])
def test_fuse_pair_box_synthesis(pair, engine, phase_runs):
    """``synth_method="box"``: no SRF table is resolved (no warning);
    ``linear`` (deterministic in both engines) to 5e-5 of the
    reference's; the product differs from the SRF synthesis's."""
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*PARAMETRIC.*")
        got = tpipe.fuse_pair(*pair["args"], config=CFG, device="cpu",
                              synth_method="box", fusion_method="linear",
                              engine=engine, **pair["kw"])
    want = jpipe.fuse_pair(*pair["args"], config=JCFG, synth_method="box",
                           fusion_method="linear", engine=engine,
                           **pair["kw"])
    va = _same_masks(got, want)
    np.testing.assert_allclose(got.fused_10m[va], want.fused_10m[va],
                               rtol=0, atol=5e-5)
    srf_run = phase_runs["linear"][0]
    assert np.abs(got.coeffs - srf_run.coeffs).max() > 1e-4


def _cross_crs_s2_grid(sc):
    """A 10 m grid in UTM zone 32 laid over the scene's zone-33 60 m
    grid: the same pixel count as the scene's S2 grid, centred on it."""
    g60, s2 = sc["utm60"], sc["s2_grid"]
    cx = g60.x0 + g60.width * g60.dx / 2.0
    cy = g60.y0 - g60.height * g60.dy / 2.0
    other = CRS.utm(32, True)
    x, y = crs_transform(g60.crs, other, np.array([cx]), np.array([cy]))
    return Grid(other, float(x[0]) - s2.width * 5.0,
                float(y[0]) + s2.height * 5.0, 10.0, 10.0, s2.width,
                s2.height)


def test_fuse_pair_auto_engine(pair, monkeypatch):
    """``engine="auto"`` runs the fused plan on same-CRS grids and falls
    through to the phase-wise path on cross-CRS grids, and only for
    ``FusedUnsupported``: there it agrees with the reference's
    phase-wise run on the same grids and seed (2e-4; the 10 m upsample
    is the generic two-pass warp with a nodata value), ``engine="fused"``
    raises, and another fault of the fused plan propagates."""
    sc = pair["scene"]
    same = tpipe.fuse_pair(*pair["args"], config=CFG, device="cpu",
                           fusion_method="linear", **pair["kw"])
    assert same.info["engine"] == "fused"
    assert sc["utm60"].crs == CRS.utm(33, True)
    args = pair["args"][:4] + (_cross_crs_s2_grid(sc),)
    got = tpipe.fuse_pair(*args, config=CFG, device="cpu", **pair["kw"])
    want = jpipe.fuse_pair(*args, config=JCFG, **pair["kw"])
    assert got.info["engine"] == want.info["engine"] == "phases"
    assert got.info["n_valid_60m"] == want.info["n_valid_60m"]
    va = np.isfinite(got.fused_10m).all(-1)
    vb = np.isfinite(want.fused_10m).all(-1)
    assert (va == vb).mean() > 0.9999 and va.mean() > 0.3
    both = va & vb
    np.testing.assert_allclose(got.fused_10m[both], want.fused_10m[both],
                               rtol=0, atol=2e-4)
    with pytest.raises(tfused.FusedUnsupported, match="same-CRS"):
        tpipe.fuse_pair(*args, config=CFG, device="cpu", engine="fused",
                        **pair["kw"])

    def broken(*a, **k):
        raise RuntimeError("scanline_resample kernel launch failed")

    monkeypatch.setattr(tpipe, "_fuse_pair_fused", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tpipe.fuse_pair(*pair["args"], config=CFG, device="cpu",
                        **pair["kw"])


def test_linear_fit_ignores_nan_outside_the_mask(pair):
    """A pin of a reference fault that the port does not copy: on grids
    where the S2 stack leaves some 60 m pixels uncovered (NaN, outside
    the valid mask), the reference's ``linear_fit_masked`` multiplies
    those NaNs by zero weights and its ``linear`` product is NaN
    everywhere; the port zeroes them first and fits the valid pixels."""
    args = pair["args"][:4] + (_cross_crs_s2_grid(pair["scene"]),)
    kw = dict(fusion_method="linear", engine="phases", **pair["kw"])
    got = tpipe.fuse_pair(*args, config=CFG, device="cpu", **kw)
    want = jpipe.fuse_pair(*args, config=JCFG, **kw)
    assert np.isnan(want.coeffs).all()
    assert not np.isfinite(want.fused_10m).any()
    assert np.isfinite(got.coeffs).all()
    assert np.isfinite(got.fused_10m).all(-1).mean() > 0.3
    assert np.abs(got.coeffs[:, 0] - 1.0).max() < 0.5


def test_fuse_pair_rejects_unknown_arguments(pair):
    """An unknown engine is a ValueError; an unknown method raises
    ``FusedUnsupported`` under ``engine="fused"`` and ValueError from
    the phase-wise path under ``"auto"``, as in the reference."""
    with pytest.raises(ValueError, match="engine"):
        tpipe.fuse_pair(*pair["args"], device="cpu", engine="jit")
    with pytest.raises(tfused.FusedUnsupported):
        tpipe.fuse_pair(*pair["args"], device="cpu", engine="fused",
                        fusion_method="spline", **pair["kw"])
    with pytest.raises(ValueError, match="fusion_method"):
        tpipe.fuse_pair(*pair["args"], device="cpu", engine="auto",
                        fusion_method="spline", **pair["kw"])
    with pytest.raises(ValueError, match="fusion_method"):
        jpipe.fuse_pair(*pair["args"], engine="auto",
                        fusion_method="spline", **pair["kw"])


def test_engines_differ_no_more_than_two_sample_draws(pair, phase_runs,
                                                      fused_runs):
    """What ``verify_granule``'s fused gate measures: the fused and the
    phase-wise ``ot_poly`` products come from two draws of OT samples,
    and two draws of one engine (seeds 0, 1, 2 of the fused engine) lie
    as far apart (on an H100 at full width 40-49 dB,
    ``scripts/torch_verify_gate_spread.py``). A systematic difference
    between the engines would put the cross-engine PSNR far under the
    seed-to-seed ones: it must come within 6 dB of the least of them,
    and both over 30 dB (a wrong map, such as swapped channels, lies
    under 25 dB)."""
    from hyperres_torch.core.config import OTConfig as OT

    products = [fused_runs["ot_poly"][0].fused_10m]
    for seed in (1, 2):
        cfg = PolyFusionConfig(ot=OT(n_samples=1500, num_itermax=120,
                                     seed=seed))
        products.append(tpipe.fuse_pair(
            *pair["args"], config=cfg, device="cpu", engine="fused",
            **pair["kw"]).fused_10m)
    va = np.isfinite(products[0]).all(-1)
    noise = min(tpipe.psnr(a[va], b[va]) for i, a in enumerate(products)
                for b in products[i + 1:])
    cross = tpipe.psnr(products[0][va],
                       phase_runs["ot_poly"][0].fused_10m[va])
    assert 30.0 < noise < 70.0
    assert cross >= max(noise - 6.0, 30.0)

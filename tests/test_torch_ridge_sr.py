"""The PyTorch port's ridge spectral-SR path against the JAX reference on
the CPU: the monomial tables, the ridge helpers, the u16 quantization,
the fit, ``predict``/``forward``, ``predict_cube``, ``predict_cube_u16``
against both JAX engines (the XLA program and the fused Pallas kernel in
interpret mode), the row-major serving form against the row-major Pallas
kernel, the ``.npz`` checkpoint in both directions and the entry forward.
Inputs are made with NumPy from a seed and given to both packages. The
hand-written kernel itself runs only on a CUDA device (on the card:
tests_gpu/).

The ``engine=`` argument is held to the reference's: ``"xla"`` against
the reference's XLA program for models the kernel does not take,
``"auto"``'s rule, ``"pallas"`` raising past the kernel's limits; the
streamed route's chunked TF32 accumulation is emulated on the CPU from
the very slabs the kernel reads.

Tolerances: u16 products agree on the 65535 mask exactly and to 1 step
elsewhere (the ridge contraction sums in another order, which moves a
value sitting on a rounding edge by one step). Reflectances from the
same parameters agree to 1e-5 absolute (f32 sums of 285 terms).
"""

import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402
from hyperres.core.config import RidgeSRConfig as JRidgeSRConfig  # noqa: E402
from hyperres.fusion import ridge_sr as jridge  # noqa: E402
from hyperres.kernels import lstsq as jlstsq  # noqa: E402
from hyperres.kernels import stats as jstats  # noqa: E402
from hyperres.kernels.pallas_ops import pallas_sr_predict_u16  # noqa: E402
from hyperres_torch.core.config import RidgeSRConfig  # noqa: E402
from hyperres_torch.device import launch_counts, reset_launch_counts  # noqa: E402
from hyperres_torch.fusion import ridge_sr as tridge  # noqa: E402
from hyperres_torch.kernels import host  # noqa: E402
from hyperres_torch.kernels import lstsq as tlstsq  # noqa: E402
from hyperres_torch.kernels import sr_predict  # noqa: E402
from hyperres_torch.kernels import stats as tstats  # noqa: E402

T = torch.from_numpy
NODATA = -9999.0
#: (Bx, By, degree): a small model and the product model (F = 285)
MODELS = {"small": (6, 12, 2), "product": (10, 32, 3)}


def _training_data(bx, by, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((n, bx)).astype(np.float32)
    Y = np.clip(0.1 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2]
                + 0.1 * rng.random((n, by)), 0.01, 0.99).astype(np.float32)
    return X, Y


def _cube(bx, h, w, seed):
    """(Bx, H, W) in [0, 1) with a NaN band, a nodata band and a pixel
    that is nodata in every band."""
    cube = np.random.default_rng(seed).random((bx, h, w)).astype(np.float32)
    cube[2, 3, 5] = np.nan
    cube[bx - 1, 10, 2] = NODATA
    cube[:, 20, 30] = NODATA
    return cube


def _carry(jmodel):
    """The port's model holding the JAX model's parameters."""
    p = jmodel.params
    return tridge.RidgeSpectralSR(
        jmodel.n_inputs, jmodel.n_outputs,
        RidgeSRConfig(**asdict(jmodel.cfg)), device="cpu").params_from_numpy(
        np.asarray(p.x_mean), np.asarray(p.x_std), np.asarray(p.W),
        np.asarray(p.intercept))


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name, (bx, by, deg) in MODELS.items():
        X, Y = _training_data(bx, by, 6000, 1)
        m = jridge.RidgeSpectralSR(bx, by, JRidgeSRConfig(degree=deg,
                                                          batch_pixels=512))
        out[name] = m.fit(X, Y)
    return out


def _assert_u16_close(got, want, steps=1):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.uint16
    np.testing.assert_array_equal(got == 65535, want == 65535)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= steps, d.max()


# -- host tables and plain helpers ------------------------------------------

@pytest.mark.parametrize("bx,degree,bias", [(4, 2, False), (6, 2, True),
                                            (10, 3, False)])
def test_monomial_tables_copy(bx, degree, bias):
    """Port-owned copies == hyperres.kernels.lstsq's (array_equal)."""
    e = host.poly_feature_exponents(bx, degree, bias)
    f = host.poly_factor_indices(bx, degree, bias)
    np.testing.assert_array_equal(
        e, jlstsq.poly_feature_exponents(bx, degree, bias))
    np.testing.assert_array_equal(
        f, jlstsq.poly_factor_indices(bx, degree, bias))
    assert f.dtype == np.int32
    if (bx, degree) == (10, 3):
        assert f.shape == (285, 3)


@pytest.mark.parametrize("bx,degree", [(4, 2), (10, 3)])
def test_poly_expander_matches_jax(bx, degree, rng):
    """The gathered-column products equal the reference's bit for bit
    (same factors, multiplied in the same order)."""
    X = rng.standard_normal((300, bx)).astype(np.float32)
    texp, tf = tlstsq.make_poly_expander(bx, degree)
    jexp, jf = jlstsq.make_poly_expander(bx, degree)
    assert tf == jf
    np.testing.assert_array_equal(texp(T(X)).numpy(),
                                  np.asarray(jexp(jnp.asarray(X))))


def test_ridge_helpers_match_jax(rng):
    """logit/sigmoid (with their clips) to 1e-6 relative, the f32
    Cholesky ridge solve to 1e-4 relative (another elimination order),
    per-band R^2/RMSE to 1e-5 relative."""
    x = np.concatenate([rng.random(200), [0.0, 1.0, 1e-6, 1 - 1e-7]]
                       ).astype(np.float32)
    np.testing.assert_allclose(tlstsq.logit(T(x), 1e-4).numpy(),
                               np.asarray(jlstsq.logit(jnp.asarray(x), 1e-4)),
                               rtol=1e-6, atol=1e-6)
    z = np.concatenate([rng.standard_normal(200) * 20, [-80.0, 80.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(tlstsq.sigmoid(T(z)).numpy(),
                               np.asarray(jlstsq.sigmoid(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-7)
    A = rng.standard_normal((400, 20)).astype(np.float32)
    XtX = (A.T @ A).astype(np.float32)
    XtY = rng.standard_normal((20, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tlstsq.ridge_solve(T(XtX), T(XtY), 0.5).numpy(),
        np.asarray(jlstsq.ridge_solve(jnp.asarray(XtX), jnp.asarray(XtY),
                                      0.5)), rtol=1e-4, atol=1e-6)
    yt = rng.random((500, 7)).astype(np.float32)
    yp = (yt + 0.05 * rng.standard_normal((500, 7))).astype(np.float32)
    yp[3, 2] = np.nan
    for a, b in zip(tlstsq.r2_rmse_per_band(T(yt), T(yp)),
                    jlstsq.r2_rmse_per_band(jnp.asarray(yt),
                                            jnp.asarray(yp))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_quantize_reflectance_u16_matches_jax(rng):
    """Exact: rint half to even, the clip to [0, 65534], the nodata
    fill."""
    x = np.concatenate([rng.random(500) * 7.0 - 0.5,
                        [0.00005, 0.00015, 0.00025, 6.5534, 6.5535, -1.0,
                         np.nan]]).astype(np.float32)
    valid = np.isfinite(x) & (rng.random(x.size) > 0.1)
    got = tstats.quantize_reflectance_u16(T(np.nan_to_num(x)), T(valid))
    want = jstats.quantize_reflectance_u16(jnp.asarray(np.nan_to_num(x)),
                                           jnp.asarray(valid))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_predict_and_forward_with_carried_params(jax_models, name, rng):
    """JAX parameters carried into the port: predict / forward == JAX
    predict to 1e-5; predict_cube's NaN pattern identical and values to
    1e-5; evaluate's R^2 / RMSE to 1e-5."""
    jm = jax_models[name]
    tm = _carry(jm)
    X = rng.random((700, jm.n_inputs)).astype(np.float32)
    want = jm.predict(X)
    np.testing.assert_allclose(tm.predict(X).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tm(T(X)).numpy(), want, atol=1e-5)
    cube = _cube(jm.n_inputs, 23, 37, 2)
    pc = tm.predict_cube(cube, nodata=NODATA, batch_pixels=100).numpy()
    jc = jm.predict_cube(cube, nodata=NODATA)
    np.testing.assert_array_equal(np.isnan(pc), np.isnan(jc))
    np.testing.assert_allclose(pc, jc, atol=1e-5)
    Y = np.clip(want + 0.01, 0, 1).astype(np.float32)
    for a, b in zip(tm.evaluate(X, Y), jm.evaluate(X, Y)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(MODELS))
def test_predict_cube_u16_matches_jax(jax_models, name, engine):
    """predict_cube_u16 == JAX predict_cube_u16 (the XLA program, and the
    fused Pallas kernel in interpret mode), 37 x 41 px (not a multiple of
    any tile or batch) with NaN and -9999 pixels: identical 65535 mask,
    <= 1 step. The row-major layout gives the same product."""
    jm = jax_models[name]
    tm = _carry(jm)
    cube = _cube(jm.n_inputs, 37, 41, 3)
    want = jm.predict_cube_u16(cube, nodata=NODATA, engine=engine)
    got = tm.predict_cube_u16(cube, nodata=NODATA)
    assert tuple(got.shape) == (jm.n_outputs, 37, 41)
    _assert_u16_close(got.numpy(), want)
    assert (got[:, 3, 5] == 65535).all() and (got[:, 10, 2] == 65535).all()
    assert int((got == 65535).sum()) == 3 * jm.n_outputs
    hwb = np.ascontiguousarray(cube.transpose(1, 2, 0))
    rm = tm.predict_cube_u16(hwb, nodata=NODATA, layout="rowmajor")
    np.testing.assert_array_equal(rm.permute(2, 0, 1).numpy(), got.numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_rowmajor_serving_matches_pallas(jax_models, name, rng):
    """sr_predict_u16(X, valid, model) == pallas_sr_predict_u16 in
    interpret mode (tile_rows 256, N = 1000 not a multiple): identical
    mask, <= 1 step."""
    jm = jax_models[name]
    tm = _carry(jm)
    X = rng.random((1000, jm.n_inputs)).astype(np.float32)
    valid = rng.random(1000) > 0.2
    sels, _ = jlstsq.poly_selector_matrices(jm.n_inputs, jm.cfg.degree)
    p = jm.params
    want = pallas_sr_predict_u16(
        jnp.asarray(X), jnp.asarray(valid), p.x_mean, p.x_std,
        tuple(jnp.asarray(s) for s in sels), p.W, p.intercept,
        tile_rows=256, interpret=True)
    got = tridge.sr_predict_u16(X, valid, tm)
    _assert_u16_close(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_matches_jax(weighted):
    """The port's own fit against the JAX fit on the same data (product
    model, 20k px): x_mean / x_std to 1e-6 relative; the port sums and
    solves the Gram system in f64, the reference in f32, so the
    predictions agree to 1e-5 (largest difference measured on the CPU:
    2.0e-6)."""
    bx, by, deg = MODELS["product"]
    X, Y = _training_data(bx, by, 20000, 4)
    w = None
    if weighted:
        w = np.random.default_rng(5).random(20000).astype(np.float32)
    jm = jridge.RidgeSpectralSR(bx, by, JRidgeSRConfig(degree=deg)).fit(
        X, Y, w)
    tm = tridge.RidgeSpectralSR(bx, by, RidgeSRConfig(degree=deg),
                                device="cpu").fit(X, Y, w)
    np.testing.assert_allclose(tm.x_mean.numpy(),
                               np.asarray(jm.params.x_mean), rtol=1e-6)
    np.testing.assert_allclose(tm.x_std.numpy(),
                               np.asarray(jm.params.x_std), rtol=1e-6)
    Xq = np.random.default_rng(6).random((2000, bx)).astype(np.float32)
    np.testing.assert_allclose(tm.predict(Xq).numpy(), jm.predict(Xq),
                               atol=1e-5)


def test_checkpoint_crosses_both_ways(jax_models, tmp_path, rng):
    """A JAX save_params .npz loads into the port and predicts the same
    (1e-5); the port's .npz loads into JAX and predicts the same."""
    jm = jax_models["product"]
    jax_ckpt = tmp_path / "jax.npz"
    jridge.save_params(jax_ckpt, jm)
    tm = tridge.load_params(jax_ckpt, device="cpu")
    assert type(tm.cfg) is RidgeSRConfig
    assert asdict(tm.cfg) == asdict(jm.cfg) and tm.n_outputs == jm.n_outputs
    X = rng.random((300, jm.n_inputs)).astype(np.float32)
    np.testing.assert_allclose(tm.predict(X).numpy(), jm.predict(X),
                               atol=1e-5)
    port_ckpt = tmp_path / "port.npz"
    tridge.save_params(port_ckpt, tm)
    back = jridge.load_params(port_ckpt)
    assert back.cfg == jm.cfg and type(back.cfg) is JRidgeSRConfig
    np.testing.assert_array_equal(np.asarray(back.params.W),
                                  np.asarray(jm.params.W))
    np.testing.assert_allclose(back.predict(X), jm.predict(X), atol=0)


def test_entry_matches_graft_entry():
    """hyperres_torch.entry: the forward batch equals
    __graft_entry__.entry's; with the reference's parameters (a JAX fit
    on the same pixels) the port's forward equals the reference forward
    to 1e-5; the port's own entry forward (its own fit) is (8192, 285),
    finite, and also within 1e-5 of the reference (measured: 1.8e-6)."""
    import __graft_entry__
    from hyperres_torch.entry import entry, entry_data

    jfwd, (jx,) = __graft_entry__.entry()
    want = np.asarray(jfwd(jx))
    X, Y, x = entry_data()
    np.testing.assert_array_equal(x, np.asarray(jx))
    jm = jridge.RidgeSpectralSR(10, 285, JRidgeSRConfig(degree=3)).fit(X, Y)
    np.testing.assert_allclose(_carry(jm)(T(x)).numpy(), want, atol=1e-5)
    fwd, (tx,) = entry("cpu")
    got = fwd(tx).detach().numpy()
    assert got.shape == (8192, 285) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


#: f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (the port's own
#: helper, which also splits W for the streamed route)
_tf32_rna = sr_predict.tf32_rna


def _sr_tf32_u16(X, model, nodata, terms=3):
    """The SR kernel's arithmetic on a (N, Bx) batch in plain torch: the
    monomials and W split into TF32 hi = rna(x) and lo = rna(x - hi),
    the contraction as hi.hi + lo.hi + hi.lo in f32 (the kernel's
    accumulators, added in its order), or hi.hi alone with
    ``terms=1``; then the intercept, sigmoid and u16 code."""
    valid = sr_predict.valid_pixels(X, nodata)
    feats = tlstsq.poly_expand(
        (torch.nan_to_num(X) - model.x_mean) / model.x_std,
        model.factors.to(torch.int64))
    a_hi, b_hi = _tf32_rna(feats), _tf32_rna(model.W)
    z = a_hi @ b_hi
    if terms == 3:
        a_lo = _tf32_rna(feats - a_hi)
        b_lo = _tf32_rna(model.W - b_hi)
        z = (z + a_lo @ b_hi) + a_hi @ b_lo
    return tstats.quantize_reflectance_u16(
        tlstsq.sigmoid(z + model.intercept), valid[:, None])


@pytest.mark.parametrize("by", [32, 285])
def test_three_term_tf32_matches_f32(by):
    """The kernel's three-term TF32 contraction, emulated on the CPU, for
    degree-3 models from 10 bands fitted on chip_smoke.py's synthetic
    SR pixels (scripts/bench_sr_granule.py:56-62; 20k here): on a seeded
    96 x 80 px cube with a NaN and nodata pixels, the u16 product is <= 1
    step from the f32 plain version (sr_predict_u16_reference) and from
    JAX's predict_cube_u16, with identical 65535 masks (the dropped
    lo.lo term is ~2^-22 of each product, f32 level). One-pass TF32
    (hi.hi alone, ~2^-11 per product) is shown to miss that bound on the
    same data."""
    rng = np.random.default_rng(0)
    X = rng.random((20000, 10)).astype(np.float32)
    Y = np.clip(0.15 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2]
                + 0.05 * rng.random((20000, by)), 0.01,
                0.99).astype(np.float32)
    jm = jridge.RidgeSpectralSR(10, by, JRidgeSRConfig(degree=3)).fit(X, Y)
    tm = _carry(jm)
    cube = _cube(10, 96, 80, 9)
    Xp = T(cube.reshape(10, -1).T.copy())
    got = _sr_tf32_u16(Xp, tm, NODATA).T
    args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
    plain = sr_predict.sr_predict_u16_reference(
        T(cube.reshape(10, -1)), *args, nodata=NODATA)
    _assert_u16_close(got.numpy(), plain.numpy())
    want = jm.predict_cube_u16(cube, nodata=NODATA).reshape(by, -1)
    _assert_u16_close(got.numpy(), want)
    assert int((got == 65535).sum()) == 3 * by
    one = _sr_tf32_u16(Xp, tm, NODATA, terms=1).T
    d = (one.to(torch.int32) - plain.to(torch.int32)).abs().max()
    assert int(d) > 1


@pytest.mark.parametrize("bx,degree,bias", [(10, 3, False), (10, 4, False),
                                            (4, 2, True), (16, 2, False),
                                            (10, 1, False)])
def test_pair_table(bx, degree, bias, rng):
    """The kernel's K order (sr_pair_table): every monomial fills exactly
    one K column, the rest are padding with a zero W row; the two
    monomials of a pair share every factor but the last; forming each
    pair as the kernel does (prefix product, then times each last
    factor) gives poly_expand's monomials bit for bit. Pairs pad to a
    multiple of 16; the four pairs of a full block of 8 read rows that
    are different mod 4 (the shared-memory banks of the kernel's
    inputs)."""
    fac = host.poly_factor_indices(bx, degree, bias)
    pairs, src = sr_predict.sr_pair_table(fac)
    width = 4 if degree <= 3 else 5
    assert pairs.shape[1] == width and pairs.shape[0] % 16 == 0
    assert src.shape == (2 * pairs.shape[0],)
    assert sorted(src[src >= 0].tolist()) == list(range(fac.shape[0]))
    x = rng.standard_normal((50, bx)).astype(np.float32)
    ext = np.concatenate([np.ones((50, 1), np.float32), x], axis=1)
    want = tlstsq.poly_expand(T(x), T(fac).to(torch.int64)).numpy()
    got = np.zeros((50, src.shape[0]), np.float32)
    for q, row in enumerate(pairs):
        p = ext[:, row[0]]
        for r in row[1:width - 2]:
            p = p * ext[:, r]
        col = 8 * (q // 4) + q % 4
        got[:, col] = p * ext[:, row[width - 2]]
        got[:, col + 4] = p * ext[:, row[width - 1]]
    live = src >= 0
    np.testing.assert_array_equal(got[:, live], want[:, src[live]])
    for q, row in enumerate(pairs):
        col = 8 * (q // 4) + q % 4
        if src[col] >= 0 and src[col + 4] >= 0:
            a, b = fac[src[col]], fac[src[col + 4]]
            nz_a, nz_b = a[a != 0], b[b != 0]
            assert nz_a[:-1].tolist() == nz_b[:-1].tolist()
    if (bx, degree) == (10, 3):   # the product: 32 pairs, 3 % padding
        assert pairs.shape[0] == 160
        step = pairs[:4]           # the degree-1 block: x_1..x_4, x_5..x_8
        assert sorted(step[:, 2] % 4) == [0, 1, 2, 3]


def test_pair_table_cache():
    """The wrapper reads a factor table back once: the same tensor gives
    the same cached pair table, an in-place change or another tensor its
    own, and the entry goes with its tensor."""
    fac = torch.from_numpy(host.poly_factor_indices(10, 3, False))
    a = sr_predict._device_pairs(fac)
    assert sr_predict._device_pairs(fac)[0] is a[0]
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.int32
    np.testing.assert_array_equal(a[0].numpy(),
                                  sr_predict.sr_pair_table(fac.numpy())[0])
    other = torch.from_numpy(host.poly_factor_indices(4, 2, False))
    assert sr_predict._device_pairs(other)[0].shape[0] == 16
    fac[0, 0] = 2
    b = sr_predict._device_pairs(fac)
    assert b[0] is not a[0]
    key = id(other)
    del other
    assert key not in sr_predict._PAIRS


def test_kernel_shared_memory_limit():
    """The wrapper's mirror of the kernel's shared-memory plan: 32 bands
    per CTA up to 800 K columns, 16 up to 1632 (1600 at degree 4), none
    above. The product (10 bands, degree 3, F = 285) takes 320 columns
    at 32 bands; degree 4 from 10 bands (F = 1000) 1184 at 16; 12 bands
    at degree 4 (F = 1819) 2080, which the kernel does not take."""
    tb = sr_predict.sr_tile_bands
    assert [tb(k, 3) for k in (32, 800, 832, 1632, 1664)] == [
        32, 32, 16, 16, 0]
    assert [tb(k, 4) for k in (1600, 1632)] == [16, 0]
    for (bx, degree), (k_cols, bands) in {(10, 3): (320, 32),
                                          (10, 4): (1184, 16),
                                          (12, 4): (2080, 0)}.items():
        fac = host.poly_factor_indices(bx, degree, False)
        assert sr_predict.sr_k_columns(fac) == k_cols
        assert tb(k_cols, degree) == bands


# -- engines and routes --------------------------------------------------------

#: (Bx, By, degree) of models past the kernel's limits (Bx <= 16, degree
#: <= 4): too many bands (F = 189), too high a degree (F = 125)
XLA_MODELS = {"bx18_deg2": (18, 9, 2), "bx4_deg5": (4, 7, 5)}


def _fit_jax(bx, by, degree, n=4000, seed=11, batch=512):
    X, Y = _training_data(bx, by, n, seed)
    return jridge.RidgeSpectralSR(
        bx, by, JRidgeSRConfig(degree=degree, batch_pixels=batch)).fit(X, Y)


@pytest.mark.parametrize("name", list(XLA_MODELS))
def test_engine_xla_matches_jax(name):
    """predict_cube_u16(engine="xla") and engine="auto" (which is "xla"
    for these models) == the reference's predict_cube_u16(engine="xla")
    on a 37 x 41 px cube with NaN and -9999 pixels (not a multiple of the
    512-px batch): identical 65535 mask, <= 1 step; the row-major layout
    and the serving form give the same codes; no kernel is counted."""
    jm = _fit_jax(*XLA_MODELS[name])
    tm = _carry(jm)
    cube = _cube(jm.n_inputs, 37, 41, 3)
    want = jm.predict_cube_u16(cube, nodata=NODATA, engine="xla")
    reset_launch_counts()
    for engine in ("xla", "auto"):
        got = tm.predict_cube_u16(cube, nodata=NODATA, engine=engine)
        assert tm.last_engine == "xla"
        assert tuple(got.shape) == (jm.n_outputs, 37, 41)
        _assert_u16_close(got.numpy(), want)
        assert int((got == 65535).sum()) == 3 * jm.n_outputs
    hwb = np.ascontiguousarray(cube.transpose(1, 2, 0))
    rm = tm.predict_cube_u16(hwb, nodata=NODATA, layout="rowmajor")
    np.testing.assert_array_equal(rm.permute(2, 0, 1).numpy(), got.numpy())
    flat = hwb.reshape(-1, jm.n_inputs)
    valid = sr_predict.valid_pixels(T(flat), NODATA)
    serve = tridge.sr_predict_u16(flat, valid, tm)
    np.testing.assert_array_equal(
        serve.numpy(), rm.reshape(-1, jm.n_outputs).numpy())
    assert not launch_counts


@pytest.mark.parametrize("name", list(MODELS))
def test_engines_agree_within_the_kernels_limits(jax_models, name):
    """For a model the kernel takes, engine="xla" is within 1 step of
    engine="pallas" (on the CPU: the kernel's plain version) and of the
    reference's "xla" program, with identical masks; "auto" takes
    "pallas" and gives its codes."""
    jm = jax_models[name]
    tm = _carry(jm)
    cube = _cube(jm.n_inputs, 37, 41, 3)
    xla = tm.predict_cube_u16(cube, nodata=NODATA, engine="xla")
    assert tm.last_engine == "xla"
    _assert_u16_close(xla.numpy(),
                      jm.predict_cube_u16(cube, nodata=NODATA, engine="xla"))
    pal = tm.predict_cube_u16(cube, nodata=NODATA, engine="pallas")
    _assert_u16_close(xla.numpy(), pal.numpy())
    auto = tm.predict_cube_u16(cube, nodata=NODATA)
    assert tm.last_engine == "pallas"
    np.testing.assert_array_equal(auto.numpy(), pal.numpy())


@pytest.mark.parametrize("bx,degree,want", [
    (10, 3, "pallas"), (12, 4, "pallas"), (16, 4, "pallas"), (1, 1, "pallas"),
    (17, 1, "xla"), (18, 2, "xla"), (4, 5, "xla")])
def test_engine_rule(bx, degree, want):
    """engine="auto" is "pallas" where the kernel takes the model (Bx <=
    16 and degree <= 4) and "xla" otherwise, from the model's shape alone
    (nothing is fitted, nothing runs); engine="pallas" raises ValueError
    past the limits and "xla" is always taken; an unknown engine raises."""
    tm = tridge.RidgeSpectralSR(bx, 3, RidgeSRConfig(degree=degree),
                                device="cpu")
    assert tm.resolve_engine("auto") == want
    assert tm.resolve_engine() == want
    assert sr_predict.kernel_takes(bx, degree) == (want == "pallas")
    assert tm.resolve_engine("xla") == "xla"
    if want == "pallas":
        assert tm.resolve_engine("pallas") == "pallas"
    else:
        with pytest.raises(ValueError, match="engine='pallas'"):
            tm.resolve_engine("pallas")
    with pytest.raises(ValueError, match="engine must be"):
        tm.resolve_engine("mosaic")


def test_engine_pallas_raises_past_the_limits():
    """predict_cube_u16 and the serving form raise under engine="pallas"
    for an 18-band model before anything runs (also on CPU tensors, which
    within the limits take the kernel's plain version)."""
    tm = _carry(_fit_jax(*XLA_MODELS["bx18_deg2"]))
    cube = _cube(18, 24, 32, 1)
    with pytest.raises(ValueError, match="engine='pallas'"):
        tm.predict_cube_u16(cube, nodata=NODATA, engine="pallas")
    with pytest.raises(ValueError, match="engine='pallas'"):
        tridge.sr_predict_u16(np.zeros((4, 18), np.float32),
                              np.ones(4, bool), tm, engine="pallas")


@pytest.mark.parametrize("bx,degree,f,k_cols,want", [
    (10, 3, 285, 320, ("resident", 32)), (10, 4, 1000, 1184, ("resident", 16)),
    (12, 4, 1819, 2080, ("streamed", 32)),
    (16, 4, 4844, 5376, ("streamed", 32))])
def test_sr_route(bx, degree, f, k_cols, want):
    """The kernel's route by shape: W resident in shared memory where its
    hi / lo tile fits (sr_tile_bands), streamed in 32-column slabs
    otherwise; every model within Bx <= 16 and degree <= 4 has a route
    (the largest takes 5376 K columns, 94,400 bytes)."""
    fac = host.poly_factor_indices(bx, degree, False)
    assert fac.shape[0] == f
    assert sr_predict.sr_k_columns(fac) == k_cols
    assert sr_predict.sr_route(k_cols, degree) == want
    assert sr_predict.kernel_takes(bx, degree)
    if want[0] == "resident":
        assert sr_predict.sr_tile_bands(k_cols, degree) == want[1]
    else:
        assert sr_predict.sr_tile_bands(k_cols, degree) == 0
        assert sr_predict._smem_bytes_streamed(k_cols, degree) <= 232448
    assert sr_predict.sr_route(32 * 20000, 4) == (None, 0)


def _unslab(slabs):
    """sr_w_slabs' layout undone: (jt, chunks, 2048) -> (jt, chunks, 64
    B rows, 32 K columns), element (n, k) from (n // 8) * 256 + (k // 4) *
    32 + (n % 8) * 4 + k % 4."""
    jt, nch, _ = slabs.shape
    b = slabs.view(jt, nch, 8, 8, 8, 4)       # n // 8, k // 4, n % 8, k % 4
    return b.permute(0, 1, 2, 4, 3, 5).reshape(jt, nch, 64, 32)


def _sr_chunked_tf32_u16(X, model, nodata, streamed):
    """The kernel's K loop on a (N, Bx) batch in plain torch. A: the
    monomials in the kernel's K order (sr_pair_table; a padding column is
    a product of the constant row, 1), split into TF32 hi and lo. Per
    chunk of 32 K columns, in order, three f32 accumulators take A_hi
    W_hi, A_hi W_lo and A_lo W_hi; the epilogue adds ((hi.hi + lo.hi) +
    hi.lo) + intercept. W's chunks come from the slabs the streamed
    route reads (``streamed``) or from the split the resident route makes
    of W's rows in K order."""
    valid = sr_predict.valid_pixels(X, nodata)
    feats = tlstsq.poly_expand(
        (torch.nan_to_num(X) - model.x_mean) / model.x_std,
        model.factors.to(torch.int64))
    _, src = sr_predict.sr_pair_table(model.factors.numpy())
    src = T(src)
    live = src >= 0
    k_cols, by = src.shape[0], model.n_outputs
    A = torch.ones((X.shape[0], k_cols))
    A[:, live] = feats[:, src[live].to(torch.int64)]
    a_hi = sr_predict.tf32_rna(A)
    a_lo = sr_predict.tf32_rna(A - a_hi)
    if streamed:
        rows = _unslab(sr_predict.sr_w_slabs(model.W, src))
        w_hi = rows[:, :, :32].permute(1, 3, 0, 2).reshape(k_cols, -1)[:, :by]
        w_lo = rows[:, :, 32:].permute(1, 3, 0, 2).reshape(k_cols, -1)[:, :by]
    else:
        wk = torch.zeros((k_cols, by))
        wk[live] = model.W[src[live].to(torch.int64)]
        w_hi = sr_predict.tf32_rna(wk)
        w_lo = sr_predict.tf32_rna(wk - w_hi)
    hh = torch.zeros((X.shape[0], by))
    hl = torch.zeros_like(hh)
    lh = torch.zeros_like(hh)
    for k0 in range(0, k_cols, 32):
        k1 = k0 + 32
        hh = hh + a_hi[:, k0:k1] @ w_hi[k0:k1]
        hl = hl + a_hi[:, k0:k1] @ w_lo[k0:k1]
        lh = lh + a_lo[:, k0:k1] @ w_hi[k0:k1]
    z = ((hh + lh) + hl) + model.intercept
    return tstats.quantize_reflectance_u16(tlstsq.sigmoid(z), valid[:, None])


def test_streamed_route_matches_f32_and_pallas():
    """The streamed route's arithmetic at Bx = 12, degree 4 (F = 1819,
    2080 K columns in 65 slabs), emulated on the CPU from sr_w_slabs'
    output: on a seeded 24 x 32 px cube with a NaN and nodata pixels the
    codes are <= 1 step from the f32 plain version and from the JAX
    Pallas kernel in interpret mode (row-major, tile_rows 256), with
    identical 65535 masks; through the port's engine="auto" (which is
    "pallas": on the CPU the plain version) likewise."""
    jm = _fit_jax(12, 6, 4, n=6000)
    tm = _carry(jm)
    assert sr_predict.sr_route(sr_predict.sr_k_columns(tm.factors.numpy()),
                               4) == ("streamed", 32)
    cube = _cube(12, 24, 32, 9)
    Xp = cube.reshape(12, -1).T.copy()
    got = _sr_chunked_tf32_u16(T(Xp), tm, NODATA, streamed=True)
    args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
    plain = sr_predict.sr_predict_u16_reference(T(Xp), *args,
                                                layout="rowmajor",
                                                nodata=NODATA)
    _assert_u16_close(got.numpy(), plain.numpy())
    assert int((got == 65535).sum()) == 3 * 6
    sels, _ = jlstsq.poly_selector_matrices(12, 4)
    p = jm.params
    valid = sr_predict.valid_pixels(T(Xp), NODATA).numpy()
    want = pallas_sr_predict_u16(
        jnp.asarray(np.nan_to_num(Xp)), jnp.asarray(valid), p.x_mean,
        p.x_std, tuple(jnp.asarray(s) for s in sels), p.W, p.intercept,
        tile_rows=256, interpret=True)
    _assert_u16_close(got.numpy(), want)
    auto = tm.predict_cube_u16(cube, nodata=NODATA)
    assert tm.last_engine == "pallas"
    _assert_u16_close(auto.reshape(6, -1).T.numpy(), want)


@pytest.mark.parametrize("name", list(MODELS))
def test_streamed_slabs_give_the_resident_codes(jax_models, name):
    """On a model both routes take, the chunked emulation fed from the
    streamed route's slabs gives exactly the codes of the one fed from
    the resident route's split of W (the slabs hold the same TF32 hi and
    lo values at the places the kernel reads), and both are <= 1 step
    from the f32 plain version."""
    tm = _carry(jax_models[name])
    Xp = T(_cube(tm.n_inputs, 30, 33, 5).reshape(tm.n_inputs, -1).T.copy())
    res = _sr_chunked_tf32_u16(Xp, tm, NODATA, streamed=False)
    stm = _sr_chunked_tf32_u16(Xp, tm, NODATA, streamed=True)
    np.testing.assert_array_equal(res.numpy(), stm.numpy())
    plain = sr_predict.sr_predict_u16_reference(
        Xp, tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors,
        layout="rowmajor", nodata=NODATA)
    _assert_u16_close(res.numpy(), plain.numpy())


def test_w_slabs_layout_and_cache(rng):
    """sr_w_slabs: (ceil(By / 32), K / 32, 2048) float32; undone, slab
    rows n < 32 are rna(W) of band 32 jt + n in the kernel's K order and
    rows 32 + n are rna(W - hi), zeros for padding columns and bands past
    By; hi + lo is within 2^-21 |w| of w. The wrapper's cache returns the
    same slabs for the same W and factor table and new ones after an
    in-place change."""
    fac = T(host.poly_factor_indices(10, 3, False))
    _, src = sr_predict.sr_pair_table(fac.numpy())
    src = T(src)
    W = T(rng.standard_normal((285, 40)).astype(np.float32))
    slabs = sr_predict.sr_w_slabs(W, src)
    assert slabs.shape == (2, 10, 2048) and slabs.dtype == torch.float32
    rows = _unslab(slabs)
    hi = rows[:, :, :32].permute(1, 3, 0, 2).reshape(320, 64)
    lo = rows[:, :, 32:].permute(1, 3, 0, 2).reshape(320, 64)
    live = src >= 0
    wk = torch.zeros((320, 64))
    wk[live, :40] = W[src[live].to(torch.int64)]
    torch.testing.assert_close(hi, sr_predict.tf32_rna(wk), rtol=0, atol=0)
    torch.testing.assert_close(lo, sr_predict.tf32_rna(wk - hi), rtol=0,
                               atol=0)
    assert float((hi + lo - wk).abs().max()) <= 2.0 ** -21 * float(
        wk.abs().max())
    assert not hi[~live].any() and not hi[:, 40:].any()
    a = sr_predict._device_slabs(W, fac, src)
    assert sr_predict._device_slabs(W, fac, src) is a
    W[0, 0] += 1.0
    assert sr_predict._device_slabs(W, fac, src) is not a
    key = id(W)
    del W
    assert key not in sr_predict._SLABS


def test_wrapper_rejects_bad_operands(jax_models):
    tm = _carry(jax_models["small"])
    X = torch.zeros((6, 10))
    args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
    with pytest.raises(ValueError, match="layout"):
        sr_predict.sr_predict_u16(X, *args, layout="nhwc")
    with pytest.raises(TypeError, match="float32"):
        sr_predict.sr_predict_u16(X.double(), *args)
    with pytest.raises(ValueError, match="x_mean"):
        sr_predict.sr_predict_u16(X.T.contiguous(), *args)
    with pytest.raises(ValueError, match="valid"):
        sr_predict.sr_predict_u16(X, *args, valid=torch.ones(3, dtype=bool))
    with pytest.raises(RuntimeError, match="fit"):
        tridge.RidgeSpectralSR(6, 12, device="cpu").predict(
            np.zeros((2, 6), np.float32))

"""The port's quantize and SRF-synthesis kernels' plain versions against
the JAX reference on the CPU: ``quantize_u16`` (both forms) against
``stats.quantize_u16`` and ``pallas_quantize_u16`` (interpret mode),
``pallas_srf_synthesize`` / ``srf_synthesize_auto`` against the Pallas
kernel (interpret mode) and ``srf_synthesize``, plus the OBS range
estimator and ``dequantize_u16``. Inputs are made with NumPy from a seed
and given to both. The CUDA kernels themselves run only on a card
(on the card: tests_gpu/)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres.kernels import pallas_ops as jpallas  # noqa: E402
from hyperres.kernels import srf as jsrf  # noqa: E402
from hyperres.kernels import stats as jstats  # noqa: E402
from hyperres_torch.device import launch_counts, reset_launch_counts  # noqa: E402
from hyperres_torch.kernels import quantize as tq  # noqa: E402
from hyperres_torch.kernels import srf as tsrf  # noqa: E402
from hyperres_torch.kernels import stats as tstats  # noqa: E402
from hyperres_torch.kernels.host import build_srf_weight_matrix  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402
from hyperres_torch.testing.scenes import emit_wavelength_grid  # noqa: E402

T = torch.from_numpy


def _values(rng, shape, lo=-0.3, hi=1.3):
    """Values on both sides of [0, 1], with a NaN, an inf and a -9999
    nodata value, plus exact rounding ties of the reflectance form."""
    x = (rng.random(shape) * (hi - lo) + lo).astype(np.float32)
    flat = x.reshape(-1)
    flat[3] = np.nan
    flat[11] = np.inf
    flat[17] = -9999.0
    # x = k / 65535 * 6.5535 lands near half-steps of the u16 code
    flat[20:40] = ((np.arange(20) + 0.5) * 1e-4).astype(np.float32)
    return x


@pytest.mark.parametrize("nodata", [0, 65535])
@pytest.mark.parametrize("per_band", [False, True])
def test_quantize_stats_form_matches_jax(nodata, per_band, rng):
    """quantize_u16 (stats form) == stats.quantize_u16 exactly
    (array_equal), with a validity mask, for scalar and per-band lo/hi
    and both sentinels."""
    x = _values(rng, (37, 29, 6))
    valid = np.isfinite(x) & (x != -9999.0) & (rng.random(x.shape) > 0.1)
    if per_band:
        lo = np.linspace(-0.1, 0.2, 6).astype(np.float32)
        hi = np.linspace(0.8, 1.1, 6).astype(np.float32)
        jlo, jhi, tlo, thi = jnp.asarray(lo), jnp.asarray(hi), T(lo), T(hi)
    else:
        jlo = tlo = 0.0
        jhi = thi = 6.5535
    want = np.asarray(jstats.quantize_u16(jnp.asarray(x), jlo, jhi,
                                          jnp.asarray(valid),
                                          nodata_u16=nodata))
    got = tstats.quantize_u16(T(x), tlo, thi, T(valid), nodata).numpy()
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == nodata).all()


@pytest.mark.parametrize("nodata", [0, 65535])
def test_quantize_in_kernel_validity(nodata, rng):
    """Validity tested in the kernel (isfinite and != nodata_src, the
    products' _valid_mask) == the reference given that mask: exact."""
    x = _values(rng, (50, 13))
    valid = np.isfinite(x) & (x != -9999.0)
    want = np.asarray(jstats.quantize_u16(jnp.asarray(x), 0.0, 1.0,
                                          jnp.asarray(valid),
                                          nodata_u16=nodata))
    got = tq.quantize_u16(T(x), 0.0, 1.0, None, nodata,
                          nodata_src=-9999.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nodata", [0, 65535])
@pytest.mark.parametrize("masked", [False, True])
def test_pallas_quantize_matches_pallas_kernel(nodata, masked, rng):
    """pallas_quantize_u16 (pallas form, scale rounded from double) ==
    the Pallas kernel in interpret mode, exactly. Without a mask the
    values are all finite (the reference casts NaN undefined)."""
    x = _values(rng, (300, 7))
    if masked:
        valid = np.isfinite(x) & (rng.random(x.shape) > 0.2)
    else:
        x = np.nan_to_num(x, nan=0.5, posinf=2.0)
        valid = None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    want = np.asarray(jpallas.pallas_quantize_u16(
        jnp.asarray(x), 0.0, 6.5535, jv, nodata_u16=nodata, tile_rows=128,
        interpret=True))
    got = tq.pallas_quantize_u16(T(x), 0.0, 6.5535, tv, nodata).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_forms_differ_only_at_ties(rng):
    """The two forms round (x - lo) / (hi - lo) * 65535 and
    (x - lo) * f32(65535 / (hi - lo)) differently: at most one step
    apart, and equal on most values."""
    x = rng.random((4000, 3)).astype(np.float32)
    a = tq.quantize_u16(T(x), 0.0, 1.0, None, 65535).numpy()
    b = tq.quantize_u16(T(x), 0.0, 1.0, None, 65535,
                        form="pallas").numpy()
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() > 0.9


def test_quantize_wrapper_validates():
    """Operands the kernel does not take raise; the CPU path does not
    count a launch."""
    x = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        tq.quantize_u16(x.double(), 0.0, 1.0)
    with pytest.raises(ValueError):
        tq.quantize_u16(x, torch.zeros(2), 1.0)
    with pytest.raises(ValueError):
        tq.quantize_u16(x, 0.0, 1.0, torch.ones((4,), dtype=torch.bool))
    with pytest.raises(TypeError):
        tq.pallas_quantize_u16(x, torch.zeros(3), 1.0)
    reset_launch_counts()
    tq.quantize_u16(x, 0.0, 1.0)
    assert launch_counts.get(tq.KERNEL_NAME, 0) == 0


def test_dequantize_matches_jax(rng):
    """dequantize_u16 == stats.dequantize_u16 to 1 ulp (XLA may fuse
    q * scale + offset into one FMA); the fill exactly."""
    q = rng.integers(0, 65536, (64, 5)).astype(np.uint16)
    q[0, 0] = 0
    scale = (rng.random(5) * 1e-3).astype(np.float32)
    offset = rng.random(5).astype(np.float32)
    want = np.asarray(jstats.dequantize_u16(jnp.asarray(q),
                                            jnp.asarray(scale),
                                            jnp.asarray(offset), 0, -1.0))
    got = tstats.dequantize_u16(T(q), T(scale), T(offset), 0, -1.0).numpy()
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("stride", [1, 4])
def test_strided_band_minmax_matches_jax(stride, rng):
    """The OBS (p1, p99) range estimator == stats.strided_band_minmax
    to 1 ulp of the values, a band with no valid sample NaN in both."""
    cube = (rng.random((40, 36, 5)) * 300.0).astype(np.float32)
    cube[rng.random(cube.shape) < 0.1] = -9999.0
    cube[2, 3, 1] = np.nan
    cube[..., 4] = -9999.0
    jlo, jhi = (np.asarray(v) for v in jstats.strided_band_minmax(
        jnp.asarray(cube), -9999.0, stride=stride))
    tlo, thi = (v.numpy() for v in tstats.strided_band_minmax(
        T(cube), -9999.0, stride=stride))
    for got, want in ((tlo, jlo), (thi, jhi)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[4])
        np.testing.assert_array_max_ulp(got[:4], want[:4], maxulp=1)


def _srf_case(rng, n_bands, bands=None, shape=(17, 23)):
    wl, good = emit_wavelength_grid(n_bands)
    W, _, _ = build_srf_weight_matrix(wl, builtin_srf("S2A", bands=bands),
                                      good)
    cube = rng.random(shape + (n_bands,)).astype(np.float32)
    valid = rng.random(shape) > 0.3
    return cube, W.astype(np.float32), valid


@pytest.mark.parametrize("bands", [None, ["B2", "B3", "B4"]])
def test_pallas_srf_matches_pallas_kernel(bands, rng):
    """pallas_srf_synthesize (plain version on the CPU) == the Pallas
    kernel in interpret mode and srf_synthesize_auto(use_pallas=True)
    == the reference's: atol 1e-5 on values <= ~1 (f32 sums of 285
    terms in another order); the fill exactly equal."""
    cube, W, valid = _srf_case(rng, 285, bands)
    flat, v = cube.reshape(-1, 285), valid.reshape(-1)
    want = np.asarray(jpallas.pallas_srf_synthesize(
        jnp.asarray(flat), jnp.asarray(W), jnp.asarray(v), tile_rows=128,
        interpret=True))
    got = tsrf.pallas_srf_synthesize(T(flat), T(W), T(v)).numpy()
    assert got.shape == (flat.shape[0], W.shape[1])
    np.testing.assert_array_equal(got[~v], want[~v])
    assert (got[~v] == -9999.0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_auto = np.asarray(jpallas.srf_synthesize_auto(
        jnp.asarray(cube), jnp.asarray(W), jnp.asarray(valid),
        use_pallas=True))
    got_auto = tsrf.srf_synthesize_auto(T(cube), T(W), T(valid),
                                        use_pallas=True).numpy()
    np.testing.assert_array_equal(got_auto[~valid], want_auto[~valid])
    np.testing.assert_allclose(got_auto, want_auto, rtol=0, atol=1e-5)


def test_pallas_srf_past_the_first_kernels_limits(rng):
    """B = 400 and S = 20 (past the first CUDA kernel's B <= 384 and
    S <= 16; the Pallas kernel pads any B and S to 128): the plain version
    == the Pallas kernel in interpret mode to 3e-6 relative on sums of
    400 products in [0, 1) (~100; another order of f32 sums), the fill
    exactly equal."""
    flat = rng.random((300, 400)).astype(np.float32)
    W = rng.random((400, 20)).astype(np.float32)
    v = rng.random(300) > 0.3
    want = np.asarray(jpallas.pallas_srf_synthesize(
        jnp.asarray(flat), jnp.asarray(W), jnp.asarray(v), tile_rows=128,
        interpret=True))
    got = tsrf.pallas_srf_synthesize(T(flat), T(W), T(v)).numpy()
    assert got.shape == (300, 20)
    np.testing.assert_array_equal(got[~v], want[~v])
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=0)


@pytest.mark.parametrize("b,s,want", [
    (285, 13, ("tiled", 2)), (285, 3, ("tiled", 2)),
    (285, 40, ("tiled", 1)), (401, 20, ("tiled", 1)),
    (400, 20, ("generic", 0)), (244, 13, ("warp", 0)),
    (384, 16, ("warp", 0)), (388, 16, ("generic", 0)),
    (244, 17, ("generic", 0)), (2001, 16, ("generic", 0)),
    (1, 1, ("tiled", 2))])
def test_srf_route(b, s, want):
    """The route by shape: the tiled kernel where gcd(B, 32) <= 2 and a
    ring of 2 tiles of 64 rows (else 32) fits the 232,448 bytes a block
    may use beside W and the partial sums; otherwise the warp kernel
    within its B <= 384 and S <= 16, else the generic kernel. EMIT's 285
    bands take 64-row tiles at 13 outputs (191,104 bytes). Each route
    has a launch counter of its own."""
    assert tsrf.srf_route(b, s) == want
    assert len(set(tsrf.ROUTE_NAMES.values())) == 3
    assert tsrf.ROUTE_NAMES[tsrf.TILED] == tsrf.KERNEL_NAME
    if want[0] == "tiled":
        assert tsrf._tiled_smem_bytes(b, s, *want[1:]) <= 232448
    if (b, s) == (285, 13):
        assert tsrf._tiled_smem_bytes(285, 13, 2) == 191104


def test_srf_auto_without_pallas_is_the_matmul(rng):
    """srf_synthesize_auto(use_pallas=False) == srf_synthesize of the
    reference (atol 1e-5), with and without a mask, and launches no
    kernel."""
    cube, W, valid = _srf_case(rng, 96, ["B3"], shape=(9, 11))
    reset_launch_counts()
    for m in (None, valid):
        want = np.asarray(jsrf.srf_synthesize(
            jnp.asarray(cube), jnp.asarray(W),
            None if m is None else jnp.asarray(m)))
        got = tsrf.srf_synthesize_auto(
            T(cube), T(W), None if m is None else T(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert launch_counts.get(tsrf.KERNEL_NAME, 0) == 0


def test_srf_wrapper_validates():
    """Shapes and types the kernel does not take raise."""
    x, w = torch.zeros((5, 4)), torch.zeros((4, 2))
    with pytest.raises(ValueError):
        tsrf.pallas_srf_synthesize(x, torch.zeros((3, 2)))
    with pytest.raises(TypeError):
        tsrf.pallas_srf_synthesize(x.double(), w)
    with pytest.raises(ValueError):
        tsrf.pallas_srf_synthesize(x, w, torch.ones(4, dtype=torch.bool))

"""The PyTorch port's optimal transport against the JAX reference on the
CPU: the Sinkhorn-duals kernel's plain version against
``pallas_sinkhorn_duals`` (in interpret mode), the ``engine="pallas"``
barycentric targets and the engine budget rule, the affine fit, the
host sampler and the phase-wise API of ``fusion/ot.py``. Inputs are made
with NumPy from a seed and given to both packages. The kernel itself
runs only on a CUDA device (marked ``gpu``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres.core.config import OTConfig as JOTConfig  # noqa: E402
from hyperres.fusion import ot as jot  # noqa: E402
from hyperres.fusion import sampling as jsampling  # noqa: E402
from hyperres.kernels import lstsq as jlstsq  # noqa: E402
from hyperres.kernels import sinkhorn as jsink  # noqa: E402
from hyperres.kernels.pallas_ops import pallas_sinkhorn_duals  # noqa: E402
from hyperres_torch.core.config import OTConfig  # noqa: E402
from hyperres_torch.device import launch_counts, reset_launch_counts  # noqa: E402
from hyperres_torch.fusion import ot as tot  # noqa: E402
from hyperres_torch.fusion import sampling as tsampling  # noqa: E402
from hyperres_torch.kernels import lstsq as tlstsq  # noqa: E402
from hyperres_torch.kernels import sinkhorn as tsink  # noqa: E402
from hyperres_torch.kernels import sinkhorn_duals as tduals  # noqa: E402

T = torch.from_numpy


def _cost(rng, n, m, reg=0.05):
    X = rng.normal(0.45, 0.2, (n, 3)).astype(np.float32)
    Y = rng.normal(0.55, 0.18, (m, 3)).astype(np.float32)
    M = np.asarray(jsink.sqeuclidean_cdist(jnp.asarray(X), jnp.asarray(Y)))
    return (-M / np.float32(reg)).astype(np.float32)


def _plan(Mr, f, g):
    return np.exp(Mr + np.asarray(f)[:, None] + np.asarray(g)[None, :])


@pytest.mark.parametrize("marginal", ["uniform", "weighted"])
def test_sinkhorn_duals_reference_matches_pallas(marginal, rng):
    """The plain version of the duals kernel == pallas_sinkhorn_duals in
    interpret mode at 150 x 170 (the TPU pads to 256 x 256 with -1e30
    slots), 60 sweeps at stop_thr=0: the plans P = exp(Mr + f + g) to
    atol 1e-7, the reference's own bound for its kernel against
    sinkhorn_log (tests/test_kernels_ot_lstsq.py:55); the same sweep
    count and a finite err."""
    n, m = 150, 170
    Mr = _cost(rng, n, m)
    wa = np.ones(n)
    if marginal == "weighted":  # vanishing-mass padding slots
        wa[-20:] = 1e-12
    a = (wa / wa.sum()).astype(np.float32)
    b = np.full(m, 1.0 / m, np.float32)
    f, g, err = pallas_sinkhorn_duals(jnp.log(jnp.asarray(a)),
                                      jnp.log(jnp.asarray(b)),
                                      jnp.asarray(Mr), num_itermax=60,
                                      stop_thr=0.0)
    tf, tg, terr, sweeps = tduals.sinkhorn_duals(
        torch.log(T(a)), torch.log(T(b)), T(Mr), num_itermax=60,
        stop_thr=0.0, return_sweeps=True)
    assert sweeps == 60
    assert np.isfinite(float(terr)) and np.isfinite(float(err))
    np.testing.assert_allclose(_plan(Mr, tf.numpy(), tg.numpy()),
                               _plan(Mr, f, g), rtol=0, atol=1e-7)


def test_sinkhorn_duals_stops_on_row_marginal(rng):
    """With a loose stop_thr both stop with the row-marginal err at most
    stop_thr (the reference's early-stop case,
    tests/test_kernels_ot_lstsq.py:91), after a whole number of
    check_every groups; the rows of P then sum to a within 1e-5 and the
    two plans agree to 1e-7."""
    n = 96
    X = rng.normal(0.5, 0.1, (n, 3)).astype(np.float32)
    M = np.asarray(jsink.sqeuclidean_cdist(jnp.asarray(X),
                                           jnp.asarray(X + 0.05)))
    Mr = (-M / np.float32(0.5)).astype(np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    f, g, err = pallas_sinkhorn_duals(jnp.log(jnp.asarray(a)),
                                      jnp.log(jnp.asarray(a)),
                                      jnp.asarray(Mr), num_itermax=5000,
                                      stop_thr=1e-4)
    tf, tg, terr, sweeps = tduals.sinkhorn_duals_reference(
        torch.log(T(a)), torch.log(T(a)), T(Mr), num_itermax=5000,
        stop_thr=1e-4, return_sweeps=True)
    assert float(terr) <= 1e-4 and float(err) <= 1e-4
    assert sweeps % 10 == 0 and 0 < sweeps < 5000
    P = _plan(Mr, tf.numpy(), tg.numpy())
    np.testing.assert_allclose(P.sum(1), a, atol=1e-5)
    np.testing.assert_allclose(P, _plan(Mr, f, g), rtol=0, atol=1e-7)


def test_sinkhorn_duals_checks_operands():
    with pytest.raises(ValueError):
        tduals.sinkhorn_duals(torch.zeros(3), torch.zeros(4),
                              torch.zeros((4, 3)))
    with pytest.raises(TypeError):
        tduals.sinkhorn_duals(torch.zeros(3), torch.zeros(4),
                              torch.zeros((3, 4), dtype=torch.float64))
    f, g, err = tduals.sinkhorn_duals(torch.zeros(3), torch.zeros(4),
                                      torch.zeros((3, 4)), num_itermax=0)
    assert float(err) == float("inf") and not f.any() and not g.any()


def _samples(rng, n=400):
    X = rng.random((n, 3)).astype(np.float32)
    Y = (rng.random((n, 3)) ** 1.3).astype(np.float32)
    wx = (np.arange(n) < n - 30).astype(np.float32)
    wy = (np.arange(n) < n - 10).astype(np.float32)
    X[n - 20] = np.nan      # a NaN padding row (weight 0)
    return X, Y, wx, wy


def test_ot_pallas_engine_matches_jax(rng):
    """engine="pallas" in both packages, 400 samples with NaN padding
    rows and slot weights, 120 sweeps at most: targets to 5e-6, as the
    "xla" engine's parity (test_torch_fusion.py). The reference is
    called with its default stop_thr: passing it explicitly makes it a
    traced value that the Pallas kernel captures, which this JAX
    version rejects."""
    X, Y, wx, wy = _samples(rng)
    want = np.asarray(jsink.ot_barycentric_targets(
        jnp.asarray(X), jnp.asarray(Y), 0.05, 120, wx=jnp.asarray(wx),
        wy=jnp.asarray(wy), engine="pallas"))
    got = tsink.ot_barycentric_targets(T(X), T(Y), 0.05, 120, 1e-6, T(wx),
                                       T(wy), engine="pallas").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_ot_engines_agree(rng):
    """The port's two engines on the same samples. At an equal sweep
    count (stop_thr=0) they run the same update sequence: targets within
    2e-6 (f32 rounding of two summation orders; measured 3e-7). With
    the default stop rule, on the reference's own engine-parity data
    (tests/test_kernels_ot_lstsq.py:112, where both rules stop at the
    first check): within 5e-5, the reference's bound."""
    X, Y, wx, wy = _samples(rng, 300)
    kw = dict(reg=0.05, wx=T(wx), wy=T(wy), num_itermax=60, stop_thr=0.0)
    t_x = tsink.ot_barycentric_targets(T(X), T(Y), engine="xla", **kw)
    t_p = tsink.ot_barycentric_targets(T(X), T(Y), engine="pallas", **kw)
    t_a = tsink.ot_barycentric_targets(T(X), T(Y), **kw)
    assert torch.equal(t_a, t_x)
    np.testing.assert_allclose(t_p.numpy(), t_x.numpy(), rtol=0, atol=2e-6)
    X = rng.normal(0.4, 0.15, (180, 3)).astype(np.float32)
    Y = rng.normal(0.5, 0.12, (180, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsink.ot_barycentric_targets(T(X), T(Y), engine="pallas").numpy(),
        tsink.ot_barycentric_targets(T(X), T(Y), engine="xla").numpy(),
        rtol=0, atol=5e-5)
    with pytest.raises(ValueError, match="engine"):
        tsink.ot_barycentric_targets(T(X), T(Y), engine="triton")


def test_engine_stopping_rules_differ(rng):
    """A reference behaviour the port keeps: ``sinkhorn_log`` checks the
    column marginal right after the g update, which makes it exact up to
    rounding, so on uniform samples it stops at the first check (10
    iterations) with the row marginal still off by more than 1e-2; the
    duals rule (row marginal of the previous iterate) runs on until the
    plan converges. The two engines' targets then differ by ~2e-2, in
    both packages alike."""
    X = rng.random((400, 3)).astype(np.float32)
    Y = (rng.random((400, 3)) ** 1.3).astype(np.float32)
    a = torch.full((400,), 1.0 / 400)
    M = tsink.sqeuclidean_cdist(T(X), T(Y))
    P, err = tsink.sinkhorn_log(a, a, M, 0.05)
    P10, _ = tsink.sinkhorn_log(a, a, M, 0.05, num_itermax=10)
    assert float(err) <= 1e-6 and torch.equal(P, P10)
    assert float((P.sum(1) - a).abs().sum()) > 1e-2
    _, _, derr, sweeps = tduals.sinkhorn_duals(
        torch.log(a), torch.log(a), -M / 0.05, return_sweeps=True)
    assert 10 < sweeps < 300 and float(derr) <= 1e-6
    diff = (tsink.ot_barycentric_targets(T(X), T(Y), engine="pallas")
            - tsink.ot_barycentric_targets(T(X), T(Y), engine="xla"))
    jdiff = (np.asarray(jsink.ot_barycentric_targets(
        jnp.asarray(X), jnp.asarray(Y), engine="pallas"))
        - np.asarray(jsink.ot_barycentric_targets(
            jnp.asarray(X), jnp.asarray(Y), engine="xla")))
    assert float(diff.abs().max()) > 1e-2 and np.abs(jdiff).max() > 1e-2


def test_ot_engine_budget_rule(rng, monkeypatch):
    """engine="pallas" takes the duals kernel only where round_up(n, 128)
    * round_up(m, 128) * 4 bytes fit the budget (the reference's rule,
    by shape alone): with the budget cut to one 256 x 128 tile, a
    200 x 100 problem (256 x 128 padded) takes the kernel and a 200 x 130
    one (256 x 256) gives the "xla" result bit for bit, without calling
    the kernel; the launch counter stays 0 on the CPU either way."""
    calls = []
    real = tduals.sinkhorn_duals

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tduals, "sinkhorn_duals", spy)
    monkeypatch.setattr(tduals, "PALLAS_SINKHORN_VMEM_BUDGET", 256 * 128 * 4)
    X = rng.random((200, 3)).astype(np.float32)
    Y = rng.random((130, 3)).astype(np.float32)
    reset_launch_counts()
    small = tsink.ot_barycentric_targets(T(X), T(Y[:100]), engine="pallas")
    assert calls == [(200, 100)]
    big = tsink.ot_barycentric_targets(T(X), T(Y), engine="pallas")
    assert calls == [(200, 100)]
    assert torch.equal(big, tsink.ot_barycentric_targets(T(X), T(Y),
                                                         engine="xla"))
    assert not torch.equal(small, tsink.ot_barycentric_targets(
        T(X), T(Y[:100]), engine="xla"))
    assert launch_counts.get(tduals.KERNEL_NAME, 0) == 0


#: an H100's SMs and the shared memory a block may use
H100 = (132, 232448)


@pytest.mark.parametrize("n,m", [
    (5000, 5000),                                   # the plan's OT stage
    (OTConfig().n_samples, OTConfig().n_samples),
    (400, 400), (150, 170), (96, 96), (1, 1),       # the tests' shapes
    (5000, tduals.ONE_PASS_COLS),                   # the limit
])
def test_sinkhorn_route_one_pass(n, m):
    """Up to ONE_PASS_COLS (6144) columns the one-pass route takes the
    shape on an H100: min(n, 132) blocks of ceil(n / blocks) rows, none
    empty, 2 rows per group (a ring of 4 groups of 2 rows fits in shared
    memory up to m ~7.2k)."""
    route = tduals.sinkhorn_route(n, m, *H100)
    assert route.name == tduals.ONE_PASS
    assert route.blocks <= min(n, 132)
    assert route.blocks * route.rows_per_block >= n
    assert (route.blocks - 1) * route.rows_per_block < n
    assert route.group_rows == 2
    if (n, m) == (5000, 5000):
        assert route[1:] == (132, 38, 2)


@pytest.mark.parametrize("n,m", [
    (128, 200_000),     # the longest rows the engine budget admits at n <= 128
    (128, 100_000),     # chip_smoke.py's long-rows check
    (5000, tduals.ONE_PASS_COLS + 1),
    (1, 6145),
])
def test_sinkhorn_route_long_rows(n, m):
    """Past ONE_PASS_COLS columns the two-read kernels take the shape;
    the engine budget admits such rows (round_up(n, 128) * round_up(m,
    128) * 4 <= PALLAS_SINKHORN_VMEM_BUDGET for the first three)."""
    assert tduals.sinkhorn_route(n, m, *H100) == (tduals.LONG_ROWS, 0, 0, 0)
    if n == 128:
        assert (128 * -(-m // 128) * 128 * 4
                <= tduals.PALLAS_SINKHORN_VMEM_BUDGET)


def test_sinkhorn_route_shared_memory_limit():
    """On a card with less shared memory the ring must hold a group of at
    least one row: at 48 KB a block takes m <= 3049 in one pass, with
    one row per group past m = 1524, and long rows beyond; with fewer
    SMs, fewer blocks of more rows."""
    small = 48 * 1024
    assert tduals.sinkhorn_route(5000, 3049, 132, small).name == \
        tduals.ONE_PASS
    assert tduals.sinkhorn_route(5000, 3050, 132, small).name == \
        tduals.LONG_ROWS
    assert tduals.sinkhorn_route(5000, 1524, 132, small).group_rows == 2
    assert tduals.sinkhorn_route(5000, 1525, 132, small).group_rows == 1
    assert tduals.sinkhorn_route(5000, 5000, 114, H100[1])[1:] == (
        114, 44, 2)


def test_affine_fit_matches_jax(rng):
    """Unweighted (lstsq.py:99) and 0/1-weighted (fused.py:113) affine
    fits, both SVD least squares in f32: A and t to 2e-5 (well
    conditioned 3 + 1 columns, 2000 rows). With every weight 0 the
    system is all zeros and the solution is exactly 0, finite."""
    X = rng.random((2000, 3)).astype(np.float32)
    A0 = np.array([[0.9, 0.1, 0.0], [0.05, 1.1, -0.1], [0.0, 0.2, 0.8]],
                  np.float32)
    Y = (X @ A0 + 0.03 + 0.01 * rng.standard_normal((2000, 3))).astype(
        np.float32)
    A, t = tlstsq.affine_fit(T(X), T(Y))
    jA, jt = jlstsq.affine_fit(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=2e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=2e-5)
    w = (rng.random(2000) > 0.3).astype(np.float32)
    from hyperres.fusion.fused import _affine_fit_weighted
    A, t = tlstsq.affine_fit(T(X), T(Y), T(w))
    jA, jt = _affine_fit_weighted(jnp.asarray(X), jnp.asarray(Y),
                                  jnp.asarray(w))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=2e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=2e-5)
    A, t = tlstsq.affine_fit(T(X), T(Y), torch.zeros(2000))
    assert not A.any() and not t.any()


def test_host_sampler_copy(rng):
    img = rng.random((30, 40, 3))
    img[rng.random((30, 40)) < 0.1, 2] = np.nan
    mask = rng.random((30, 40)) > 0.4
    for n in (50, 5000):
        np.testing.assert_array_equal(
            tsampling.sample_valid_pixels_host(img, mask, n, seed=7),
            jsampling.sample_valid_pixels_host(img, mask, n, seed=7))
    assert tsampling.sample_valid_pixels_host(
        img, np.zeros((30, 40), bool), 10).shape == (0, 3)


def _rgb_pair(rng, h=40, w=50):
    src = rng.random((h, w, 3)).astype(np.float32)
    ref = np.clip(0.1 + 0.8 * src[..., ::-1] ** 1.2
                  + 0.02 * rng.standard_normal((h, w, 3)), 0, 1).astype(
        np.float32)
    src[rng.random((h, w)) < 0.05] = np.nan
    mask = rng.random((h, w)) > 0.2
    return src, ref, mask


CFG = OTConfig(n_samples=600, num_itermax=120, seed=3)
JCFG = JOTConfig(n_samples=600, num_itermax=120, seed=3)


def test_fit_ot_affine_matches_jax(rng):
    """The same host samples (NumPy's generator, one seed) in both
    packages, then Sinkhorn, targets and the affine fit in f32: A and t
    to 2e-5 (the targets agree to ~5e-6)."""
    src, ref, mask = _rgb_pair(rng)
    A, t = tot.fit_ot_affine(src, ref, mask, CFG, device="cpu")
    jA, jt = jot.fit_ot_affine(src, ref, mask, JCFG)
    assert A.dtype == np.float64 and A.shape == (3, 3) and t.shape == (3,)
    np.testing.assert_allclose(A, jA, rtol=0, atol=2e-5)
    np.testing.assert_allclose(t, jt, rtol=0, atol=2e-5)
    # identity under 2 valid pixels
    one = np.zeros(mask.shape, bool)
    one[3, 4] = True
    A, t = tot.fit_ot_affine(src, ref, one, CFG, device="cpu")
    np.testing.assert_array_equal(A, np.eye(3))
    np.testing.assert_array_equal(t, np.zeros(3))


def test_ot_match_rgb_sinkhorn_matches_jax(rng):
    """The full colour transfer: masked pixels mapped and clipped, the
    others kept bit for bit; values to 5e-5 (the fitted map's 2e-5 on
    inputs <= 1). Fewer than 2 valid pixels: an unchanged copy."""
    src, ref, mask = _rgb_pair(rng)
    kw = dict(n_samples=600, num_itermax=120, seed=3)
    got = tot.ot_match_rgb_sinkhorn(src, ref, mask, device="cpu", **kw)
    want = jot.ot_match_rgb_sinkhorn(src, ref, mask, **kw)
    np.testing.assert_array_equal(got[~mask], src[~mask])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    none = np.zeros(mask.shape, bool)
    np.testing.assert_array_equal(
        tot.ot_match_rgb_sinkhorn(src, ref, none, device="cpu", **kw), src)


def test_fit_and_apply_ot_poly_match_jax(rng):
    """Degree-2 per-channel fits on the same samples: the fitted curves
    within 2e-5 over [0, 1]; apply_poly with and without a mask to 1e-6
    (f32 Horner, another summation order); the identity fallback under
    min_pixels."""
    src, ref, mask = _rgb_pair(rng)
    got = tot.fit_ot_poly(src, ref, mask, deg=2, cfg=CFG, device="cpu")
    want = jot.fit_ot_poly(src, ref, mask, deg=2, cfg=JCFG)
    assert got.shape == (3, 3) and got.dtype == np.float64
    xx = np.linspace(0.0, 1.0, 101)
    for c in range(3):
        assert np.abs(np.polyval(got[c], xx)
                      - np.polyval(want[c], xx)).max() < 2e-5
    for m in (None, mask):
        np.testing.assert_allclose(tot.apply_poly(src, got, m, device="cpu"),
                                   jot.apply_poly(src, got, m),
                                   rtol=0, atol=1e-6)
    ident = tot.fit_ot_poly(src, ref, mask, deg=2, cfg=CFG,
                            min_pixels=10 ** 6, device="cpu")
    np.testing.assert_array_equal(ident, [[0, 1, 0]] * 3)


def test_apply_affine_copy(rng):
    src, _, mask = _rgb_pair(rng)
    A = rng.random((3, 3))
    t = rng.random(3) - 0.5
    for m in (None, mask):
        np.testing.assert_array_equal(tot.apply_affine(src, A, t, m),
                                      jot.apply_affine(src, A, t, m))


def test_long_rows_reference_matches_pallas(rng):
    """The plain version == pallas_sinkhorn_duals in interpret mode on a
    long-rows shape (8 x 6400: m past the one-pass kernel's 6144
    columns), 30 sweeps at stop_thr=0: the plans P = exp(Mr + f + g) to
    atol 1e-7 (the bound of the 150 x 170 test; P's entries are <=
    1 / 6400), the same sweep count, a finite err."""
    n, m = 8, 6400
    assert tduals.sinkhorn_route(n, m, *H100).name == tduals.LONG_ROWS
    Mr = _cost(rng, n, m)
    a = np.full(n, 1.0 / n, np.float32)
    b = np.full(m, 1.0 / m, np.float32)
    f, g, err = pallas_sinkhorn_duals(jnp.log(jnp.asarray(a)),
                                      jnp.log(jnp.asarray(b)),
                                      jnp.asarray(Mr), num_itermax=30,
                                      stop_thr=0.0)
    tf, tg, terr, sweeps = tduals.sinkhorn_duals(
        torch.log(T(a)), torch.log(T(b)), T(Mr), num_itermax=30,
        stop_thr=0.0, return_sweeps=True)
    assert sweeps == 30
    assert np.isfinite(float(terr)) and np.isfinite(float(err))
    np.testing.assert_allclose(_plan(Mr, tf.numpy(), tg.numpy()),
                               _plan(Mr, f, g), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,m,width", [(5, 9000, 4096), (3, 6145, 512),
                                       (16, 20000, 4096)])
def test_slice_merge_matches_logsumexp(n, m, width, rng):
    """The long-rows route's arithmetic on the CPU: each row of z = Mr + g
    cut into slices of ``width`` columns (the last one ragged), per slice
    (max, sum of exp(z - max)), merged by merge_slices: max + log(sum) ==
    torch.logsumexp of the whole row to 1e-6 relative, the max exactly."""
    z = T(_cost(rng, n, m)) + T(rng.normal(0, 3, m).astype(np.float32))
    n_slices = -(-m // width)
    pmax = torch.empty((n, n_slices))
    psum = torch.empty((n, n_slices))
    for c in range(n_slices):
        part = z[:, c * width:(c + 1) * width]
        pmax[:, c] = part.amax(dim=1)
        psum[:, c] = torch.exp(part - pmax[:, c:c + 1]).sum(dim=1)
    mx, total = tduals.merge_slices(pmax, psum)
    assert torch.equal(mx, z.amax(dim=1))
    torch.testing.assert_close(mx + torch.log(total),
                               torch.logsumexp(z, dim=1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,m,want", [
    (128, 100_000, (25, 8, 1)), (1024, 20_000, (5, 13, 4)),
    (8, 6400, (2, 1, 8)), (1, 200_000, (49, 1, 1)),
    (4266, 6145, (2, 22, 11))])
def test_long_rows_plan(n, m, want):
    """The long-rows route's grids on an H100 (132 SMs): slices of 4096
    columns; slice-kernel blocks of at most 64 rows, ~3 blocks per SM and
    none empty; the column kernel's rows in one chunk where ceil(m / 128)
    column blocks give 4 per SM, else in equal chunks, none empty."""
    plan = tduals.long_rows_plan(n, m, 132)
    assert tuple(plan) == want
    assert plan.n_slices == -(-m // 4096)
    assert 1 <= plan.rows_per_block <= 64
    groups = -(-n // plan.rows_per_block)
    assert (groups - 1) * plan.rows_per_block < n
    rows = -(-n // plan.chunks)
    assert (plan.chunks - 1) * rows < n <= plan.chunks * rows


def test_two_read_route_is_never_chosen():
    """The earlier two-read kernels stay as a route of their own name,
    which the rule does not return: every shape is one pass or long
    rows."""
    names = {tduals.sinkhorn_route(n, m, *H100).name
             for n in (1, 128, 5000) for m in (1, 6144, 6145, 200_000)}
    assert names == {tduals.ONE_PASS, tduals.LONG_ROWS}
    assert tduals.TWO_READ not in names


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Sinkhorn kernel has no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sinkhorn_duals_kernel_matches_plain_on_gpu(cuda_device, rng):
    """The CUDA kernel == its plain version on the card at 1000 x 1200,
    60 sweeps: P to 1e-5 of its largest entry and f, g to 1e-4 (both sum
    f32 exps in their own fixed orders), err to 10 % plus 1e-8 (near
    convergence err is rounding noise); two kernel runs give the same
    bits; each group of 10 sweeps counts one launch."""
    Mr = T(_cost(rng, 1000, 1200)).to(cuda_device)
    la = torch.full((1000,), -np.log(1000.0), device=cuda_device)
    lb = torch.full((1200,), -np.log(1200.0), device=cuda_device)
    reset_launch_counts()
    f, g, err = tduals.sinkhorn_duals(la, lb, Mr, 60, 0.0)
    f2, g2, _ = tduals.sinkhorn_duals(la, lb, Mr, 60, 0.0)
    assert launch_counts == {tduals.KERNEL_NAME: 12}
    assert torch.equal(f, f2) and torch.equal(g, g2)
    rf, rg, rerr = tduals.sinkhorn_duals_reference(la, lb, Mr, 60, 0.0)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    dP = (P - torch.exp(Mr + rf[:, None] + rg[None, :])).abs().max()
    assert float(dP) <= 1e-5 * float(P.max())
    torch.testing.assert_close(f, rf, rtol=0, atol=1e-4)
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-4)
    assert (abs(float(err) - float(rerr))
            <= 0.1 * max(float(err), float(rerr)) + 1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(64, 7001), (37, 6145)])
def test_sinkhorn_long_rows_kernel_matches_plain_on_gpu(cuda_device, rng,
                                                        n, m):
    """The long-rows route (m > ONE_PASS_COLS; m odd, so rows are not
    16-byte aligned) against the plain version at 60 sweeps, with the
    bounds of the one-pass test; two runs give the same bits; each group
    of 10 sweeps counts one launch of the long-rows counter alone."""
    Mr = T(_cost(rng, n, m)).to(cuda_device)
    la = torch.full((n,), -np.log(float(n)), device=cuda_device)
    lb = torch.full((m,), -np.log(float(m)), device=cuda_device)
    reset_launch_counts()
    f, g, err = tduals.sinkhorn_duals(la, lb, Mr, 60, 0.0)
    f2, g2, _ = tduals.sinkhorn_duals(la, lb, Mr, 60, 0.0)
    assert launch_counts == {tduals.LONG_ROWS_NAME: 12}
    assert torch.equal(f, f2) and torch.equal(g, g2)
    rf, rg, rerr = tduals.sinkhorn_duals_reference(la, lb, Mr, 60, 0.0)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    dP = (P - torch.exp(Mr + rf[:, None] + rg[None, :])).abs().max()
    assert float(dP) <= 1e-5 * float(P.max())
    torch.testing.assert_close(f, rf, rtol=0, atol=1e-4)
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-4)
    assert (abs(float(err) - float(rerr))
            <= 0.1 * max(float(err), float(rerr)) + 1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(128, 100_000), (1024, 20_000), (8, 6400)])
def test_sliced_long_rows_on_gpu(cuda_device, rng, n, m):
    """The sliced long-rows kernels at the shapes chip_smoke.py times (m a
    multiple of 4: the 16-byte loads; one chunk, four chunks, eight)
    against the plain version at 50 sweeps with the bounds of the one-pass
    test; two runs bit-equal; the two-read kernels, forced, agree with
    the plain version too and count under their own name."""
    Mr = T(_cost(rng, n, m)).to(cuda_device)
    la = torch.full((n,), -np.log(float(n)), device=cuda_device)
    lb = torch.full((m,), -np.log(float(m)), device=cuda_device)
    rf, rg, _ = tduals.sinkhorn_duals_reference(la, lb, Mr, 50, 0.0)
    Pr = torch.exp(Mr + rf[:, None] + rg[None, :])
    reset_launch_counts()
    f, g, _ = tduals.sinkhorn_duals(la, lb, Mr, 50, 0.0)
    f2, g2, _ = tduals.sinkhorn_duals(la, lb, Mr, 50, 0.0)
    assert launch_counts == {tduals.LONG_ROWS_NAME: 10}
    assert torch.equal(f, f2) and torch.equal(g, g2)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    assert float((P - Pr).abs().max()) <= 1e-5 * float(Pr.max())
    rule = tduals.sinkhorn_route
    tduals.sinkhorn_route = lambda *shape: tduals.Route(tduals.TWO_READ)
    try:
        reset_launch_counts()
        f, g, _ = tduals.sinkhorn_duals(la, lb, Mr, 50, 0.0)
    finally:
        tduals.sinkhorn_route = rule
    assert launch_counts == {tduals.TWO_READ_NAME: 5}
    P = torch.exp(Mr + f[:, None] + g[None, :])
    assert float((P - Pr).abs().max()) <= 1e-5 * float(Pr.max())

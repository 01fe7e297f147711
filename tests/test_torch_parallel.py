"""The port's multi-device layer (``hyperres_torch.parallel``) on a mesh of
CPU devices, against the JAX package's ops on the 8-device CPU mesh
(``eight_devices``) and against the port's single-device functions, on
the same NumPy inputs from a seed; also the single-device estimators the
ops are built on (``histogram_percentile``, ``bracket_percentile``, the
``"bracket"`` stretch, ``ridge_fit_centered``) and the mesh's
collectives against NumPy.

Tolerances (each test states its own): the JAX tests' bounds for the
port against JAX (``tests/test_tiling_parallel.py``): the percentile
within 2 * range / 2048 of NumPy, the two-pass warps 5e-4 abs with the
99th percentile under 1e-5 (the port is exact f32, the reference runs
``precision="high"``), the SR codes <= 1 step with the same 65535 mask
(the ridge contraction sums in another order). Against the port's own
single-device functions the sharded ops are exact where the shards do
the same arithmetic: the two-pass warps, the tap-loop warp, the SR codes
and the histogram percentile bit for bit, the data-parallel fit's W
within 1e-6.
"""

import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import hyperres.parallel as jpar  # noqa: E402
from hyperres.core.config import RidgeSRConfig as JRidgeSRConfig  # noqa: E402
from hyperres.fusion import ridge_sr as jridge  # noqa: E402
from hyperres.kernels import lstsq as jlstsq  # noqa: E402
from hyperres.kernels import stats as jstats  # noqa: E402
from hyperres.kernels.glt import prepare_glt  # noqa: E402
from hyperres.kernels.warp import scanline_cstar  # noqa: E402
from hyperres.parallel.ops import sharded_sr_predict_u16 as j_sr  # noqa: E402
from hyperres_torch import parallel as tpar  # noqa: E402
from hyperres_torch.core.config import RidgeSRConfig  # noqa: E402
from hyperres_torch.device import launch_counts, reset_launch_counts  # noqa: E402
from hyperres_torch.fusion import ridge_sr as tridge  # noqa: E402
from hyperres_torch.io.ingest import stream_cube_to_device  # noqa: E402
from hyperres_torch.kernels import lstsq as tlstsq  # noqa: E402
from hyperres_torch.kernels import stats as tstats  # noqa: E402
from hyperres_torch.kernels.warp import (  # noqa: E402
    orthowarp_taploop, orthowarp_two_pass,
)
from hyperres_torch.parallel import mesh as tmesh  # noqa: E402
from hyperres_torch.parallel.ops import (  # noqa: E402
    min_two_pass_halo, sharded_sr_predict_u16,
)

T = torch.from_numpy
CPU = torch.device("cpu")


def cpu_mesh(shape=(8,), names=("data",)):
    return tpar.make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def warp_case(rng, n_bands=6):
    """tests/test_tiling_parallel.py's two-pass case: a (40, 44) raw cube,
    a 64 x 48 GLT grid with 20 % holes, a sheared monotone rows field."""
    raw = rng.random((40, 44, n_bands)).astype(np.float32)
    ho, wo, hd, wd = 64, 48, 64, 50
    glt = np.zeros((ho, wo, 2), dtype=np.int32)
    valid = rng.random((ho, wo)) > 0.2
    glt[..., 0] = np.where(valid, rng.integers(1, 45, (ho, wo)), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, 41, (ho, wo)), 0)
    flat_idx, vmask = prepare_glt(glt, (40, 44))
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.003 * j * r / hd + 0.2).astype(np.float32)
    cols = (j * (wo / wd) + 0.002 * r - 0.1).astype(np.float32)
    return raw, flat_idx, vmask, rows, cols, scanline_cstar(rows, cols, ho)


def single_two_pass(raw, flat_idx, vmask, rows, cols, cstar):
    return orthowarp_two_pass(T(np.asarray(raw)), T(flat_idx), T(vmask),
                              T(rows), T(cols), T(cstar))


# ---------------------------------------------------------------- mesh ---

def test_make_mesh_and_shard_batch():
    """A mesh of repeated devices, its axis shape, 2-D axis devices; a
    shard of a tensor already on its device is a view, a replicated
    tensor one object per device (no copy)."""
    mesh = cpu_mesh()
    assert mesh.shape == {"data": 8} and mesh.devices.size == 8
    x = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    parts = tpar.shard_batch(x, mesh)
    assert len(parts) == 8 and all(p.shape == (2, 4) for p in parts)
    assert parts[3].data_ptr() == x[6:8].data_ptr()
    reps = tmesh.replicate(x, mesh.axis_devices("data"))
    assert all(r is x for r in reps)
    m2 = cpu_mesh((4, 2), ("row", "band"))
    assert m2.shape == {"row": 4, "band": 2}
    assert len(m2.axis_devices("row", band=1)) == 4
    assert len(m2.axis_devices("band", row=3)) == 2
    with pytest.raises(ValueError, match="does not divide"):
        tpar.shard_batch(torch.zeros(9, 2), mesh)
    with pytest.raises(ValueError, match="needs 8 devices"):
        tpar.make_mesh((8,), devices=["cpu"] * 4)


def test_collectives_match_numpy(rng):
    """psum / pmin / pmax / all_gather / ppermute over 4 shards against
    NumPy (psum to f32 rounding of a 4-term sum, the rest exactly);
    ppermute leaves zeros where no pair sends."""
    devs = [CPU] * 4
    a = rng.normal(size=(4, 5, 3)).astype(np.float32)
    parts = [T(a[i]) for i in range(4)]
    np.testing.assert_allclose(tmesh.psum(parts, devs)[2].numpy(),
                               a.sum(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tmesh.pmin(parts, devs)[1].numpy(),
                                  a.min(0))
    np.testing.assert_array_equal(tmesh.pmax(parts, devs)[0].numpy(),
                                  a.max(0))
    np.testing.assert_array_equal(tmesh.all_gather(parts, devs)[3].numpy(),
                                  a.reshape(20, 3))
    got = tmesh.ppermute(parts, [(0, 1), (1, 2), (2, 3)], devs)
    np.testing.assert_array_equal(got[0].numpy(), np.zeros((5, 3)))
    for i in range(1, 4):
        np.testing.assert_array_equal(got[i].numpy(), a[i - 1])
    cyc = tmesh.ppermute(parts, [(j, (j - 1) % 4) for j in range(4)], devs)
    np.testing.assert_array_equal(cyc[3].numpy(), a[0])


# ------------------------------------------------ single-device estimators ---

@pytest.mark.parametrize("masked", [False, True])
def test_histogram_percentile_matches_jax(rng, masked):
    """histogram_percentile against the JAX one (2048 bins, 2 rounds) and
    NumPy: within 2 * range / 2048 of np.percentile, and within one
    final bin (range / 2048**2) of JAX (the port counts in integers, the
    reference in f32: both exact at this size, so the brackets match)."""
    x = rng.normal(size=(200, 150)).astype(np.float32)
    mask = rng.random(x.shape) > (0.3 if masked else -1.0)
    qs = [2.0, 25.0, 50.0, 98.0]
    got = tstats.histogram_percentile(T(x), T(mask), qs).numpy()
    want = np.asarray(jstats.histogram_percentile(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(qs)))
    span = x[mask].max() - x[mask].min()
    assert np.all(np.abs(got - np.percentile(x[mask], qs)) < 2 * span / 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=span / 2048 ** 2)


def test_bracket_percentile_matches_jax(rng):
    """bracket_percentile (128 edges, 3 rounds) on the JAX test's 200k
    samples: the port and JAX each within the reference's bound of
    np.percentile (2 order-statistic gaps + 1e-6: the bracket converges
    onto the rank q / 100 * n, np.percentile interpolates at
    q / 100 * (n - 1)), and on u16-quantized, tied data onto the tied
    value (1e-4); NaN for an empty mask; the ``"bracket"`` stretch
    against JAX's to 1e-5."""
    x = rng.normal(size=(200_000,)).astype(np.float32)
    mask = rng.random((200_000,)) > 0.2
    qs = [2.0, 50.0, 98.0]
    got = tstats.bracket_percentile(T(x), T(mask), qs).numpy()
    want = np.asarray(jstats.bracket_percentile(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(qs)))
    v = np.sort(x[mask])
    for q, g, j, p in zip(qs, got, want, np.percentile(x[mask], qs)):
        i = int(q / 100 * (v.size - 1))
        gap = np.diff(v[max(i - 3, 0): i + 3]).max()
        assert abs(g - p) <= 2.0 * gap + 1e-6, (q, g, p, gap)
        assert abs(j - p) <= 2.0 * gap + 1e-6, (q, j, p, gap)
    xq = (np.round(x * 50.0) / 50.0).astype(np.float32)
    np.testing.assert_allclose(
        tstats.bracket_percentile(T(xq), T(mask), qs).numpy(),
        np.percentile(xq[mask], qs), rtol=0, atol=1e-4)
    empty = tstats.bracket_percentile(T(x), T(np.zeros_like(mask)), qs)
    assert torch.isnan(empty).all()
    img = rng.random((40, 30, 3)).astype(np.float32)
    m2 = rng.random((40, 30)) > 0.25
    st = tstats.shared_percentile_stretch(T(img), T(m2), 2.0, 98.0,
                                          method="bracket").numpy()
    jst = np.asarray(jstats.shared_percentile_stretch(
        jnp.asarray(img), jnp.asarray(m2), 2.0, 98.0, method="bracket"))
    np.testing.assert_allclose(st, jst, rtol=0, atol=1e-5)
    # "sort" is the exact route, as "bitsearch"
    np.testing.assert_array_equal(
        tstats.shared_percentile_stretch(T(img), T(m2), method="sort"),
        tstats.shared_percentile_stretch(T(img), T(m2)))
    with pytest.raises(ValueError, match="method"):
        tstats.shared_percentile_stretch(T(img), T(m2), method="median")


@pytest.mark.parametrize("weighted", [False, True])
def test_ridge_fit_centered_matches_jax(rng, weighted):
    """ridge_fit_centered against JAX's (both f32 normal equations) on a
    well-conditioned 500 x 6 system: W, intercept and means to 1e-5."""
    F = rng.normal(size=(500, 6)).astype(np.float32)
    Y = (F @ rng.normal(size=(6, 3)) + 0.1 * rng.normal(size=(500, 3))
         ).astype(np.float32)
    w = rng.random(500).astype(np.float32) if weighted else None
    got = tlstsq.ridge_fit_centered(T(F), T(Y), 1.0,
                                    None if w is None else T(w))
    want = jlstsq.ridge_fit_centered(jnp.asarray(F), jnp.asarray(Y), 1.0,
                                     None if w is None else jnp.asarray(w))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------------- the ops ---

def test_sharded_histogram_percentile(eight_devices, rng):
    """The JAX test's case on 8 CPU shards: within 2 * range / 2048 of
    np.percentile, equal to the port's single-device histogram_percentile
    and within one final bin of the JAX op."""
    x = rng.normal(size=(8 * 5000,)).astype(np.float32)
    mask = rng.random(8 * 5000) > 0.25
    qs = [2.0, 50.0, 98.0]
    got = tpar.sharded_histogram_percentile(T(x), T(mask), qs,
                                            cpu_mesh()).numpy()
    span = x.max() - x.min()
    assert np.all(np.abs(got - np.percentile(x[mask], qs)) < span / 2048 * 2)
    np.testing.assert_array_equal(
        got, tstats.histogram_percentile(T(x), T(mask), qs).numpy())
    want = np.asarray(jpar.sharded_histogram_percentile(
        jnp.asarray(x), jnp.asarray(mask), qs, jpar.make_mesh()))
    np.testing.assert_allclose(got, want, rtol=0, atol=span / 2048 ** 2)


@pytest.mark.parametrize("weighted", [False, True])
def test_data_parallel_ridge_fit(eight_devices, rng, weighted):
    """The JAX test's data (8 * 512 px, Bx 4, By 6, degree 2): W within
    1e-6 of the port's single-device fit (f64 terms psum-reduced), and
    against the JAX op (f32 normal equations) x_mean / x_std to 1e-6
    relative and predictions to 1e-5, the bounds of test_fit_matches_jax."""
    n, bx, by = 8 * 512, 4, 6
    X = rng.random((n, bx)).astype(np.float32)
    Y = np.clip(0.2 + 0.4 * X[:, :1] + 0.1 * rng.random((n, by)),
                0.01, 0.99).astype(np.float32)
    w = rng.random(n).astype(np.float32) if weighted else None
    cfg = RidgeSRConfig(degree=2)
    single = tridge.RidgeSpectralSR(bx, by, cfg, device="cpu").fit(X, Y, w)
    multi = tridge.RidgeSpectralSR(bx, by, cfg, device="cpu")
    out = tpar.data_parallel_ridge_fit(multi, X, Y, cpu_mesh(), weights=w)
    assert out is multi
    np.testing.assert_allclose(multi.W.numpy(), single.W.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(multi.intercept.numpy(),
                               single.intercept.numpy(), rtol=0, atol=1e-6)
    jm = jridge.RidgeSpectralSR(bx, by, JRidgeSRConfig(degree=2))
    jpar.data_parallel_ridge_fit(jm, X, Y, jpar.make_mesh(), weights=w)
    np.testing.assert_allclose(multi.x_mean.numpy(),
                               np.asarray(jm.params.x_mean), rtol=1e-6)
    np.testing.assert_allclose(multi.x_std.numpy(),
                               np.asarray(jm.params.x_std), rtol=1e-6)
    Xq = rng.random((500, bx)).astype(np.float32)
    np.testing.assert_allclose(multi.predict(Xq).numpy(), jm.predict(Xq),
                               atol=1e-5)


def test_sharded_tile_map(eight_devices, rng):
    """Per-tile means over 16 tiles on 8 shards against the JAX op and
    NumPy (1e-5 relative), and a tuple-valued function (the pytree
    comes back in its structure)."""
    tiles = rng.random((16, 12, 12)).astype(np.float32)
    got = tpar.sharded_tile_map(lambda t: t.mean(), T(tiles), cpu_mesh())
    want = np.asarray(jpar.sharded_tile_map(lambda t: t.mean(),
                                            jnp.asarray(tiles),
                                            jpar.make_mesh()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), tiles.mean(axis=(1, 2)),
                               rtol=1e-5)
    lo, hi = tpar.sharded_tile_map(lambda t: (t.min(), t[0] * 2.0),
                                   T(tiles), cpu_mesh())
    np.testing.assert_array_equal(lo.numpy(), tiles.min(axis=(1, 2)))
    np.testing.assert_array_equal(hi.numpy(), tiles[:, 0] * 2.0)


def test_halo_exchange_rows(eight_devices):
    """The JAX test's raster (64 rows over 8 shards, halo 2): the padded
    blocks equal the JAX op's inside shard_map, the middle shards hold
    rows [8k-2, 8k+10), the outer edges replicate rows 0 and 63."""
    from hyperres.parallel.ops import halo_exchange_rows as j_halo

    x = np.arange(64, dtype=np.float32).reshape(64, 1)

    @partial(shard_map, mesh=jpar.make_mesh(), in_specs=(P("data"),),
             out_specs=P("data"))
    def with_halo(xs):
        return j_halo(xs, halo=2, axis="data")

    want = np.asarray(with_halo(jnp.asarray(x))).reshape(8, 12, 1)
    got = tpar.halo_exchange_rows(list(T(x).split(8)), halo=2)
    for k in range(8):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in range(1, 7):
        np.testing.assert_array_equal(
            got[k][:, 0].numpy(),
            np.arange(8 * k - 2, 8 * k + 10, dtype=np.float32))
    np.testing.assert_array_equal(got[0][:2, 0].numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(got[7][-2:, 0].numpy(), [63.0, 63.0])


def test_sharded_srf_synthesize(eight_devices, rng):
    """64 bands of a (24, 16) cube with S2A's builtin SRF over 8 band
    shards: 1e-5 abs of the JAX op and of the port's single-device
    synthesis (sums in another order)."""
    from hyperres.kernels.srf import build_srf_weight_matrix
    from hyperres.spectral.srf_tables import builtin_srf
    from hyperres.testing.scenes import emit_wavelength_grid
    from hyperres_torch.kernels.srf import srf_synthesize

    wl, good = emit_wavelength_grid(64)
    W, _, _ = build_srf_weight_matrix(wl, builtin_srf("S2A"), good)
    W = np.asarray(W, np.float32)
    cube = rng.random((24, 16, 64)).astype(np.float32)
    got = tpar.sharded_srf_synthesize(cube, W,
                                      cpu_mesh(names=("band",))).numpy()
    want = np.asarray(jpar.sharded_srf_synthesize(
        cube, W, jpar.make_mesh(axis_names=("band",))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, srf_synthesize(T(cube), T(W)).numpy(),
                               rtol=0, atol=1e-5)


def test_sharded_orthowarp(eight_devices, rng):
    """The tap-loop warp with destination rows over 8 shards (the JAX
    test's case): bit-equal to the port's single-device
    orthowarp_taploop; against the JAX op 5e-3 abs and the 99th
    percentile under 1e-4 (the JAX test's bounds)."""
    raw = rng.random((30, 35, 9)).astype(np.float32)
    ho, wo = 40, 44
    glt = np.zeros((ho, wo, 2), dtype=np.int32)
    vmask = rng.random((ho, wo)) > 0.25
    glt[..., 0] = np.where(vmask, rng.integers(1, 36, (ho, wo)), 0)
    glt[..., 1] = np.where(vmask, rng.integers(1, 31, (ho, wo)), 0)
    flat_idx, valid = prepare_glt(glt, (30, 35))
    rows = rng.uniform(-2, ho + 1, size=(48, 52)).astype(np.float32)
    cols = rng.uniform(-2, wo + 1, size=(48, 52)).astype(np.float32)
    got = tpar.sharded_orthowarp(raw, flat_idx, valid, rows, cols,
                                 cpu_mesh()).numpy()
    single = orthowarp_taploop(T(raw), T(flat_idx), T(valid), T(rows),
                               T(cols), row_chunks=1).numpy()
    np.testing.assert_array_equal(got, single)
    want = np.asarray(jpar.sharded_orthowarp(raw, flat_idx, valid, rows,
                                             cols, jpar.make_mesh()))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert np.percentile(np.abs(got - want), 99) < 1e-4


def test_sharded_orthowarp_two_pass(eight_devices, rng):
    """8-way two-pass warp (pass 1 by source scanlines, the halo
    exchange, pass 2 by destination rows), halo 8: bit-equal to the
    port's single-device orthowarp_two_pass; against the JAX op the
    same fill pixels, 5e-4 of max(|v|, 1) and the 99th percentile under
    1e-5 (beside the GLT's holes a small weight mass renormalises values
    to ~100, where both packages' f32 rounding is amplified alike: six
    such pixels of 19200 part by up to 2.4e-3, 1.5e-5 of their value)."""
    case = warp_case(rng)
    got = tpar.sharded_orthowarp_two_pass(*case, cpu_mesh(), halo=8)
    np.testing.assert_array_equal(got.numpy(),
                                  single_two_pass(*case).numpy())
    want = np.asarray(jpar.sharded_orthowarp_two_pass(
        *case, jpar.make_mesh(axis_names=("data",)), halo=8))
    np.testing.assert_array_equal(got.numpy() == -9999.0, want == -9999.0)
    d = np.abs(got.numpy() - want)
    assert (d <= 5e-4 * np.maximum(np.abs(want), 1.0)).all(), d.max()
    assert np.percentile(d, 99) < 1e-5


def test_sharded_two_pass_needs_no_more_than_min_halo(rng):
    """min_two_pass_halo: the warp passes at that halo (bit-equal to the
    single-device warp) and is refused one below it ("increase halo")."""
    case = warp_case(rng, n_bands=2)
    rows = case[3]
    for n in (2, 4, 8):
        halo = min_two_pass_halo(rows, 64, n)
        got = tpar.sharded_orthowarp_two_pass(*case, cpu_mesh((n,)),
                                              halo=halo)
        np.testing.assert_array_equal(got.numpy(),
                                      single_two_pass(*case).numpy())
        if halo > 0:
            with pytest.raises(ValueError, match="increase halo"):
                tpar.sharded_orthowarp_two_pass(*case, cpu_mesh((n,)),
                                                halo=halo - 1)


def test_sharded_two_pass_guards(eight_devices, rng):
    """The reference's host checks with its messages, on both packages:
    the halo guard (the JAX test's skewed case), the divisibility error
    and the halo-over-a-shard error."""
    from hyperres.kernels.glt import prepare_glt as jprep

    raw = rng.random((20, 22, 2)).astype(np.float32)
    ho, wo, hd, wd = 32, 24, 64, 26
    glt = np.ones((ho, wo, 2), dtype=np.int32)
    flat_idx, vmask = jprep(glt, (20, 22))
    rows = np.broadcast_to((np.arange(hd, dtype=np.float32) * ho / hd)
                           [:, None], (hd, wd)).copy()
    cols = np.broadcast_to(np.arange(wd, dtype=np.float32)[None, :] * 0.9,
                           (hd, wd)).copy()
    cstar = scanline_cstar(rows, cols, ho)
    args = (raw, flat_idx, vmask, rows, cols, cstar)
    jmesh = jpar.make_mesh(axis_names=("data",))
    for msg, kw, mesh_n in (("increase halo", {"halo": 1}, 8),
                            ("exceeds the per-shard scanline count 4",
                             {"halo": 5}, 8),
                            ("must divide the mesh axis 3", {}, 3)):
        for fn, mesh in ((jpar.sharded_orthowarp_two_pass,
                          jpar.make_mesh((mesh_n,), ("data",),
                                         eight_devices[:mesh_n])),
                         (tpar.sharded_orthowarp_two_pass,
                          cpu_mesh((mesh_n,)))):
            with pytest.raises(ValueError, match=msg):
                fn(*args, mesh, **kw)
    del jmesh


def test_sharded_streamed_orthowarp(eight_devices, rng):
    """The streamed fold (u16, 8-band chunks over 20 bands) on 8 shards:
    bit-equal to the port's single-device warp of the same u16-streamed
    cube; against the JAX op the JAX test's bounds (5e-3 abs, 99th
    percentile under 1e-4)."""
    raw, flat_idx, vmask, rows, cols, cstar = warp_case(rng, n_bands=20)

    def read_bands(b0, b1):
        return raw[..., b0:b1]

    got = tpar.sharded_streamed_orthowarp(
        read_bands, raw.shape, flat_idx, vmask, rows, cols, cstar,
        cpu_mesh(), halo=8, transfer="u16", chunk_bands=8).numpy()
    assert got.shape == (64, 50, 20)
    raw_u16 = stream_cube_to_device(read_bands, raw.shape, transfer="u16",
                                    chunk_bands=8, device="cpu")
    single = single_two_pass(raw_u16.numpy(), flat_idx, vmask, rows, cols,
                             cstar).numpy()
    np.testing.assert_array_equal(got, single)
    want = np.asarray(jpar.sharded_streamed_orthowarp(
        read_bands, raw.shape, flat_idx, vmask, rows, cols, cstar,
        jpar.make_mesh(axis_names=("data",)), halo=8, transfer="u16",
        chunk_bands=8))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert np.percentile(np.abs(got - want), 99) < 1e-4


def test_sharded_streamed_fold_u12_and_f32(rng):
    """f32 and u12 transfers through the same sharded fold on the JAX
    test's case (9 bands: the u12 padding band; a GLT without holes):
    f32 bit-equal to the one-shot sharded warp, u12 with the same fill
    pixels and within 2e-3 of f32 (the JAX test's bound)."""
    raw = rng.random((24, 26, 9)).astype(np.float32)
    ho = wo = 64
    hd, wd = 64, 30
    glt = np.ones((ho, wo, 2), dtype=np.int32)
    glt[..., 0] = rng.integers(1, 27, (ho, wo))
    glt[..., 1] = rng.integers(1, 25, (ho, wo))
    flat_idx, vmask = prepare_glt(glt, (24, 26))
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd)).astype(np.float32) + 0 * j
    cols = (j * (wo / wd)).astype(np.float32) + 0 * r
    cstar = scanline_cstar(rows, cols, ho)
    outs = {t: tpar.sharded_streamed_orthowarp(
        lambda b0, b1: raw[..., b0:b1], raw.shape, flat_idx, vmask, rows,
        cols, cstar, cpu_mesh(), halo=8, transfer=t, chunk_bands=4).numpy()
        for t in ("f32", "u12")}
    one = tpar.sharded_orthowarp_two_pass(raw, flat_idx, vmask, rows, cols,
                                          cstar, cpu_mesh(), halo=8)
    np.testing.assert_array_equal(outs["f32"], one.numpy())
    v = outs["f32"] != -9999.0
    np.testing.assert_array_equal(v, outs["u12"] != -9999.0)
    assert np.abs(outs["f32"][v] - outs["u12"][v]).max() < 2e-3


def test_sharded_sr_predict_u16(eight_devices, rng):
    """Row-sharded SR inference (the JAX test's model, 8 * 256 px) with
    the JAX model's parameters: both engines bit-equal to the port's
    single-device serving form; the "xla" engine against the JAX op <= 1
    step with the same 65535 mask; an N that does not divide the axis is
    refused; on the CPU no kernel launch is counted."""
    n, bx, by = 8 * 256, 4, 6
    Xtr = rng.random((4000, bx)).astype(np.float32)
    Ytr = np.clip(0.2 + 0.4 * Xtr[:, :1] + 0.1 * rng.random((4000, by)),
                  0.01, 0.99).astype(np.float32)
    jm = jridge.RidgeSpectralSR(bx, by, JRidgeSRConfig(degree=2,
                                                       batch_pixels=256))
    jm.fit(Xtr, Ytr)
    tm = tridge.RidgeSpectralSR(bx, by, RidgeSRConfig(degree=2,
                                                      batch_pixels=256),
                                device="cpu")
    p = jm.params
    tm.params_from_numpy(*(np.asarray(a) for a in (p.x_mean, p.x_std, p.W,
                                                   p.intercept)))
    X = rng.random((n, bx)).astype(np.float32)
    valid = rng.random((n,)) > 0.1
    X[~valid] = 0.0
    mesh = cpu_mesh()
    reset_launch_counts()
    for engine in ("xla", "pallas"):
        got = sharded_sr_predict_u16(tm, X, valid, mesh, engine=engine)
        single = tridge.sr_predict_u16(X, valid, tm, engine=engine)
        np.testing.assert_array_equal(got.numpy(), single.numpy())
    assert not launch_counts
    want = np.asarray(j_sr(jm, X, valid, jpar.make_mesh())).astype(np.int32)
    q = got.numpy().astype(np.int32)
    np.testing.assert_array_equal(q == 65535, want == 65535)
    assert np.abs(q - want).max() <= 1
    with pytest.raises(ValueError, match="must divide"):
        sharded_sr_predict_u16(tm, X[:-3], valid[:-3], mesh)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_sharded_orthowarp_srf_2d(eight_devices, rng, shape):
    """Row x band mesh, 8 bands -> 3 synthesized: against the port's
    single-device warp followed by the matmul, 1e-5 abs plus 1e-6 of the
    value (the band psum adds in another order; beside the GLT's holes
    values reach ~100); against the JAX op the JAX test's bounds
    (under 0.1 % of valid pixels past 5e-4, 99th percentile under
    5e-5); the band count must divide the band axis."""
    case = warp_case(rng, n_bands=8)
    W = rng.random((8, 3)).astype(np.float32)
    got = tpar.sharded_orthowarp_srf_2d(*case, W, cpu_mesh(shape,
                                                           ("row", "band")),
                                        halo=8).numpy()
    cube = single_two_pass(*case)
    single = (cube.reshape(-1, 8) @ T(W)).reshape(64, 50, 3).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-6, atol=1e-5)
    want = np.asarray(jpar.sharded_orthowarp_srf_2d(
        *case, W, jpar.make_mesh(shape, ("row", "band")), halo=8))
    ok = cube[..., 0].numpy() != -9999.0
    d = np.abs(got[ok] - want[ok])
    assert (d > 5e-4).mean() < 1e-3
    assert np.percentile(d, 99) < 5e-5
    with pytest.raises(ValueError, match="band count 7 must divide"):
        tpar.sharded_orthowarp_srf_2d(
            case[0][..., :7], *case[1:], W[:7],
            cpu_mesh(shape, ("row", "band")), halo=8)

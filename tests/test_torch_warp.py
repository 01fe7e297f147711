"""The PyTorch port's warp against the JAX reference on the CPU: the
scanline resample (the plain version of the hand-written CUDA kernel)
against the dense two-pass warp and the banded Pallas kernels (in
interpret mode), the dense route's plain version against
``pallas_scanline_resample`` (in interpret mode), the fused GLT
orthowarp by both routes, the grid transfers and the GLT gather. Inputs
are made with NumPy from a seed and given to both. The kernel itself
runs only on a CUDA device (on the card: tests_gpu/)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hyperres.kernels import glt as jglt  # noqa: E402
from hyperres.kernels import warp as jwarp  # noqa: E402
from hyperres.kernels.pallas_ops import (  # noqa: E402
    banded_spans_ok, pallas_banded_two_pass, pallas_scanline_resample,
)
from hyperres_torch.kernels import banded  # noqa: E402
from hyperres_torch.kernels import glt as tglt  # noqa: E402
from hyperres_torch.kernels import host  # noqa: E402
from hyperres_torch.kernels import warp as twarp  # noqa: E402

T = torch.from_numpy

# the two-pass geometries of tests/test_pallas_ops.py:61, :146, :174
GEOMETRIES = {
    "glt_200x210": (200, 210, 190, 205),
    "plain_150x160": (150, 160, 140, 155),
    "wide_150x600": (150, 600, 140, 590),
}


def _geometry(name):
    ho, wo, hd, wd = GEOMETRIES[name]
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.004 * j * r / hd + 0.3).astype(np.float32)
    cols = (j * (wo / wd) + 0.003 * r - 0.2).astype(np.float32)
    cstar = host.scanline_cstar(rows, cols, ho)
    return rows, cols, cstar


def _glt_case(rng):
    raw = rng.random((150, 160, 7)).astype(np.float32)
    ho, wo = 200, 210
    glt = np.zeros((ho, wo, 2), np.int32)
    valid = rng.random((ho, wo)) > 0.15
    glt[..., 0] = np.where(valid, rng.integers(1, 161, (ho, wo)), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, 151, (ho, wo)), 0)
    flat_idx, vmask = host.prepare_glt(glt, (150, 160))
    return raw, flat_idx, vmask


def _src_ext(name, rng):
    ho, wo = GEOMETRIES[name][:2]
    if name == "glt_200x210":
        raw, flat_idx, vmask = _glt_case(rng)
        v = raw.reshape(-1, 7)[flat_idx.reshape(-1)].reshape(ho, wo, 7)
        validf = vmask.astype(np.float32)[..., None]
        return np.concatenate([v * validf, validf], axis=-1)
    return rng.random((ho, wo, 5)).astype(np.float32)


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_scanline_two_pass_matches_reference(name, method, rng):
    """Plain scanline resample (pass 1 at cstar, pass 2 at rows on pass
    1's natural layout) == JAX _two_pass_core at HIGHEST and == the
    banded Pallas pair. atol 3e-6 as test_pallas_ops.py:103: both sum
    the same <= 4 non-zero f32 products in another order."""
    rows, _, cstar = _geometry(name)
    src = _src_ext(name, rng)
    assert banded_spans_ok(cstar) and banded_spans_ok(rows.T)
    h = banded.scanline_resample(T(src), T(cstar), axis=1, method=method)
    got = banded.scanline_resample(h, T(rows), axis=0,
                                   method=method).numpy()
    dense = np.asarray(jwarp._two_pass_core(
        jnp.asarray(src), jnp.asarray(rows), jnp.asarray(cstar), method,
        64, 64, jax.lax.Precision.HIGHEST))
    band = np.asarray(pallas_banded_two_pass(
        jnp.asarray(src), jnp.asarray(rows), jnp.asarray(cstar),
        method=method, precision="highest"))
    np.testing.assert_allclose(got, dense, rtol=0, atol=3e-6)
    np.testing.assert_allclose(got, band, rtol=0, atol=3e-6)


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_orthowarp_two_pass_matches_jax(method, rng):
    """Fused GLT + two-pass warp == JAX orthowarp_two_pass(precision=
    "highest"): identical fill masks; values to atol 1e-5 where the
    carried validity mass is >= 0.5, and to 2e-4 of max(|v|, 1) at edge
    pixels, where dividing by a small mass amplifies the f32 rounding of
    both sums (this random-hole GLT makes many such pixels)."""
    raw, flat_idx, vmask = _glt_case(rng)
    rows, cols, cstar = _geometry("glt_200x210")
    want = np.asarray(jwarp.orthowarp_two_pass(
        jnp.asarray(raw), jnp.asarray(flat_idx), jnp.asarray(vmask),
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(cstar),
        method=method, precision="highest"))
    got = twarp.orthowarp_two_pass(
        T(raw), T(flat_idx), T(vmask), T(rows), T(cols), T(cstar),
        method=method).numpy()
    fill_w, fill_g = want == -9999.0, got == -9999.0
    np.testing.assert_array_equal(fill_g, fill_w)
    assert fill_w.any() and not fill_w.all()
    ok = ~fill_w
    mass = np.asarray(jwarp._two_pass_core(
        jnp.asarray(vmask.astype(np.float32)[..., None]), jnp.asarray(rows),
        jnp.asarray(cstar), method, 64, 64, jax.lax.Precision.HIGHEST))
    inner = ok & (mass >= 0.5)
    assert inner.sum() > 0.5 * ok.sum()
    np.testing.assert_allclose(got[inner], want[inner], rtol=0, atol=1e-5)
    err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
    assert err.max() <= 2e-4


def test_scanline_padding_positions_give_zero(rng):
    """Positions of +-1e6 (the padding convention) and NaN give
    all-zero taps; the wrapper's CPU path is the plain version."""
    src = T(rng.random((4, 9, 3)).astype(np.float32))
    pos = T(rng.uniform(-1, 9, (4, 6)).astype(np.float32))
    pos[0, 0], pos[1, 1], pos[2, 2] = 1e6, -1e6, float("nan")
    out = banded.scanline_resample(src, pos, axis=1)
    assert torch.equal(out, banded.scanline_resample_reference(src, pos, 1))
    for r, c in ((0, 0), (1, 1), (2, 2)):
        assert torch.all(out[r, c] == 0)
    assert torch.all(out[3].abs().sum(-1) > 0)


def test_scanline_wrapper_validates():
    src = torch.zeros((4, 9, 3))
    with pytest.raises(TypeError):
        banded.scanline_resample(src.double(), torch.zeros((4, 6)), 1)
    with pytest.raises(ValueError, match="pass 1"):
        banded.scanline_resample(src, torch.zeros((5, 6)), 1)
    with pytest.raises(ValueError, match="pass 2"):
        banded.scanline_resample(src, torch.zeros((5, 6)), 0)
    with pytest.raises(ValueError, match="method"):
        banded.scanline_resample(src, torch.zeros((4, 6)), 1, "lanczos")
    with pytest.raises(ValueError, match="axis"):
        banded.scanline_resample(src, torch.zeros((4, 6)), 2)


def _dense_case(rng, n=12, s=160, c=9, d=144):
    """The shape of tests/test_pallas_ops.py:239, with positions that
    run past both ends of the source axis and two padding positions."""
    src = rng.random((n, s, c)).astype(np.float32)
    pos = (np.linspace(-3.0, s + 2.0, d, dtype=np.float32)[None, :]
           + rng.random((n, 1)).astype(np.float32))
    pos[0, 5], pos[1, 7] = -1e6, 1e6
    return src, pos


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
@pytest.mark.parametrize("precision,atol", [("highest", 1e-5),
                                            ("high", 1e-4)])
def test_dense_reference_matches_pallas_scanline(precision, atol, method,
                                                 rng):
    """The dense route's plain version == pallas_scanline_resample in
    interpret mode. At "highest" both are f32 dot products over the
    whole axis, in another order: 1e-5. At "high" the reference splits
    into bf16x3 (about 2**-16 relative, tests/test_pallas_ops.py:233)
    while the port stays exact f32: 1e-4."""
    src, pos = _dense_case(rng)
    want = np.asarray(pallas_scanline_resample(
        jnp.asarray(src), jnp.asarray(pos), method=method,
        precision=precision))
    got = banded.scanline_resample_dense(T(src), T(pos), method,
                                         precision).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_dense_reference_equals_taps(method, rng):
    """The full-axis dense sum == the <= 4-tap sum (what the kernel
    computes) for finite src, to 1e-6 (zero weights add exact zeros; the
    four live products are summed in another order); and ``axis=0`` on
    the pass-2 layout, as the warp's pass 2 runs it, is exactly the
    transpose of ``axis=1`` on the transposed operands."""
    src, pos = _dense_case(rng)
    taps = banded.scanline_resample_reference(T(src), T(pos), 1, method)
    dense = banded.scanline_resample_dense(T(src), T(pos), method)
    torch.testing.assert_close(dense, taps, rtol=0, atol=1e-6)
    src_nat = T(np.ascontiguousarray(src.transpose(1, 0, 2)))
    pos_nat = T(np.ascontiguousarray(pos.T))
    got = banded.scanline_resample_dense(src_nat, pos_nat, method, axis=0)
    assert got.shape == (pos.shape[1], pos.shape[0], src.shape[2])
    assert got.is_contiguous()
    torch.testing.assert_close(got, dense.transpose(0, 1), rtol=0, atol=0)


def test_dense_nonfinite_src_poisons_rows(rng):
    """A reference behaviour: for a NaN in src the dense contraction
    (pallas_scanline_resample, and the dense plain version with it)
    makes the whole output row of that channel NaN (0 * NaN = NaN),
    while the tap evaluation of the CUDA kernel poisons only the outputs
    whose live taps read the NaN sample (|pos - s| < 2)."""
    src, pos = _dense_case(rng)
    pos = pos[:, 10:-10]     # in range, no padding positions
    n0, s0, c0 = 3, 80, 4
    src[n0, s0, c0] = np.nan
    want = np.asarray(pallas_scanline_resample(
        jnp.asarray(src), jnp.asarray(pos), precision="highest"))
    dense = banded.scanline_resample_dense(T(src), T(pos)).numpy()
    taps = banded.scanline_resample_reference(T(src), T(pos), 1).numpy()
    for out in (want, dense):
        assert np.isnan(out[n0, :, c0]).all()
        assert np.isfinite(np.delete(out, c0, axis=2)).all()
    near = np.abs(pos[n0] - s0) < 2.0
    assert 0 < near.sum() < near.size
    np.testing.assert_array_equal(np.isnan(taps[n0, :, c0]), near)
    assert np.isfinite(np.delete(taps, n0, axis=0)).all()


def test_dense_precision_and_backend_checks():
    src, pos = torch.zeros((2, 5, 3)), torch.zeros((2, 4))
    with pytest.raises(NotImplementedError, match="default"):
        banded.scanline_resample_dense(src, pos, precision="default")
    with pytest.raises(ValueError, match="precision"):
        banded.scanline_resample_dense(src, pos, precision="float64")
    with pytest.raises(ValueError, match="axis"):
        banded.scanline_resample_dense(src, pos, axis=2)
    with pytest.raises(ValueError, match="pass 2"):
        banded.scanline_resample_dense(src, pos, axis=0)
    z = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="backend"):
        twarp.orthowarp_two_pass(torch.zeros((4, 4, 2)),
                                 torch.zeros((4, 4), dtype=torch.int64),
                                 z > 0, z, z, z, backend="mxu")


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_orthowarp_two_pass_pallas_backend_matches_jax(method, rng):
    """backend="pallas" (the dense route for both passes) == JAX
    orthowarp_two_pass(backend="pallas", precision="highest") in
    interpret mode, with the bounds of the banded route's test above:
    identical fill masks, 1e-5 where the carried validity mass is
    >= 0.5, 2e-4 of max(|v|, 1) at edge pixels; and == the port's own
    banded route to 1e-5 with identical fill masks."""
    raw, flat_idx, vmask = _glt_case(rng)
    rows, cols, cstar = _geometry("glt_200x210")
    want = np.asarray(jwarp.orthowarp_two_pass(
        jnp.asarray(raw), jnp.asarray(flat_idx), jnp.asarray(vmask),
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(cstar),
        method=method, precision="highest", backend="pallas"))
    args = (T(raw), T(flat_idx), T(vmask), T(rows), T(cols), T(cstar))
    got = twarp.orthowarp_two_pass(*args, method=method,
                                   backend="pallas").numpy()
    banded_route = twarp.orthowarp_two_pass(*args, method=method).numpy()
    fill_w = want == -9999.0
    np.testing.assert_array_equal(got == -9999.0, fill_w)
    np.testing.assert_array_equal(banded_route == -9999.0, fill_w)
    ok = ~fill_w
    mass = np.asarray(jwarp._two_pass_core(
        jnp.asarray(vmask.astype(np.float32)[..., None]), jnp.asarray(rows),
        jnp.asarray(cstar), method, 64, 64, jax.lax.Precision.HIGHEST))
    inner = ok & (mass >= 0.5)
    np.testing.assert_allclose(got[inner], want[inner], rtol=0, atol=1e-5)
    err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
    assert err.max() <= 2e-4
    np.testing.assert_allclose(got[inner], banded_route[inner], rtol=0,
                               atol=1e-5)


def _spec_case(rng, nan_frac=0.05):
    """A 60 m <-> 10 m aligned pair from the bench geometry (6:1)."""
    from hyperres_torch.testing.bench_scene import generate_scene

    sc = generate_scene(0.03, 0)
    s2, utm = sc["s2_grid"], sc["utm60"]

    def axes(src, dst):
        xs, ys = dst.pixel_center_coords()
        return (np.asarray(src.colrow_of(src.x0, ys)[1], np.float64),
                np.asarray(src.colrow_of(xs, src.y0)[0], np.float64))

    d, u = axes(s2, utm), axes(utm, s2)
    down = (host.separable_fast_spec(d[0], s2.height, "average", scale=6.0),
            host.separable_fast_spec(d[1], s2.width, "average", scale=6.0))
    up = (host.separable_fast_spec(u[0], utm.height, "bilinear"),
          host.separable_fast_spec(u[1], utm.width, "bilinear"))
    assert down[0][0] == "avg" and up[0][0] == "bilin"
    img10 = rng.random((s2.height, s2.width, 3)).astype(np.float32)
    img10[rng.random(img10.shape[:2]) < nan_frac] = np.nan
    img10[rng.random(img10.shape) < nan_frac] = 6.5535   # sentinel
    img60 = rng.random((utm.height, utm.width, 3)).astype(np.float32)
    img60[rng.random(img60.shape[:2]) < nan_frac] = np.nan
    valid60 = rng.random(img60.shape[:2]) > 0.1
    return down, up, img10, img60, valid60, (s2, utm)


@pytest.mark.parametrize("kind", ["avg_nodata", "avg_mask", "bilin_mask",
                                  "bilin_plain"])
def test_separable_resample_fast_matches_jax(kind, rng):
    """avg (10 m -> 60 m) and bilin (60 m -> 10 m) specs with NaN
    sources, a nodata sentinel and a shared valid mask: identical NaN
    masks, values (< 1) to 5e-7, four f32 ulps: the quotient of two
    block sums / lerps, each rounded in another summation order."""
    down, up, img10, img60, valid60, _ = _spec_case(rng)
    if kind.startswith("avg"):
        img, spec = img10, down
        mask = (rng.random(img10.shape[:2]) > 0.1
                if kind == "avg_mask" else None)
        nodata = 6.5535
    else:
        img, spec, mask = img60, up, valid60
        nodata = None
        if kind == "bilin_plain":
            img, mask = np.nan_to_num(img60), None
    want = np.asarray(jwarp.separable_resample_fast(
        jnp.asarray(img), spec[0], spec[1], nodata=nodata, fill=jnp.nan,
        valid_mask=None if mask is None else jnp.asarray(mask)))
    got = twarp.separable_resample_fast(
        T(img), spec[0], spec[1], nodata=nodata, fill=np.nan,
        valid_mask=None if mask is None else T(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(want).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


@pytest.mark.parametrize("direction", ["down", "up"])
def test_separable_resample_matmul_matches_jax(direction, rng):
    """The dense weight-matrix transfer (used where a grid pair has no
    integer-aligned spec) at JAX HIGHEST precision: identical NaN masks,
    values to 1e-6 (f32 dot products summed in another order)."""
    _, _, img10, img60, valid60, (s2, utm) = _spec_case(rng)
    if direction == "down":
        axes = host.separable_index_axes(s2, utm)
        Wr = host.separable_weight_matrix(axes[0], s2.height, "average",
                                          scale=6.0)
        Wc = host.separable_weight_matrix(axes[1], s2.width, "average",
                                          scale=6.0)
        img, kw, tkw = img10, {"nodata": 6.5535}, {"nodata": 6.5535}
    else:
        axes = host.separable_index_axes(utm, s2)
        Wr = host.separable_weight_matrix(axes[0], utm.height, "bilinear")
        Wc = host.separable_weight_matrix(axes[1], utm.width, "bilinear")
        img = img60
        kw = {"valid_mask": jnp.asarray(valid60)}
        tkw = {"valid_mask": T(valid60)}
    want = np.asarray(jwarp.separable_resample_matmul(
        jnp.asarray(img), jnp.asarray(Wr), jnp.asarray(Wc), fill=jnp.nan,
        fast=False, **kw))
    got = twarp.separable_resample_matmul(T(img), T(Wr), T(Wc),
                                          fill=np.nan, **tkw).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_glt_gather_matches_jax(rng):
    raw, flat_idx, vmask = _glt_case(rng)
    want = np.asarray(jglt.glt_gather(jnp.asarray(raw),
                                      jnp.asarray(flat_idx),
                                      jnp.asarray(vmask)))
    got = tglt.glt_gather(T(raw), T(flat_idx), T(vmask)).numpy()
    np.testing.assert_array_equal(got, want)

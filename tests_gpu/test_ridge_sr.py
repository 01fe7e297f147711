"""The SR-predict kernel (``csrc/sr_predict.cu``) on the card against its
plain version: both layouts, the resident and the streamed route, the
route rule's shared-memory mirrors and the ``engine=`` argument. Moved
from tests/test_torch_ridge_sr.py, whose CPU tests hold the plain
version and the port's fit to the JAX package; the models here are the
port's own fits on the same seeded data.

Tolerance: u16 products agree on the 65535 mask exactly and to 1 step
elsewhere (the kernel's three-term TF32 contraction sums in another
order than the plain version's f32, which moves a value sitting on a
rounding edge by one step)."""

import numpy as np
import pytest
import torch

from hyperres_torch.core.config import RidgeSRConfig
from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.fusion import ridge_sr as tridge
from hyperres_torch.kernels import sr_predict

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


def _fit(name, device):
    """The port's fit of tests/test_torch_ridge_sr.py's ``jax_models``
    model ``name`` (the same data and config) on ``device``."""
    bx, by, deg = MODELS[name]
    X, Y = _training_data(bx, by, 6000, 1)
    return tridge.RidgeSpectralSR(
        bx, by, RidgeSRConfig(degree=deg, batch_pixels=512),
        device=device).fit(X, Y)


def _assert_u16_close(got, want, steps=1):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.uint16
    np.testing.assert_array_equal(got == 65535, want == 65535)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= steps, d.max()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["cmajor", "rowmajor"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sr_kernel_matches_plain_on_gpu(cuda_device, name, layout):
    """The CUDA kernel == its plain version on the card (identical 65535
    mask, <= 1 step), validity from the bands (cmajor, with nodata) or
    from a mask (rowmajor); each launch counts once."""
    tm = _fit(name, cuda_device)
    cube = _cube(tm.n_inputs, 61, 67, 7)
    X = T(cube.reshape(tm.n_inputs, -1)).to(cuda_device)
    args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
    kw = {"nodata": NODATA}
    if layout == "rowmajor":
        X = X.T.contiguous()
        kw = {"valid": sr_predict.valid_pixels(X, NODATA)}
    reset_launch_counts()
    got = sr_predict.sr_predict_u16(X, *args, layout=layout, **kw)
    want = sr_predict.sr_predict_u16_reference(X, *args, layout=layout,
                                               **kw)
    torch.cuda.synchronize()
    assert launch_counts == {sr_predict.KERNEL_NAME: 1}
    _assert_u16_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["cmajor", "rowmajor"])
@pytest.mark.parametrize("by", [32, 285])
def test_sr_kernel_wide_and_degree4_on_gpu(cuda_device, by, layout):
    """The tensor-core kernel on its other tile shapes: By = 32 and 285
    (a ragged last band tile) at degree 3 (F = 285, 32 bands per CTA),
    and degree 4 (F = 1000, 16 bands per CTA), 61 x 67 px (a ragged
    last pixel tile), NaN and nodata pixels: identical 65535 mask, <= 1
    step from the plain version. The wrapper's shared-memory mirror
    agrees with the kernel's own; past it (F = 1819, 12 bands at degree
    4) the route is the streamed one, and a 17-band model is refused
    before launch."""
    X, Y = _training_data(10, by, 20000, 8)
    for deg in (3, 4):
        tm = tridge.RidgeSpectralSR(10, by, RidgeSRConfig(degree=deg),
                                    device=cuda_device).fit(X, Y)
        Xc = T(_cube(10, 61, 67, 7).reshape(10, -1)).to(cuda_device)
        args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
        kw = {"nodata": NODATA}
        if layout == "rowmajor":
            Xc = Xc.T.contiguous()
            kw = {"valid": sr_predict.valid_pixels(Xc, NODATA)}
        got = sr_predict.sr_predict_u16(Xc, *args, layout=layout, **kw)
        want = sr_predict.sr_predict_u16_reference(Xc, *args, layout=layout,
                                                   **kw)
        _assert_u16_close(got.cpu().numpy(), want.cpu().numpy())
    from hyperres_torch.kernels._build import load_library
    lib = load_library("sr_predict")
    for k_cols in range(32, 2048, 32):
        for deg in (3, 4):
            assert (lib.sr_predict_tile_bands(k_cols, deg)
                    == sr_predict.sr_tile_bands(k_cols, deg))
    assert sr_predict.sr_route(2080, 4) == (sr_predict.STREAMED, 32)
    big = tridge.RidgeSpectralSR(17, 4, RidgeSRConfig(degree=1),
                                 device=cuda_device)
    big.params_from_numpy(np.zeros(17), np.ones(17),
                          np.zeros((big.n_features, 4)), np.zeros(4))
    with pytest.raises(ValueError, match="Bx <= 16"):
        sr_predict.sr_predict_u16(
            torch.zeros((17, 64), device=cuda_device), big.x_mean,
            big.x_std, big.W, big.intercept, big.factors)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["cmajor", "rowmajor"])
@pytest.mark.parametrize("bx,by", [(12, 32), (12, 285), (16, 8)])
def test_sr_streamed_route_on_gpu(cuda_device, bx, by, layout):
    """The streamed route on the card (Bx = 12 and 16 at degree 4: F =
    1819 and 4844), 61 x 67 px with NaN and nodata pixels, both layouts:
    identical 65535 mask, <= 1 step from the plain version; the streamed
    counter alone moves; the kernel's own shared-memory rule agrees with
    the wrapper's."""
    X, Y = _training_data(bx, by, 8000, 8)
    tm = tridge.RidgeSpectralSR(bx, by, RidgeSRConfig(degree=4),
                                device=cuda_device).fit(X, Y)
    Xc = T(_cube(bx, 61, 67, 7).reshape(bx, -1)).to(cuda_device)
    args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
    kw = {"nodata": NODATA}
    if layout == "rowmajor":
        Xc = Xc.T.contiguous()
        kw = {"valid": sr_predict.valid_pixels(Xc, NODATA)}
    reset_launch_counts()
    got = sr_predict.sr_predict_u16(Xc, *args, layout=layout, **kw)
    want = sr_predict.sr_predict_u16_reference(Xc, *args, layout=layout, **kw)
    assert launch_counts == {sr_predict.STREAMED_NAME: 1}
    _assert_u16_close(got.cpu().numpy(), want.cpu().numpy())
    from hyperres_torch.kernels._build import load_library
    lib = load_library("sr_predict")
    for k_cols in list(range(32, 8192, 32)) + [21000 // 32 * 32, 32 * 700]:
        for deg in (3, 4):
            assert bool(lib.sr_predict_streamed_fits(k_cols, deg)) == (
                sr_predict._smem_bytes_streamed(k_cols, deg) <= 232448)


@pytest.mark.gpu
def test_sr_routes_give_equal_codes_on_gpu(cuda_device):
    """The product model on the card through the resident route and,
    forced by a stand-in route rule, through the streamed route: the same
    codes bit for bit."""
    tm = _fit("product", cuda_device)
    X = T(_cube(10, 61, 67, 7).reshape(10, -1)).to(cuda_device)
    args = (tm.x_mean, tm.x_std, tm.W, tm.intercept, tm.factors)
    a = sr_predict.sr_predict_u16(X, *args, nodata=NODATA)
    rule = sr_predict.sr_route
    sr_predict.sr_route = lambda k_cols, degree: (sr_predict.STREAMED, 32)
    try:
        reset_launch_counts()
        b = sr_predict.sr_predict_u16(X, *args, nodata=NODATA)
    finally:
        sr_predict.sr_route = rule
    assert launch_counts == {sr_predict.STREAMED_NAME: 1}
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
def test_engines_on_gpu(cuda_device):
    """On the card: an 18-band model runs through engine="auto" on the
    "xla" program (no kernel counted, <= 1 step from the plain version)
    and raises under engine="pallas"; a 12-band degree-4 model runs
    through engine="auto" on the streamed kernel."""
    X, Y = _training_data(18, 9, 4000, 8)
    wide = tridge.RidgeSpectralSR(18, 9, RidgeSRConfig(degree=2),
                                  device=cuda_device).fit(X, Y)
    cube = T(_cube(18, 31, 33, 7)).to(cuda_device)
    reset_launch_counts()
    got = wide.predict_cube_u16(cube, nodata=NODATA)
    assert wide.last_engine == "xla" and not launch_counts
    want = sr_predict.sr_predict_u16_reference(
        cube.reshape(18, -1), wide.x_mean, wide.x_std, wide.W,
        wide.intercept, wide.factors, nodata=NODATA)
    _assert_u16_close(got.reshape(9, -1).cpu().numpy(), want.cpu().numpy())
    with pytest.raises(ValueError, match="engine='pallas'"):
        wide.predict_cube_u16(cube, nodata=NODATA, engine="pallas")
    X, Y = _training_data(12, 5, 8000, 8)
    big = tridge.RidgeSpectralSR(12, 5, RidgeSRConfig(degree=4),
                                 device=cuda_device).fit(X, Y)
    big.predict_cube_u16(T(_cube(12, 31, 33, 7)).to(cuda_device),
                         nodata=NODATA)
    assert big.last_engine == "pallas"
    assert launch_counts == {sr_predict.STREAMED_NAME: 1}

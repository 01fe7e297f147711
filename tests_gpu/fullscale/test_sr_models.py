"""The spectral-SR path on the card at the product's sizes: the product
ridge model (degree 3, 10 -> 32 bands) fitted on the card on 200k seeded
pixels (``scripts/torch_bench_sr_granule.py``'s ``training_data``), the
entry's model (10 -> 285), the SR kernel (``csrc/sr_predict.cu``)
against its plain version on both routes and layouts, the ``engine=``
rule past the kernel's limits, and the full-scale product's legs.

Tolerance: u16 products agree on the 65535 mask exactly and to
SR_STEPS_TOL steps elsewhere (the same f32 terms summed in another order
move a value on a rounding edge by one step)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from card_inputs import (
    SR_BX, SR_BY, SR_CHECK_HW, SR_DEGREE, SR_NODATA, SR_SHAPE, SR_STEPS_TOL,
    SR_STREAM_BX, SR_STREAM_DEGREE, counted, script,
)
from hyperres_torch.core.config import RidgeSRConfig
from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
from hyperres_torch.kernels import sr_predict as sp

pytestmark = pytest.mark.gpu

#: card fit vs CPU fit, predictions: the Gram sums run in another order
#: on the card (measured 9.7e-6 on an H100 when they were f32; the fit
#: sums and solves in f64 now, the monomials stay f32)
SR_FIT_TOL = 1e-4
#: the degree-4 check: F = 1000 monomials of 10 bands (1184 K columns,
#: 16 bands per CTA)
SR_DEG4_HW = (256, 256)
#: the streamed SR route (SR_STREAM_BX, SR_STREAM_DEGREE), checked at 256
#: x 256 px and run as a product at 1024 x 1024 px; the model past the
#: kernel's limits: 18 bands at degree 2
SR_STREAM_HW = (1024, 1024)
SR_XLA_BX, SR_XLA_DEGREE = 18, 2
N_RUNS = 3


def fit(bx, degree, X, Y, dev):
    return RidgeSpectralSR(bx, SR_BY, RidgeSRConfig(degree=degree),
                           device=dev).fit(X, Y)


@pytest.fixture(scope="module")
def sr(card):
    """The models and seeded cubes, drawn in this order from one
    generator of seed 0 (and 3, 4 for the streamed and the wide model's
    training pixels): (bx, h * w) cubes in [0, 1) with one NaN and one
    nodata pixel."""
    from hyperres_torch.entry import entry

    training_data = script("torch_bench_sr_granule").training_data
    rng = np.random.default_rng(0)

    def cube(h, w, bx=SR_BX):
        c = rng.random((bx, h, w)).astype(np.float32)
        c[3, h // 10, w // 5] = np.nan
        c[7, h // 2, w // 2] = SR_NODATA
        return torch.from_numpy(c).to(card).reshape(bx, h * w)

    Xt, Yt = training_data(rng)
    s = SimpleNamespace(model=fit(SR_BX, SR_DEGREE, Xt, Yt, card),
                        cpu_model=fit(SR_BX, SR_DEGREE, Xt, Yt, "cpu"))
    s.xq = rng.random((8192, SR_BX)).astype(np.float32)
    s.fwd, (s.x,) = entry(card)
    s.Xc = cube(*SR_CHECK_HW)
    s.deg4 = fit(SR_BX, 4, Xt, Yt, card)
    s.Xd = cube(*SR_DEG4_HW)
    Xb, Yb = training_data(np.random.default_rng(3), 50_000, SR_STREAM_BX)
    s.big = fit(SR_STREAM_BX, SR_STREAM_DEGREE, Xb, Yb, card)
    s.Xb = cube(*SR_DEG4_HW, bx=SR_STREAM_BX)
    s.Xs = cube(*SR_STREAM_HW, bx=SR_STREAM_BX)
    Xw, Yw = training_data(np.random.default_rng(4), 50_000, SR_XLA_BX)
    s.wide = fit(SR_XLA_BX, SR_XLA_DEGREE, Xw, Yw, card)
    s.Xx = cube(*SR_DEG4_HW, bx=SR_XLA_BX)
    s.rng = rng
    return s


def args(m):
    return (m.x_mean, m.x_std, m.W, m.intercept, m.factors)


def u16_close(got, want):
    """(same 65535 mask, largest step) of two u16 tensors, one slice of
    the first axis at a time in int32."""
    same, worst = True, 0
    for g, w in zip(got, want):
        g, w = g.to(torch.int32), w.to(torch.int32)
        same &= bool(((g == 65535) == (w == 65535)).all())
        worst = max(worst, int((g - w).abs().max()))
    return same, worst


def test_fit_on_card_matches_cpu_and_entry(sr):
    """The card's fit predicts within SR_FIT_TOL of the same fit on the
    CPU on 8192 seeded pixels; ``hyperres_torch.entry``'s forward gives a
    finite (8192, 285) tensor."""
    err = float((sr.model.predict(sr.xq).cpu()
                 - sr.cpu_model.predict(sr.xq)).abs().max())
    assert err <= SR_FIT_TOL, err
    y = sr.fwd(sr.x)
    assert tuple(y.shape) == (8192, 285) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("name", ["model", "fwd", "deg4", "big"])
def test_kernel_vs_plain_both_layouts(sr, name):
    """The kernel against its plain version in both layouts (validity
    from the bands with a nodata value, or from a mask): the product
    model and the entry's (By = 32, 285) at SR_CHECK_HW, degree 4 (F =
    1000) and the streamed route's model at SR_DEG4_HW: identical 65535
    mask on exactly the 2 bad pixels, <= SR_STEPS_TOL steps; the host's
    route rule equal to the source's shared-memory plans; the streamed
    model's two calls launch the streamed kernel alone."""
    from hyperres_torch.kernels._build import load_library

    m = getattr(sr, name)
    Xc = {"model": sr.Xc, "fwd": sr.Xc, "deg4": sr.Xd, "big": sr.Xb}[name]
    k_cols = sp.sr_k_columns(m.factors.cpu().numpy())
    lib = load_library("sr_predict")
    bands = lib.sr_predict_tile_bands(k_cols, m.cfg.degree)
    in_source = ((sp.RESIDENT, bands) if bands else (sp.STREAMED, 32)
                 if lib.sr_predict_streamed_fits(k_cols, m.cfg.degree)
                 else (None, 0))
    assert sp.sr_route(k_cols, m.cfg.degree) == in_source
    counts = {}
    for layout in ("cmajor", "rowmajor"):
        X = Xc if layout == "cmajor" else Xc.T.contiguous()
        kw = {"nodata": SR_NODATA} if layout == "cmajor" else {
            "valid": sp.valid_pixels(X, SR_NODATA)}
        got, c = counted(lambda: sp.sr_predict_u16(X, *args(m),
                                                   layout=layout, **kw))
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        want = sp.sr_predict_u16_reference(X, *args(m), layout=layout, **kw)
        if layout == "rowmajor":
            got, want = got.T, want.T
        same, steps = u16_close(got, want)
        assert same and steps <= SR_STEPS_TOL, (layout, steps)
        assert int((got.to(torch.int32) == 65535).sum()) == 2 * m.n_outputs
    if name == "big":
        assert sp.sr_route(k_cols, SR_STREAM_DEGREE)[0] == sp.STREAMED
        assert counts == {sp.STREAMED_NAME: 2}, counts


def test_streamed_route_gives_the_resident_codes(sr):
    """The product model at SR_CHECK_HW through the resident route and,
    forced by a stand-in route rule, the streamed route: the same codes
    bit for bit."""
    a = sp.sr_predict_u16(sr.Xc, *args(sr.model), nodata=SR_NODATA)
    rule = sp.sr_route
    sp.sr_route = lambda k_cols, degree: (sp.STREAMED, 32)
    try:
        b = sp.sr_predict_u16(sr.Xc, *args(sr.model), nodata=SR_NODATA)
    finally:
        sp.sr_route = rule
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_streamed_product(sr):
    """``predict_cube_u16`` of the streamed route's model on a
    (12, 1024, 1024) cube, once and N_RUNS times more: the streamed
    kernel alone launched each time on the ``"pallas"`` engine; the
    product within SR_STEPS_TOL of the plain version, the same mask."""
    hs, ws = SR_STREAM_HW
    cube = sr.Xs.reshape(SR_STREAM_BX, hs, ws)
    out, counts = counted(lambda: [sr.big.predict_cube_u16(
        cube, nodata=SR_NODATA) for _ in range(N_RUNS + 1)][-1])
    assert counts == {sp.STREAMED_NAME: N_RUNS + 1}, counts
    assert sr.big.last_engine == "pallas"
    assert tuple(out.shape) == (SR_BY, hs, ws)
    want = sp.sr_predict_u16_reference(sr.Xs, *args(sr.big), nodata=SR_NODATA)
    same, steps = u16_close(out.reshape(SR_BY, hs * ws), want)
    assert same and steps <= SR_STEPS_TOL, steps


def test_model_past_the_kernels_limits(sr):
    """18 bands at degree 2: ``engine="auto"`` runs the ``"xla"``
    program, launches no kernel and agrees with the plain version;
    ``engine="pallas"`` raises."""
    cube = sr.Xx.reshape(SR_XLA_BX, *SR_DEG4_HW)
    got, counts = counted(lambda: sr.wide.predict_cube_u16(cube,
                                                           nodata=SR_NODATA))
    assert sr.wide.last_engine == "xla" and not counts, counts
    want = sp.sr_predict_u16_reference(sr.Xx, *args(sr.wide),
                                       nodata=SR_NODATA)
    same, steps = u16_close(got.reshape(SR_BY, -1), want)
    assert same and steps <= SR_STEPS_TOL, steps
    with pytest.raises(ValueError):
        sr.wide.predict_cube_u16(cube, nodata=SR_NODATA, engine="pallas")


def test_sr_product_full_scale(sr):
    """``torch_bench_sr_granule``'s ``granule_cube`` and
    ``product_legs`` at SR_SHAPE, the first 5 % of pixels a nodata
    stripe: the (32, 9140, 9309) u16 product, 65535 on the stripe and
    nowhere else, the kernel launched by both calls (warm-up, timed)."""
    bench = script("torch_bench_sr_granule")
    cube = bench.granule_cube(sr.rng, *SR_SHAPE[1:])
    stripe = SR_SHAPE[1] * SR_SHAPE[2] // 20
    (legs, X, out, _), counts = counted(lambda: bench.product_legs(
        sr.model, cube, readback=False))
    del cube, X
    assert tuple(out.shape) == (SR_BY,) + SR_SHAPE[1:]
    assert out.dtype == torch.uint16
    assert counts.get(sp.KERNEL_NAME, 0) == 2, counts
    for band in out:
        nod = band.reshape(-1).to(torch.int32) == 65535
        assert bool(nod[:stripe].all()) and not bool(nod[stripe:].any())

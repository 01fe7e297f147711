"""``hyperres_torch.parallel`` on meshes of logical shards on the card,
each sharded op against its single-device counterpart, at full size. The
two-pass warps take the full-width granule onto its UTM grid on n
shards: the first of PAR_SHARDS dividing both grids' heights, else the
first dividing the UTM grid's, the GLT grid then padded by invalid
scanlines to a multiple of n; the halo is ``min_two_pass_halo``'s."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from card_inputs import counted, script
from hyperres_torch.kernels.banded import KERNEL_NAMES

pytestmark = pytest.mark.gpu

PAR_SHARDS = (3, 2, 4, 6)
#: the 2-D mesh's band shards (285 = 5 x 57)
PAR_BAND_SHARDS = 5
PAR_SR_SHARDS = 3
PAR_STAT_SHARDS = 4
PAR_CHUNK_BANDS = 32
#: sharded vs single-device warps (the shards do the same f32 arithmetic:
#: expected 0); the 2-D mesh's SRF product, whose band psum adds in
#: another order, relative to max(|v|, 1) (renormalised values beside the
#: swath's edge exceed 1); the data-parallel fit's W (f64 terms)
PAR_WARP_TOL = 1e-5
PAR_SRF_TOL = 1e-4
PAR_FIT_TOL = 1e-6
PAR_FIT_PX = 1_600_000
PAR_QS = (2.0, 50.0, 98.0)
#: the SR product's pixels and model (degree 3, 10 -> 32)
SR_PX, SR_BX, SR_BY, SR_DEGREE = 9140 * 9309, 10, 32, 3
P1, P2 = KERNEL_NAMES[1], KERNEL_NAMES[0]


def mesh(card, *shape, names=("data",)):
    from hyperres_torch.parallel import make_mesh

    return make_mesh(shape, names, devices=[card] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def warp(card, granule, ortho):
    """The granule, its raw cube on the card, the two-pass warp's operands
    onto the f32 ortho run's UTM grid, n and the halo."""
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.kernels.host import (
        prepare_glt, scanline_cstar, source_index_field,
    )
    from hyperres_torch.parallel.ops import min_two_pass_halo

    g = EmitGranule(granule.scene.emit_nc_path)
    shape = (g.raw_height, g.raw_width, g.n_bands)
    flat, valid = prepare_glt(g.glt, shape[:2])
    rows, cols = source_index_field(g.ortho_grid, ortho["f32"].res.utm_grid)
    ho, hd = flat.shape[0], rows.shape[0]
    n = next((k for k in PAR_SHARDS if ho % k == 0 and hd % k == 0), None)
    if n is None:
        n = next(k for k in PAR_SHARDS if hd % k == 0)
        pad = -ho % n
        flat = np.pad(flat, ((0, pad), (0, 0)))
        valid = np.pad(valid, ((0, pad), (0, 0)))
    halo = min_two_pass_halo(rows, flat.shape[0], n)
    cstar = scanline_cstar(rows, cols, flat.shape[0])
    ops = tuple(torch.from_numpy(a).to(card)
                for a in (flat, valid, rows, cols, cstar))
    yield SimpleNamespace(g=g, shape=shape, n=n, halo=halo, ops=ops,
                          raw=torch.from_numpy(g.read_cube()).to(card))
    g.close()


def test_sharded_two_pass_warp(card, warp):
    """``sharded_orthowarp_two_pass`` on n shards: n launches of each
    pass, within PAR_WARP_TOL of ``orthowarp_two_pass``."""
    from hyperres_torch.kernels.warp import orthowarp_two_pass
    from hyperres_torch.parallel import sharded_orthowarp_two_pass

    got, counts = counted(lambda: sharded_orthowarp_two_pass(
        warp.raw, *warp.ops, mesh(card, warp.n), halo=warp.halo))
    assert counts == {P1: warp.n, P2: warp.n}, counts
    want = orthowarp_two_pass(warp.raw, *warp.ops)
    assert float((got - want).abs().max()) <= PAR_WARP_TOL


def test_sharded_warp_and_srf_on_2d_mesh(card, warp):
    """``sharded_orthowarp_srf_2d`` on an n x PAR_BAND_SHARDS (row x band)
    mesh: n * PAR_BAND_SHARDS launches of each pass, within PAR_SRF_TOL of
    max(|v|, 1) of the warp times the S2A SRF weights
    (``torch.matmul``)."""
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.kernels.warp import orthowarp_two_pass
    from hyperres_torch.parallel import sharded_orthowarp_srf_2d
    from hyperres_torch.spectral.srf_tables import builtin_srf

    g = warp.g
    W, _, _ = build_srf_weight_matrix(np.asarray(g.wavelengths),
                                      builtin_srf("S2A"), g.good_wavelengths)
    Wt = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(card)
    m2 = mesh(card, warp.n, PAR_BAND_SHARDS, names=("row", "band"))
    got, counts = counted(lambda: sharded_orthowarp_srf_2d(
        warp.raw, *warp.ops, Wt, m2, halo=warp.halo))
    k = warp.n * PAR_BAND_SHARDS
    assert counts == {P1: k, P2: k}, counts
    ref = (orthowarp_two_pass(warp.raw, *warp.ops).reshape(
        -1, warp.shape[2]) @ Wt).reshape(got.shape)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()
                 ) <= PAR_SRF_TOL


def test_sharded_streamed_fold(card, warp):
    """``sharded_streamed_orthowarp`` (u16, PAR_CHUNK_BANDS-band chunks)
    on n shards: n launches of each pass per chunk, within PAR_WARP_TOL
    of the ortho path's single-device fold of the same granule."""
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.io.ingest import stream_cube_fold
    from hyperres_torch.ortho.pipeline import _warp_chunk_update
    from hyperres_torch.parallel import sharded_streamed_orthowarp

    got, counts = counted(lambda: sharded_streamed_orthowarp(
        warp.g.read_bands, warp.shape, *warp.ops, mesh(card, warp.n),
        halo=warp.halo, transfer="u16", chunk_bands=PAR_CHUNK_BANDS,
        depth=3))
    chunks = -(-warp.shape[2] // PAR_CHUNK_BANDS)
    assert counts == {P1: warp.n * chunks, P2: warp.n * chunks}, counts
    rows = warp.ops[2]
    utm0 = torch.full(tuple(rows.shape) + (warp.shape[2],), NO_DATA_VALUE,
                      dtype=torch.float32, device=card)
    want = stream_cube_fold(
        warp.g.read_bands, warp.shape, lambda u, p, b0: _warp_chunk_update(
            u, p, b0, *warp.ops, "cubic", "u16", "auto"), utm0,
        transfer="u16", chunk_bands=PAR_CHUNK_BANDS, depth=3,
        payload_mode=True, device=card)
    assert float((got - want).abs().max()) <= PAR_WARP_TOL


def test_sharded_sr_serving(card):
    """``sharded_sr_predict_u16(engine="pallas")`` on PAR_SR_SHARDS shards
    of the SR product's (85,084,260, 10) seeded pixels (a nodata stripe)
    with the product's model: one SR launch per shard, the codes
    bit-equal to one row-major kernel call."""
    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
    from hyperres_torch.kernels import sr_predict as sp
    from hyperres_torch.parallel.ops import sharded_sr_predict_u16

    model = RidgeSpectralSR(SR_BX, SR_BY, RidgeSRConfig(degree=SR_DEGREE),
                            device=card).fit(*script(
                                "torch_bench_sr_granule").training_data(
                                np.random.default_rng(0)))
    gen = torch.Generator(device=card).manual_seed(9)
    X = torch.rand((SR_PX, SR_BX), generator=gen, device=card)
    ok = torch.ones(SR_PX, dtype=torch.bool, device=card)
    ok[:SR_PX // 20] = False
    got, counts = counted(lambda: sharded_sr_predict_u16(
        model, X, ok, mesh(card, PAR_SR_SHARDS), engine="pallas"))
    assert counts == {sp.KERNEL_NAME: PAR_SR_SHARDS}, counts
    want = sp.sr_predict_u16(X, model.x_mean, model.x_std, model.W,
                             model.intercept, model.factors,
                             layout="rowmajor", valid=ok)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_sharded_percentile(card, bench):
    """``sharded_histogram_percentile`` at PAR_QS on one 10 m band of the
    bench scene (PAR_STAT_SHARDS shards): within 2 * range / 2048 of the
    exact ``masked_percentile``."""
    from hyperres_torch.kernels.stats import masked_percentile
    from hyperres_torch.parallel import sharded_histogram_percentile

    x = torch.from_numpy(bench.scene["s2_dn"][0].astype(np.float32)).to(card)
    mask = x > 0
    got = sharded_histogram_percentile(x, mask, PAR_QS,
                                       mesh(card, PAR_STAT_SHARDS))
    want = masked_percentile(x, mask, PAR_QS)
    span = float(x[mask].max() - x[mask].min())
    assert float((got.cpu() - want.cpu()).abs().max()) < 2 * span / 2048


def test_data_parallel_fit(card):
    """``data_parallel_ridge_fit`` on PAR_FIT_PX seeded pixels
    (PAR_STAT_SHARDS shards): W within PAR_FIT_TOL of
    ``RidgeSpectralSR.fit``'s."""
    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
    from hyperres_torch.parallel import data_parallel_ridge_fit

    Xf, Yf = script("torch_bench_sr_granule").training_data(
        np.random.default_rng(1), PAR_FIT_PX)
    cfg = RidgeSRConfig(degree=SR_DEGREE)
    multi = data_parallel_ridge_fit(
        RidgeSpectralSR(SR_BX, SR_BY, cfg, device=card), Xf, Yf,
        mesh(card, PAR_STAT_SHARDS))
    single = RidgeSpectralSR(SR_BX, SR_BY, cfg, device=card).fit(Xf, Yf)
    assert float((multi.W - single.W).abs().max()) <= PAR_FIT_TOL

"""The quantize (``csrc/quantize_u16.cu``) and SRF-synthesis
(``csrc/srf_synthesize.cu``) kernels on the card against their plain
versions. Moved from tests/test_torch_quantize_srf.py, whose CPU tests
hold the plain versions to the JAX package's quantizers and
``pallas_srf_synthesize``."""

import functools

import numpy as np
import pytest
import torch

from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import quantize as tq
from hyperres_torch.kernels import srf as tsrf
from hyperres_torch.kernels.host import build_srf_weight_matrix
from hyperres_torch.spectral.srf_tables import builtin_srf
from hyperres_torch.testing.scenes import emit_wavelength_grid

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


def _srf_case(rng, n_bands, shape):
    wl, good = emit_wavelength_grid(n_bands)
    W, _, _ = build_srf_weight_matrix(wl, builtin_srf("S2A"), good)
    cube = rng.random(shape + (n_bands,)).astype(np.float32)
    valid = rng.random(shape) > 0.3
    return cube, W.astype(np.float32), valid


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda, rng):
    """On the card: the quantize kernel == its plain version exactly
    (both forms), the SRF kernel within 1e-5 with the fill exact; each
    wrapper counts its launch."""
    x = T(_values(rng, (64, 50, 285))).to(cuda)
    reset_launch_counts()
    for form, hi in (("stats", 6.5535), ("pallas", 6.5535)):
        a = tq.quantize_u16(x, 0.0, hi, None, 65535, form=form)
        b = tq.quantize_u16_reference(x, 0.0, hi, None, 65535, form=form)
        assert torch.equal(a.to(torch.int32), b.to(torch.int32))
    cube, W, valid = _srf_case(rng, 285, shape=(40, 33))
    flat, v = T(cube.reshape(-1, 285)).to(cuda), T(valid.reshape(-1)).to(cuda)
    got = tsrf.pallas_srf_synthesize(flat, T(W).to(cuda), v)
    want = tsrf.srf_synthesize_reference(flat, T(W).to(cuda), v)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[~v], want[~v])
    assert launch_counts == {tq.KERNEL_NAME: 2, tsrf.KERNEL_NAME: 1}


#: the SRF shapes at full size: SRF_WIDE_ROWS seeded rows each, drawn in
#: this order from one generator of seed 5 (``_wide_rows``), with the
#: route the rule gives each: past the warp kernel's limits (tiled with
#: 32-row tiles, generic) and an even band count inside them (warp)
SRF_WIDE_ROWS = 200_000
SRF_WIDE_SHAPES = ((401, 20, "tiled"), (400, 20, "generic"),
                   (244, 13, "warp"))


@functools.lru_cache(maxsize=1)
def _wide_rows():
    rng = np.random.default_rng(5)
    return {(b, s): (rng.random((SRF_WIDE_ROWS, b), dtype=np.float32),
                     rng.random((b, s), dtype=np.float32),
                     rng.random(SRF_WIDE_ROWS) > 0.1)
            for b, s, _ in SRF_WIDE_SHAPES}


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,rows,route", [
    (285, 13, 1003, None), (285, 40, 1003, None), (401, 20, 1003, None),
    (400, 20, 1003, None), (244, 5, 1003, None),
    *((b, s, SRF_WIDE_ROWS, r) for b, s, r in SRF_WIDE_SHAPES)])
def test_srf_routes_match_plain_on_card(cuda, rng, b, s, rows, route):
    """Every route of the SRF kernel on the card (tiled with 64- and
    32-row tiles, S past 16, the generic kernel, the warp kernel) on
    1003 rows and on SRF_WIDE_ROWS, once from a 16-byte-aligned base and
    once from a view 3 rows in: within 3e-6 of the largest output of its
    plain version, the fill exact, one launch each under the route's own
    counter (at full size the route the rule must give); where the route
    is the warp kernel's, the generic kernel forced onto the same rows
    agrees too; the tiled kernel's shared-memory plan equals the
    wrapper's mirror."""
    if rows == SRF_WIDE_ROWS:
        x, W, v = (T(a).to(cuda) for a in _wide_rows()[(b, s)])
        assert tsrf.srf_route(b, s)[0] == route
    else:
        x = T(rng.random((rows, b)).astype(np.float32)).to(cuda)
        W = T(rng.random((b, s)).astype(np.float32)).to(cuda)
        v = T(rng.random(rows) > 0.3).to(cuda)
    forced = [None] + [tsrf.GENERIC] * (tsrf.srf_route(b, s)[0] == tsrf.WARP)
    rule = tsrf.srf_route
    for view in (slice(None), slice(3, None)):
        want = tsrf.srf_synthesize_reference(x[view], W, v[view])
        for stand_in in forced:
            name = tsrf.ROUTE_NAMES[stand_in or rule(b, s)[0]]
            if stand_in:
                tsrf.srf_route = lambda b, s: (stand_in, 0)
            try:
                reset_launch_counts()
                got = tsrf.pallas_srf_synthesize(x[view], W, v[view])
            finally:
                tsrf.srf_route = rule
            assert launch_counts == {name: 1}
            assert float((got - want).abs().max()) <= 3e-6 * float(
                want.max())
            assert bool((got[~v[view]] == -9999.0).all())
    from hyperres_torch.kernels._build import load_library
    lib = load_library("srf_synthesize")
    for r in (2, 1):
        assert (lib.srf_tiled_smem_bytes(b, s, r)
                == tsrf._tiled_smem_bytes(b, s, r))

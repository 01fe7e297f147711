"""The 10 m apply kernel (``csrc/upsample_apply.cu``) on the card against
the eager chain it replaces in the fused plan: the valid-mass-renormalised
bilinear upsample (``separable_resample_fast``), the mask, the fitted
mapping (``apply_params``) and the clamp (``fused._map_10m``), bit for
bit with NaN in the same places; and the plan taking it once a call."""

import numpy as np
import pytest
import torch

from hyperres_torch.core.crs import CRS
from hyperres_torch.core.grid import Grid
from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.fusion import fused as tfused
from hyperres_torch.kernels import upsample_apply as ua
from hyperres_torch.kernels.warp import separable_resample_fast
from hyperres_torch.spectral.srf_tables import builtin_srf
from hyperres_torch.testing.bench_scene import (emit_wavelength_grid,
                                                generate_scene)
from hyperres_torch.utils import profiling

T = torch.from_numpy
H60, W60 = 37, 45
#: 10 m grids against the 60 m one, by their offsets (m) and sizes:
#: "cut" reaches past the 60 m extent on all four sides (cin ranges cut
#: rows and columns; taps fall outside the source), "inside" lies within
#: it at offsets that are no multiple of 60 m
GRIDS = {"cut": (-130.0, 70.0, H60 * 6 + 18, W60 * 6 + 30),
         "inside": (70.0, -130.0, H60 * 6 - 40, W60 * 6 - 25)}


def _up_fast(grid: str):
    """``up_fast`` of a real 60 m -> 10 m pair of UTM grids, as the plan
    builds it (``fused._fusion_matrices``)."""
    dx, dy, h10, w10 = GRIDS[grid]
    crs = CRS.utm(33, True)
    emit = Grid(crs, 500_000.0, 5_000_040.0, 60.0, 60.0, W60, H60)
    s2 = Grid(crs, 500_000.0 + dx, 5_000_040.0 + dy, 10.0, 10.0, w10, h10)
    wl, good = emit_wavelength_grid(285)
    up = tfused._fusion_matrices(emit, s2, wl, good, "S2A", "box")["up_fast"]
    assert up is not None and up[0][:2] == ("bilin", 6) \
        and up[1][:2] == ("bilin", 6)
    return up


def _inputs(rng, dev):
    """Stretched-like 60 m RGB with a swath edge of invalid pixels and
    NaN / +-inf at some valid ones."""
    x = rng.uniform(-0.05, 1.05, (H60, W60, 3)).astype(np.float32)
    r, c = np.mgrid[:H60, :W60]
    valid = (c > 4 + 0.4 * r) & (rng.random((H60, W60)) > 0.05)
    x[~valid] = rng.choice([np.nan, 7.0, -9999.0], size=(~valid).sum())[
        :, None]
    vi = np.flatnonzero(valid)
    bad = rng.choice(vi, 12, replace=False)
    for k, v in zip(bad, [np.nan, np.inf, -np.inf] * 4):
        x.reshape(-1, 3)[k, k % 3] = v
    return T(x).to(dev), T(valid).to(dev)


def _coeffs(case: str, rng, dev):
    if case == "ot_poly":
        c = rng.normal(0.0, 0.6, (3, 5)).astype(np.float32)
        c[:, -2] += 1.0
    elif case == "ot_poly_degree6":   # the kernel's loop over shared memory
        c = rng.normal(0.0, 0.3, (3, 7)).astype(np.float32)
        c[:, -2] += 1.0
    elif case == "ot_poly_identity":
        c = np.zeros((3, 5), np.float32)
        c[:, -2] = 1.0
    elif case == "linear":
        c = np.array([[1.3, -0.1], [0.8, 0.05], [1.05, 0.2]], np.float32)
    else:   # linear_identity
        c = np.array([[1.0, 0.0]] * 3, np.float32)
    return T(c).to(dev)


def _eager(x, valid, up_fast, method, params):
    sim10 = separable_resample_fast(x, *up_fast, fill=np.nan,
                                    valid_mask=valid)
    return tfused._map_10m(
        sim10, lambda v, m: tfused.apply_params(method, params, v))


def _assert_same(got, want):
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    zero = torch.zeros((), device=got.device)
    assert torch.equal(torch.where(nan, zero, got),
                       torch.where(nan, zero, want))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", ["ot_poly", "ot_poly_identity",
                                  "ot_poly_degree6", "linear",
                                  "linear_identity"])
def test_kernel_matches_eager_chain_bit_for_bit(cuda_device, rng, grid,
                                                case):
    """The kernel's product equals the eager chain's bit for bit, NaN in
    the same places: degree-4, identity and degree-6 polynomials,
    ``linear`` and its identity, on 60 m -> 10 m specs whose cin ranges
    cut rows and columns, with a swath edge and non-finite values at
    valid pixels. One launch a call."""
    up = _up_fast(grid)
    x, valid = _inputs(rng, cuda_device)
    params = _coeffs(case, rng, cuda_device)
    method = "ot_poly" if case.startswith("ot_poly") else "linear"
    assert ua.takes_kernel(cuda_device, up, method, params.shape)
    reset_launch_counts()
    got = ua.upsample_apply(x, valid, *up, params)
    assert launch_counts == {ua.KERNEL_NAME: 1}
    want = _eager(x, valid, up, method, params)
    assert got.shape == want.shape == (up[0][4], up[1][4], 3)
    _assert_same(got, want)
    nan = torch.isnan(got).all(-1)
    assert 0.2 < float(nan.float().mean()) < 0.9
    if grid == "cut":
        lo, hi = up[0][6:8]
        assert lo > 0 and hi < up[0][4]
        assert bool(nan[:lo].all()) and bool(nan[hi:].all())
    if case == "ot_poly":   # the clamp acts at both ends
        assert bool((got == 0).any()) and bool((got == 1).any())


@pytest.mark.gpu
def test_kernel_wrapper_refuses_bad_inputs(cuda_device, rng):
    """A non-contiguous input, a wrong dtype and a CPU tensor raise
    before any launch."""
    up = _up_fast("cut")
    x, valid = _inputs(rng, cuda_device)
    params = _coeffs("ot_poly", rng, cuda_device)
    reset_launch_counts()
    strided = torch.empty((W60, H60, 3), device=cuda_device).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ua.upsample_apply(strided, valid, *up, params)
    with pytest.raises(TypeError, match="float32"):
        ua.upsample_apply(x.double(), valid, *up, params)
    with pytest.raises(TypeError, match="bool"):
        ua.upsample_apply(x, valid.to(torch.uint8), *up, params)
    with pytest.raises(ValueError, match="CUDA"):
        ua.upsample_apply(x.cpu(), valid.cpu(), *up, params.cpu())
    assert launch_counts == {}


@pytest.fixture(scope="module")
def small_scene():
    return generate_scene(0.05, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ot_poly", "linear"])
def test_plan_takes_kernel_once_a_call(cuda_device, small_scene, method,
                                       monkeypatch):
    """A plan call on the card launches the kernel once and counts
    ``apply.kernel`` once in its ``fused.apply`` span; its ``fused_10m``
    equals that of the same call on the eager ops (the dispatch rule
    forced off), bit for bit."""
    sc = small_scene
    plan = tfused.FusedOrthoFusionPlan(
        sc["ortho_grid"], sc["utm60"], sc["s2_grid"], sc["raw"].shape[:2],
        sc["glt"], sc["wavelengths"], sc["good_mask"], s2_nodata=65535.0,
        s2_scale=1e-4, srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]),
        fusion_method=method, device=cuda_device)
    raw = T(sc["raw"]).to(cuda_device)
    s2 = plan.prepare_s2(sc["s2_dn"])
    profiling.clear()
    reset_launch_counts()
    with profiling.tracing():
        outs = [plan(raw, s2, plan.generator(7)) for _ in range(2)]
    assert launch_counts.get(ua.KERNEL_NAME) == 2
    recs = profiling.records()
    applies = [r for r in recs if r.name == "fused.apply"]
    assert [r.counts.get(ua.APPLY_COUNTER) for r in applies] == [1, 1]
    assert sum(r.counts.get(ua.APPLY_COUNTER, 0) for r in recs) == 2
    profiling.clear()
    monkeypatch.setattr(tfused, "takes_kernel", lambda *a: False)
    reset_launch_counts()
    eager = plan(raw, s2, plan.generator(7))
    assert ua.KERNEL_NAME not in launch_counts
    assert torch.equal(outs[0]["coeffs"], eager["coeffs"])
    for out in outs:
        _assert_same(out["fused_10m"], eager["fused_10m"])

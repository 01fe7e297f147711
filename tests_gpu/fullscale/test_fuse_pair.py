"""``fuse_pair`` (``hyperres_torch.pipeline``) on the default device, on
the scale-1.0 bench scene's S2 stack and UTM cube (the default plan's, on
the card), by the fused and the phase-wise engine (10-30 s a call)."""

import warnings

import numpy as np
import pytest
import torch

import bench_torch

pytestmark = pytest.mark.gpu

EXPECT_FUSED = (9140, 9309, 3)
#: fuse_pair's runs: (fusion_method, engine, synth_method)
FUSE_RUNS = (("ot_poly", "fused", "srf"), ("ot_affine", "fused", "srf"),
             ("linear", "fused", "srf"), ("histogram", "fused", "srf"),
             ("ot_poly", "phases", "srf"), ("linear", "phases", "srf"),
             ("histogram", "phases", "srf"), ("ot_poly", "fused", "box"))
#: fuse_pair's fused product against its phase-wise product of the same
#: method (the reference's fused_psnr_gate)
FUSED_PSNR_GATE = 40.0


@pytest.fixture(scope="module")
def fuse(bench, base):
    """(method, engine, synth) -> ``fuse_pair``'s result, run once each
    on the default plan's UTM cube."""
    from hyperres_torch.pipeline import fuse_pair

    sc, utm, done = bench.scene, base[0]["utm_cube"], {}

    def run(key):
        if key not in done:
            method, engine, synth = key
            with warnings.catch_warnings():
                # no measured SRF table is imported here: the resolver
                # says that it takes the parametric model
                warnings.filterwarnings("ignore", message=".*PARAMETRIC.*")
                done[key] = fuse_pair(
                    utm, sc["wavelengths"], sc["utm60"], sc["s2_dn"],
                    sc["s2_grid"], good_mask=sc["good_mask"], s2_scale=1e-4,
                    s2_nodata=65535.0, fusion_method=method, engine=engine,
                    synth_method=synth)
            torch.cuda.synchronize()
        return done[key]
    return run


@pytest.mark.parametrize("method,engine,synth", FUSE_RUNS)
def test_fuse_pair_gates(bench, base, card, fuse, method, engine, synth):
    """Each run: the engine it was asked for, EXPECT_FUSED, finite
    fraction > 0.3 and max <= 1; the parametric methods meet phase 5's
    pipeline PSNR / SAM gates against the default plan's
    ``s2_reference_10m``."""
    res = fuse((method, engine, synth))
    assert res.info["engine"] == engine
    fused = torch.from_numpy(res.fused_10m).to(card)
    assert tuple(fused.shape) == EXPECT_FUSED
    gates = bench_torch.GATES
    if method == "histogram":   # no parametric map
        finite_frac = float(torch.isfinite(fused).all(dim=-1)
                            .to(torch.float32).mean())
        fmax = float(torch.nan_to_num(fused, nan=-1.0).max())
    else:
        target = bench.plan.s2_reference_10m(base[0]["utm_cube"], bench.s2)
        coeffs = torch.from_numpy(res.coeffs.astype(np.float32)).to(card)
        finite_frac, fmax, psnr_db, _, sam_rad = (
            bench_torch.accuracy_metrics(fused, target, coeffs, method))
        assert psnr_db >= gates["psnr_db_min"], psnr_db
        assert sam_rad <= gates["sam_rad_max"], sam_rad
    assert finite_frac > gates["finite_frac_min"] and fmax <= gates["max_le"]


@pytest.mark.parametrize("method", ["ot_poly", "linear", "histogram"])
def test_fused_engine_matches_phases(card, fuse, method):
    """The fused and the phase-wise product of one method: PSNR >=
    FUSED_PSNR_GATE over the pixels finite in both."""
    a, b = (torch.from_numpy(fuse((method, e, "srf")).fused_10m).to(card)
            for e in ("fused", "phases"))
    both = torch.isfinite(a).all(dim=-1) & torch.isfinite(b).all(dim=-1)
    d = torch.where(both[..., None], a - b, torch.zeros((), device=card))
    mse = float(torch.sum(d.double() ** 2) / (both.sum() * 3))
    psnr_db = float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)
    assert psnr_db >= FUSED_PSNR_GATE, psnr_db

#!/usr/bin/env python3
"""SRF parametric-vs-measured sensitivity analysis on the PyTorch port,
the counterpart of ``scripts/srf_sensitivity.py``.

The default SRF is the parametric super-Gaussian model. This bounds the
consequence: perturb the parametric model within realistic
parametric-vs-measured divergence bounds (band centre +-2 nm, FWHM
+-5 %, shoulder exponent 3..5), propagate each of the 26 perturbations
through

  1. SRF band synthesis (the direct pseudo-S2 band values), and
  2. the full OT + polynomial fusion (the port's ``FusedFusionPlan`` on
     the device, its OT draw from the plan's own generator),

and print the worst-case deltas as the JAX script's JSON, plus
``device`` and ``power_limit_w`` on a card. The scene is the JAX
script's: the analytic world at 60 m with sensor noise 0.002
(``default_rng(0)``), and a fixed "real" S2 at 10 m made through the
baseline curves. The synthesis deltas (``flat @ W``) are computed with
NumPy on the host, as the JAX script computes them.

    python3 scripts/torch_srf_sensitivity.py [--h60 96] [--w60 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N_BANDS = 285
BANDS = ["B2", "B3", "B4"]
NOISE = 0.002
#: (centre shift nm, FWHM factor, exponent); (0, 1, 4) is the baseline
D_CENTRE_NM = (-2.0, 0.0, 2.0)
FWHM_FACTORS = (0.95, 1.0, 1.05)
EXPONENTS = (3.0, 4.0, 5.0)
BASELINE = (0.0, 1.0, 4.0)

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def log(m):
    print(m, file=sys.stderr, flush=True)


def perturb_srf(srf, d_centre_nm=0.0, fwhm_factor=1.0):
    """Shift each band's wavelength axis by d_centre_nm and scale its
    width about the response-weighted centre by fwhm_factor (the
    response samples are untouched — this transforms the support).
    Copy of ``scripts/srf_sensitivity.py:36``, with ``np.trapezoid``
    where NumPy has it (``np.trapz``, its older name, elsewhere)."""
    out = {}
    for b, (lam, resp) in srf.items():
        c = float(_trapezoid(lam * resp, lam) / _trapezoid(resp, lam))
        lam2 = c + (lam - c) * fwhm_factor + d_centre_nm
        out[b] = (lam2, resp)
    return out


def make_scene(h60: int, w60: int) -> dict:
    """The JAX script's scene (``srf_sensitivity.py:62-100``): the 60 m
    cube, the 10 m "real" S2 RGB through the baseline curves, the grids,
    the wavelength grid and its good-band mask, and the baseline
    synthesis matrix ``Wb``."""
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.spectral.srf_tables import builtin_srf
    from hyperres_torch.testing import scenes

    wl, good = scenes.emit_wavelength_grid(N_BANDS)
    spectra = scenes.endmember_spectra(wl)
    utm = CRS.utm(33, True)
    emit_grid = Grid(utm, 399960.0, 5800020.0, 60.0, 60.0, w60, h60)
    s2_grid = Grid(utm, 399960.0, 5800020.0, 10.0, 10.0, w60 * 6, h60 * 6)
    X, Y = np.meshgrid(*emit_grid.pixel_center_coords())
    ab = scenes.abundance_maps(X, Y).astype(np.float32)
    rng = np.random.default_rng(0)
    cube = np.clip(ab @ spectra.astype(np.float32)
                   + rng.normal(scale=NOISE, size=(h60, w60, N_BANDS)).astype(
                       np.float32), 0.005, 0.95).astype(np.float32)
    Wb = np.asarray(build_srf_weight_matrix(
        wl, builtin_srf("S2A", bands=BANDS), good)[0])
    X2, Y2 = np.meshgrid(*s2_grid.pixel_center_coords())
    ab2 = scenes.abundance_maps(X2, Y2).astype(np.float32)
    band_spec = (spectra @ Wb).astype(np.float32)
    s2rgb = np.clip(ab2 @ band_spec, 0.0, 1.0).astype(np.float32)
    return {"cube": cube, "s2rgb": s2rgb, "emit_grid": emit_grid,
            "s2_grid": s2_grid, "wl": wl, "good": good, "Wb": Wb}


def run_fusion(scene: dict, srf, device) -> np.ndarray:
    """The fused 10 m product of the port's ``FusedFusionPlan`` under
    ``srf`` (degree 4, 2000 OT samples; the plan's seeded generator)."""
    from hyperres_torch.core.config import OTConfig, PolyFusionConfig
    from hyperres_torch.fusion.fused import FusedFusionPlan

    cfg = PolyFusionConfig(degree=4, ot=OTConfig(n_samples=2000))
    plan = FusedFusionPlan(scene["emit_grid"], scene["s2_grid"], scene["wl"],
                           scene["good"], config=cfg, srf=srf, device=device)
    return plan(scene["cube"], scene["s2rgb"])["fused_10m"].cpu().numpy()


def sweep(scene: dict, device) -> dict:
    """The JAX script's summary over the 26 perturbations of the
    baseline, with its rows (``srf_sensitivity.py:114-164``)."""
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.spectral.srf_tables import builtin_srf

    log("baseline fusion ...")
    fused_base = run_fusion(scene, builtin_srf("S2A", bands=BANDS), device)
    flat = scene["cube"].reshape(-1, N_BANDS)
    syn_b = flat @ scene["Wb"]
    rows = []
    worst_band, worst_fused_rms, worst_fused_psnr = 0.0, 0.0, np.inf
    for dc, ff, expo in itertools.product(D_CENTRE_NM, FWHM_FACTORS,
                                          EXPONENTS):
        if (dc, ff, expo) == BASELINE:
            continue
        srf_p = perturb_srf(builtin_srf("S2A", bands=BANDS, exponent=expo),
                            dc, ff)
        Wp = np.asarray(build_srf_weight_matrix(scene["wl"], srf_p,
                                                scene["good"])[0])
        d = np.abs(flat @ Wp - syn_b)
        band_max = float(d.max())
        band_rel = float((d / np.maximum(syn_b, 1e-3)).max())
        fused_p = run_fusion(scene, srf_p, device)
        m = np.isfinite(fused_p).all(-1) & np.isfinite(fused_base).all(-1)
        df = fused_p[m] - fused_base[m]
        rms = float(np.sqrt((df ** 2).mean()))
        mx = float(np.abs(df).max())
        psnr = float(10 * np.log10(1.0 / max((df ** 2).mean(), 1e-12)))
        rows.append({
            "d_centre_nm": dc, "fwhm_factor": ff, "exponent": expo,
            "band_abs_max": round(band_max, 5),
            "band_rel_max": round(band_rel, 4),
            "fused_rms": round(rms, 5), "fused_abs_max": round(mx, 4),
            "fused_psnr_db_vs_baseline": round(psnr, 1),
        })
        worst_band = max(worst_band, band_max)
        worst_fused_rms = max(worst_fused_rms, rms)
        worst_fused_psnr = min(worst_fused_psnr, psnr)
        log(f"dc={dc:+.0f}nm fwhm x{ff:.2f} p={expo:.0f}: "
            f"band max {band_max:.4f} ({band_rel * 100:.2f}%), fused "
            f"rms {rms:.5f} max {mx:.4f} ({psnr:.1f} dB)")
    return {
        "perturbations": len(rows),
        "worst_band_abs_delta_reflectance": round(worst_band, 5),
        "worst_fused_rms_stretched": round(worst_fused_rms, 5),
        "worst_fused_psnr_db_vs_baseline": round(worst_fused_psnr, 1),
        "rows": rows,
    }


def main(argv=None) -> dict:
    """Prints the summary as JSON and returns it."""
    from hyperres_torch.device import resolve_device
    from hyperres_torch.utils.profiling import card_info

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h60", type=int, default=96)
    ap.add_argument("--w60", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    summary = sweep(make_scene(args.h60, args.w60), dev)
    if dev.type == "cuda":
        summary.update(card_info(dev))
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()

"""Granule parity harness (``hyperres/verify.py``).

Runs the shipped fast path and the reference-semantics exact path side
by side on the same EMIT granule and S2 stack and writes a markdown +
JSON report:

  1. reader -> GLT ortho onto the S2-anchored UTM grid, twice:
     - shipped: the two-pass scanline warp (the scanline CUDA kernel);
     - exact:   the tap-loop warp (gdalwarp-semantics gathers,
                emit_proj.py:876-940 / nc_to_envi :563-1300)
     -> cube PSNR / SAM / valid-mask agreement between the two.
  2. SRF synthesis + OT/poly fusion to 10 m, twice:
     - shipped: the fused engine on the shipped cube;
     - exact:   the phase-wise engine on the tap-loop cube
     -> fused-product PSNR / SAM + polynomial-coefficient deltas.
  3. The bench-style audit: the shipped fused product against the
     method-ideal target built from the real S2 alone
     (``FusedFusionPlan.s2_reference_10m``), with the fitted map applied
     to the target so the OT shrinkage cancels -> pipeline PSNR / SAM.

The JSON keys and the report text are the reference's, so the two
packages' reports on one pair can be diffed.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from .core.config import OrthoConfig
from .device import resolve_device
from .fusion.fused import FusedFusionPlan
from .io import envi
from .io.tiff import TiffReader
from .kernels.lstsq import polyval_channels
from .kernels.stats import cube_psnr_sam
from .ortho import orthorectify_granule
from .pipeline import fuse_pair, psnr, sam

__all__ = ["verify_granule", "VerifyResult"]


@dataclass
class VerifyResult:
    report_path: Path
    json_path: Path
    metrics: Dict = field(default_factory=dict)
    passed: bool = True


def _cube_metrics(a: torch.Tensor, b: torch.Tensor,
                  fill: float = -9999.0) -> Dict:
    """PSNR / SAM / mask agreement between two product cubes, computed
    where the cubes are (only scalars come back)."""
    vf, p, s = (float(v) for v in cube_psnr_sam(a, b, fill=fill, erode=2))
    agree = ((a[..., 0] != fill) == (b[..., 0] != fill)).to(
        torch.float32).mean()
    return {"psnr_db": round(p, 2), "sam_rad": round(s, 5),
            "valid_frac": round(vf, 4),
            "mask_agreement": round(float(agree), 6)}


def _fused_metrics(fa: np.ndarray, fb: np.ndarray) -> Dict:
    va = np.isfinite(fa).all(-1)
    vb = np.isfinite(fb).all(-1)
    both = va & vb
    if both.sum() == 0:
        return {"psnr_db": None, "sam_rad": None, "mask_agreement": 0.0}
    return {
        "psnr_db": round(psnr(fa[both], fb[both]), 2),
        "sam_rad": round(sam(fa[both], fb[both]), 5),
        "mask_agreement": round(float((va == vb).mean()), 6),
    }


def verify_granule(
    emit_nc_path: Union[str, Path],
    s2_stack_tif: Union[str, Path],
    out_dir: Union[str, Path],
    *,
    mask_file: Union[str, Path, None] = None,
    s2_scale: Optional[float] = 1e-4,
    cube_psnr_gate: float = 40.0,
    fused_psnr_gate: float = 40.0,
    pipeline_psnr_gate: float = 40.0,
    device=None,
) -> VerifyResult:
    """Run the shipped-vs-exact parity harness on one EMIT/S2 pair
    (``verify.py:85``).

    Gates are deliberately loose defaults (the shipped two-pass warp
    deviates from the exact taploop by O(shear^2), sub-1e-3 reflectance
    on EMIT geometry); override per call. ``device``: default the
    current CUDA device."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    metrics: Dict = {"inputs": {"emit_nc": str(emit_nc_path),
                                "s2_stack": str(s2_stack_tif)}}

    # --- stage 1: ortho, shipped vs exact ---
    res_a = orthorectify_granule(
        emit_nc_path, out_dir / "shipped", s2_stack_tif,
        mask_file=mask_file, keep_device_cube=True,
        config=OrthoConfig(save_geotiffs=False, write_xml=False,
                           warp_kernel="two_pass"), device=dev)
    res_b = orthorectify_granule(
        emit_nc_path, out_dir / "exact", s2_stack_tif,
        mask_file=mask_file, keep_device_cube=True,
        config=OrthoConfig(save_geotiffs=False, write_xml=False,
                           warp_kernel="taploop"), device=dev)

    def _cube_of(res) -> torch.Tensor:
        if res.device_cube is not None:
            return res.device_cube
        r = envi.EnviReader(res.data_envi_bin.with_suffix(".hdr"))
        return torch.from_numpy(r.read().astype(np.float32)).to(dev)

    cube_a = _cube_of(res_a)
    cube_b = _cube_of(res_b)
    metrics["ortho_shipped_backend"] = res_a.info["out"].get(
        "warp_backend", "two_pass")
    metrics["cube_shipped_vs_exact"] = _cube_metrics(cube_a, cube_b)

    # --- stage 2: fusion, shipped vs exact ---
    with TiffReader(s2_stack_tif) as t:
        stack = t.read().astype(np.float32)
        s2_grid = t.grid
        s2_nodata = t.nodata
    wl = res_a.wavelengths
    good = res_a.good_mask
    kw = dict(s2_scale=s2_scale, s2_nodata=s2_nodata, device=dev)
    fa = fuse_pair(cube_a, wl, res_a.utm_grid, stack,
                   s2_grid, good_mask=good, engine="fused", **kw)
    fb = fuse_pair(cube_b, wl, res_b.utm_grid, stack,
                   s2_grid, good_mask=good, engine="phases", **kw)
    del cube_b
    metrics["fused_shipped_vs_exact"] = _fused_metrics(
        fa.fused_10m, fb.fused_10m)
    metrics["coeffs_shipped"] = np.round(fa.coeffs, 4).tolist()
    metrics["coeffs_exact"] = np.round(fb.coeffs, 4).tolist()
    metrics["coeffs_max_abs_delta"] = round(
        float(np.abs(fa.coeffs - fb.coeffs).max()), 5)

    # --- stage 3: bench-style audit of the shipped product ---
    plan = FusedFusionPlan(
        res_a.utm_grid, s2_grid, wl, good,
        s2_nodata=s2_nodata, s2_scale=s2_scale, device=dev)
    s2rgb = plan.prepare_s2(stack)
    target_t = plan.s2_reference_10m(cube_a, s2rgb)
    del s2rgb
    mapped = torch.clamp(polyval_channels(
        torch.from_numpy(fa.coeffs.astype(np.float32)).to(dev),
        torch.nan_to_num(target_t)), 0.0, 1.0).cpu().numpy()
    target = target_t.cpu().numpy()
    del target_t
    both = (np.isfinite(fa.fused_10m).all(-1)
            & np.isfinite(target).all(-1))
    mapped = np.where(both[..., None], mapped, np.nan)
    metrics["pipeline_audit"] = _fused_metrics(fa.fused_10m, mapped)
    metrics["method_audit"] = _fused_metrics(
        fa.fused_10m, np.where(both[..., None], target, np.nan))

    metrics["total_seconds"] = round(time.perf_counter() - t0, 2)

    # --- gates + report ---
    checks = {
        "cube_psnr": (metrics["cube_shipped_vs_exact"]["psnr_db"],
                      cube_psnr_gate),
        "fused_psnr": (metrics["fused_shipped_vs_exact"]["psnr_db"],
                       fused_psnr_gate),
        "pipeline_psnr": (metrics["pipeline_audit"]["psnr_db"],
                          pipeline_psnr_gate),
    }
    passed = all(v is not None and v >= g for v, g in checks.values())
    metrics["gates"] = {k: {"value": v, "gate": g,
                            "pass": bool(v is not None and v >= g)}
                        for k, (v, g) in checks.items()}
    metrics["passed"] = passed

    json_path = out_dir / "verify_granule.json"
    json_path.write_text(json.dumps(metrics, indent=1))

    c = metrics["cube_shipped_vs_exact"]
    f = metrics["fused_shipped_vs_exact"]
    pa = metrics["pipeline_audit"]
    ma = metrics["method_audit"]
    lines = [
        "# Granule parity report",
        "",
        f"- EMIT: `{emit_nc_path}`",
        f"- S2 stack: `{s2_stack_tif}`",
        f"- shipped warp backend: {metrics['ortho_shipped_backend']}",
        f"- wall clock: {metrics['total_seconds']} s",
        "",
        "## Shipped vs exact (taploop / phase-wise reference path)",
        "",
        "| stage | PSNR (dB) | SAM (rad) | mask agreement |",
        "|---|---|---|---|",
        (f"| UTM 285-band cube | {c['psnr_db']} | {c['sam_rad']} | "
         f"{c['mask_agreement']} |"),
        (f"| fused 10 m product | {f['psnr_db']} | {f['sam_rad']} | "
         f"{f['mask_agreement']} |"),
        "",
        f"coeff max |delta|: {metrics['coeffs_max_abs_delta']}",
        "",
        "## Audit vs method-ideal target (bench.py contract)",
        "",
        f"- pipeline PSNR {pa['psnr_db']} dB / SAM {pa['sam_rad']} rad",
        f"- method PSNR {ma['psnr_db']} dB (entropic-OT shrinkage "
        "included; ~33 dB expected, see docs/BENCHMARK.md)",
        "",
        "## Gates",
        "",
    ]
    for k, g in metrics["gates"].items():
        lines.append(f"- {k}: {g['value']} vs gate {g['gate']} -> "
                     f"{'PASS' if g['pass'] else 'FAIL'}")
    lines += ["", f"**{'PASS' if passed else 'FAIL'}**", ""]
    report_path = out_dir / "verify_granule.md"
    report_path.write_text("\n".join(lines))

    return VerifyResult(report_path=report_path, json_path=json_path,
                        metrics=metrics, passed=passed)

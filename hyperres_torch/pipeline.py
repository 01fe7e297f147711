"""The EMIT x Sentinel-2 4-phase fusion (``hyperres/pipeline.py``).

- :func:`fuse_pair`: the 4-phase fusion (demo cell 81): band synthesis
  at 60 m, the real S2 downsampled to the EMIT grid, the shared stretch
  and the fit of ``fusion_method``, the bilinear upsample and the fit
  applied at 10 m; by the fused plan (``engine="fused"``) or phase by
  phase (``engine="phases"``);
- :func:`psnr` / :func:`sam`: the parity metrics.

``run_pair_pipeline`` (the full per-pair run with tiling and artifacts)
is not part of this module yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core.config import PolyFusionConfig
from .core.constants import NO_DATA_VALUE
from .core.grid import Grid
from .device import resolve_device
from .fusion.fused import FUSED_METHODS, FusedFusionPlan, FusedUnsupported
from .fusion.histogram import histogram_match_rgb
from .fusion.linear import calibrate_linear
from .fusion.ot import apply_affine, apply_poly, fit_ot_affine, fit_ot_poly
from .kernels.host import build_box_weight_matrix, build_srf_weight_matrix
from .kernels.srf import srf_synthesize
from .kernels.stats import shared_percentile_stretch
from .kernels.warp import resample_to_grid
from .spectral.srf_tables import (
    describe_srf_source, load_srf, warn_if_parametric_srf,
)


# ---------------------------------------------------------------------------
# Metrics (the BASELINE.md parity measures)
# ---------------------------------------------------------------------------

def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m = np.isfinite(a) & np.isfinite(b)
    mse = np.mean((a[m] - b[m]) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def sam(a: np.ndarray, b: np.ndarray) -> float:
    """Mean spectral angle (radians) between (..., B) spectra."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, dtype=np.float64).reshape(-1, b.shape[-1])
    m = np.isfinite(a).all(1) & np.isfinite(b).all(1)
    a, b = a[m], b[m]
    num = (a * b).sum(1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12
    return float(np.mean(np.arccos(np.clip(num / den, -1.0, 1.0))))


# ---------------------------------------------------------------------------
# 4-phase fusion (demo cell 81)
# ---------------------------------------------------------------------------

@dataclass
class FusionResult:
    fused_10m: np.ndarray          # (H10, W10, 3) in [0, 1]
    matched_60m: np.ndarray        # (H60, W60, 3)
    coeffs: np.ndarray             # (3, deg+1)
    emit_grid_60m: Grid
    s2_grid_10m: Grid
    info: Dict = field(default_factory=dict)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fuse_pair_fused(
    emit_cube_hwb,
    emit_wavelengths,
    emit_grid: Grid,
    s2_stack_bhw,
    s2_grid: Grid,
    *,
    good_mask,
    s2_rgb_band_idx,
    s2_scale,
    s2_nodata,
    config: PolyFusionConfig,
    platform: str,
    synth_method: str,
    fusion_method: str,
    device: torch.device,
    plan=None,
    warm_run: bool = False,
) -> FusionResult:
    """Fused-engine fuse_pair (``pipeline.py:90``): the four phases by
    :class:`FusedFusionPlan` on ``device``. ``plan`` lets callers reuse a
    prebuilt plan (and a device-resident emit cube); ``warm_run`` runs
    the plan twice and reports the second run's time too. Nothing is
    compiled at the first call, so ``fused_program_includes_compile`` is
    false; the stage times are taken after a device synchronise."""
    t0 = time.perf_counter()
    if plan is None:
        plan = FusedFusionPlan(
            emit_grid, s2_grid, np.asarray(emit_wavelengths), good_mask,
            platform=platform, synth_method=synth_method,
            fusion_method=fusion_method, config=config,
            s2_nodata=s2_nodata, s2_scale=s2_scale, device=device)
    s2rgb = plan.prepare_s2(s2_stack_bhw, s2_rgb_band_idx)
    cube = torch.as_tensor(emit_cube_hwb, dtype=torch.float32).to(device)
    _sync(device)
    t1 = time.perf_counter()
    out = plan(cube, s2rgb)
    _sync(device)
    t2 = time.perf_counter()
    stages = {
        "plan_build_s": round(t1 - t0, 4),
        "fused_program_s": round(t2 - t1, 4),
        "fused_program_includes_compile": False,
    }
    if warm_run:
        t3 = time.perf_counter()
        out = plan(cube, s2rgb)
        _sync(device)
        stages["fused_program_steady_s"] = round(time.perf_counter() - t3,
                                                 4)
    t4 = time.perf_counter()
    fused = out["fused_10m"].cpu().numpy()
    matched = out["matched_60m"].cpu().numpy()
    coeffs = out["coeffs"].cpu().numpy().astype(np.float64)
    n_valid = int(out["n_valid_60m"])
    stages["fetch_s"] = round(time.perf_counter() - t4, 4)
    return FusionResult(
        fused_10m=fused,
        matched_60m=matched,
        coeffs=coeffs,
        emit_grid_60m=emit_grid,
        s2_grid_10m=s2_grid,
        info={
            "stages": stages,
            "n_valid_60m": n_valid,
            "degree": config.degree,
            "fusion_method": fusion_method,
            "engine": "fused",
            "srf_source": describe_srf_source(platform),
        },
    )


def fuse_pair(
    emit_cube_hwb: np.ndarray,
    emit_wavelengths: np.ndarray,
    emit_grid: Grid,
    s2_stack_bhw: np.ndarray,
    s2_grid: Grid,
    *,
    good_mask: Optional[np.ndarray] = None,
    s2_rgb_band_idx: Tuple[int, int, int] = (0, 1, 2),  # B2, B3, B4 order
    s2_scale: Optional[float] = None,
    s2_nodata: Optional[float] = None,
    config: PolyFusionConfig = PolyFusionConfig(),
    platform: str = "S2A",
    synth_method: str = "srf",
    fusion_method: str = "ot_poly",
    engine: str = "auto",
    fused_warm_run: bool = False,
    device=None,
) -> FusionResult:
    """The 4-phase fusion (``pipeline.py:161``): returns the matched
    simulated S2 RGB at 10 m plus the 60 m view and the fitted mapping.
    ``synth_method``: 'srf' (SRF integral, synth.py:9-45) or 'box'
    (rectangular band-pass, demo cell 58).
    ``fusion_method`` selects the matching model family:
    - 'ot_poly'   — OT barycentric targets + per-channel polynomial
                    (demo cell 81 / poly_regression.py, the default),
    - 'ot_affine' — OT targets + affine map (demo cell 74 / color.py),
    - 'linear'    — per-channel linear calibration (demo cells 65/72),
    - 'histogram' — per-channel CDF matching (color.py:36-63).
    ``engine``: 'fused' runs the four phases by the fused plan, with
    every intermediate on the device (same-CRS axis-aligned grids; all
    four fusion methods); 'phases' is the stage-wise reference-shaped
    path (NumPy between the phases, host-RNG OT sampling, so its result
    is reproducible against the reference from the same seed); 'auto'
    takes 'fused' and falls through to 'phases' where the fused plan
    raises :class:`FusedUnsupported`, and only then. ``info["engine"]``
    says which ran. ``device``: default the current CUDA device; the
    emit cube may be a tensor there already."""
    cfg = config
    if engine not in ("auto", "fused", "phases"):
        raise ValueError(f"Unknown engine {engine!r}")
    dev = resolve_device(device)
    if engine in ("auto", "fused"):
        try:
            if fusion_method not in FUSED_METHODS:
                raise FusedUnsupported(fusion_method)
            return _fuse_pair_fused(
                emit_cube_hwb, emit_wavelengths, emit_grid, s2_stack_bhw,
                s2_grid, good_mask=good_mask,
                s2_rgb_band_idx=s2_rgb_band_idx, s2_scale=s2_scale,
                s2_nodata=s2_nodata, config=cfg, platform=platform,
                synth_method=synth_method, fusion_method=fusion_method,
                device=dev, warm_run=fused_warm_run)
        except FusedUnsupported:
            if engine == "fused":
                raise
            # auto: fall through to the phase-wise path
    if isinstance(emit_cube_hwb, torch.Tensor):
        cube_t = emit_cube_hwb.to(device=dev, dtype=torch.float32)
    else:
        cube_t = torch.from_numpy(
            np.asarray(emit_cube_hwb, dtype=np.float32)).to(dev)
    t0 = time.perf_counter()

    # Phase 1: band synthesis of B2, B3, B4 at 60 m
    if synth_method == "box":
        W, _, _ = build_box_weight_matrix(
            emit_wavelengths, bands=["B2", "B3", "B4"],
            good_mask=good_mask)
    else:
        warn_if_parametric_srf(platform, context="fusion")
        srf = load_srf(platform, bands=["B2", "B3", "B4"])
        W, _, _ = build_srf_weight_matrix(emit_wavelengths, srf, good_mask)
    synth = srf_synthesize(cube_t, torch.from_numpy(W).to(dev)).cpu().numpy()
    emit_sim_60m = np.moveaxis(synth, -1, 0)  # (3=B2,B3,B4, H, W)
    valid60 = np.isfinite(emit_sim_60m).all(axis=0) & (emit_sim_60m[0] > 0)
    # pixels that are nodata in the source cube are invalid too
    valid60 &= (cube_t[..., 0] != NO_DATA_VALUE).cpu().numpy()
    del cube_t
    t1 = time.perf_counter()

    # Phase 2: real S2 RGB downsampled onto the EMIT grid (average)
    s2_rgb = np.stack([s2_stack_bhw[i] for i in s2_rgb_band_idx]).astype(
        np.float32)
    s2_nodata_eff = s2_nodata
    if s2_scale is not None:
        s2_rgb = s2_rgb * float(s2_scale)
        if s2_nodata_eff is not None:
            # the sentinel scales with the data (same convention as the
            # fused engine) — comparing the raw sentinel against scaled
            # values would never match
            s2_nodata_eff = float(s2_nodata_eff) * float(s2_scale)
    s2_hwb = np.moveaxis(s2_rgb, 0, -1)
    s2_60 = resample_to_grid(s2_hwb, s2_grid, emit_grid, method="average",
                             nodata=s2_nodata_eff, fill=np.nan, device=dev)
    s2_real_60m = np.moveaxis(s2_60, -1, 0)
    valid60 = valid60 & np.isfinite(s2_real_60m).all(axis=0)
    t2 = time.perf_counter()

    # Phase 3: shared stretch + the fit at 60 m.
    # RGB display order is (B4, B3, B2) (demo cell 81).
    emit_rgb_60m = np.moveaxis(emit_sim_60m[[2, 1, 0]], 0, -1)
    s2_rgb_60m = np.moveaxis(s2_real_60m[[2, 1, 0]], 0, -1)
    valid60_t = torch.from_numpy(valid60).to(dev)

    def stretch(x):
        return shared_percentile_stretch(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev), valid60_t,
            cfg.stretch_percentiles[0],
            cfg.stretch_percentiles[1]).cpu().numpy()

    emit_rgb_n = stretch(emit_rgb_60m)
    s2_rgb_n = stretch(s2_rgb_60m)
    if fusion_method == "ot_poly":
        coeffs = fit_ot_poly(emit_rgb_n, s2_rgb_n, valid60,
                             deg=cfg.degree, cfg=cfg.ot,
                             min_pixels=cfg.min_pixels, device=dev)
        matched_60m = apply_poly(emit_rgb_n, coeffs, mask=valid60,
                                 device=dev)

        def apply_10m(x, m):
            return apply_poly(x, coeffs, mask=m, device=dev)
    elif fusion_method == "ot_affine":
        A, t_vec = fit_ot_affine(emit_rgb_n, s2_rgb_n, valid60, cfg.ot,
                                 device=dev)
        coeffs = np.concatenate([A, t_vec[None, :]], axis=0)
        matched_60m = apply_affine(emit_rgb_n, A, t_vec, mask=valid60)

        def apply_10m(x, m):
            return apply_affine(x, A, t_vec, mask=m)
    elif fusion_method == "linear":
        _, params = calibrate_linear(
            np.moveaxis(emit_rgb_n, -1, 0), np.moveaxis(s2_rgb_n, -1, 0),
            valid60, device=dev)
        coeffs = np.asarray(params)  # (3, 2): a, b per channel

        def apply_10m(x, m):
            out = x.copy()
            mapped = np.clip(x * coeffs[:, 0] + coeffs[:, 1], 0, 1)
            out[m] = mapped[m]
            return np.clip(out, 0, 1)

        matched_60m = apply_10m(emit_rgb_n, valid60)
    elif fusion_method == "histogram":
        matched_60m = histogram_match_rgb(emit_rgb_n, s2_rgb_n, valid60,
                                          device=dev)
        coeffs = np.zeros((3, 1))  # non-parametric

        def apply_10m(x, m):
            # match against the SAME stretched 60 m reference the fit
            # used — keeps 60 m and 10 m normalizations consistent
            return histogram_match_rgb(x, s2_rgb_n, m, ref_mask=valid60,
                                       device=dev)
    else:
        raise ValueError(f"Unknown fusion_method {fusion_method!r}")
    t3 = time.perf_counter()

    # Phase 4: upsample the stretched sim bands to 10 m, apply the same
    # mapping there. Invalid 60 m pixels (outside-swath sentinel values,
    # which the clip-to-[0,1] stretch would otherwise smuggle through as
    # 0.0) are excluded with nodata renormalisation — the same
    # valid60-renormalised semantics as the fused engine, and the
    # reference's masking intent (poly_regression.py:137-149 excludes
    # non-positive sentinel garbage from its masks).
    sim60_masked = np.where(valid60[..., None], emit_rgb_n,
                            np.float32(NO_DATA_VALUE))
    sim10 = resample_to_grid(sim60_masked, emit_grid, s2_grid,
                             method="bilinear", nodata=NO_DATA_VALUE,
                             fill=np.nan, device=dev)
    mask10 = np.isfinite(sim10).all(axis=-1)
    fused_10m = np.array(apply_10m(np.nan_to_num(sim10), mask10))
    fused_10m[~mask10] = np.nan
    t4 = time.perf_counter()

    return FusionResult(
        fused_10m=fused_10m,
        matched_60m=matched_60m,
        coeffs=coeffs,
        emit_grid_60m=emit_grid,
        s2_grid_10m=s2_grid,
        info={
            "stages": {
                "srf_synth_s": round(t1 - t0, 4),
                "s2_downsample_s": round(t2 - t1, 4),
                "ot_poly_fit_s": round(t3 - t2, 4),
                "upsample_apply_s": round(t4 - t3, 4),
            },
            "n_valid_60m": int(valid60.sum()),
            "degree": cfg.degree,
            "fusion_method": fusion_method,
            "engine": "phases",
            "srf_source": describe_srf_source(platform),
        },
    )

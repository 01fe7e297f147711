"""End-to-end EMIT x Sentinel-2 pipelines (``hyperres/pipeline.py``).

- :func:`fuse_pair`: the 4-phase fusion (demo cell 81): band synthesis
  at 60 m, the real S2 downsampled to the EMIT grid, the shared stretch
  and the fit of ``fusion_method``, the bilinear upsample and the fit
  applied at 10 m; by the fused plan (``engine="fused"``) or phase by
  phase (``engine="phases"``);
- :func:`run_pair_pipeline`: the full per-pair run — ortho to the
  S2-anchored grid, optional coregistration, crop to overlap, fusion,
  paired tiling, spectral-SR training / evaluation / 10 m product,
  artifacts (report, metadata, manifest);
- :func:`psnr` / :func:`sam`: the parity metrics.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .artifacts import (
    ReportWriter, RunPaths, TileRecord, tif_geo_summary, write_manifest_csv,
    write_tile_metadata,
)
from .core.config import (
    CoregConfig, OrthoConfig, PolyFusionConfig, RidgeSRConfig, TilingConfig,
)
from .core.constants import NO_DATA_VALUE
from .core.cube import subsample_bands_evenly
from .core.grid import Grid
from .coreg import coregister_s2_to_emit
from .device import resolve_device
from .fusion.fused import FUSED_METHODS, FusedFusionPlan, FusedUnsupported
from .fusion.histogram import histogram_match_rgb
from .fusion.linear import calibrate_linear
from .fusion.ot import apply_affine, apply_poly, fit_ot_affine, fit_ot_poly
from .fusion.ridge_sr import RidgeSpectralSR, flatten_pixels
from .io import envi
from .io.tiff import TiffReader, write_geotiff
from .kernels.host import build_box_weight_matrix, build_srf_weight_matrix
from .kernels.srf import srf_synthesize
from .kernels.stats import shared_percentile_stretch
from .kernels.warp import resample_to_grid
from .ortho import orthorectify_granule
from .spectral.srf_tables import (
    describe_srf_source, load_srf, warn_if_parametric_srf,
)
from .spectral.synth import crop_to_overlap
from .tiling import (
    find_valid_paired_tiles, save_tile_pair, write_emit_b32_tile,
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


# ---------------------------------------------------------------------------
# Full per-pair pipeline (demo notebook end-to-end)
# ---------------------------------------------------------------------------

@dataclass
class PairRunResult:
    run: RunPaths
    ortho_info: Dict
    fusion: FusionResult
    fused_tif: Path
    tiles: List[Dict]
    tile_records: List[TileRecord]
    sr_metrics: Optional[Dict]
    report_path: Path
    info: Dict = field(default_factory=dict)


class _Stages:
    """Host seconds of each stage, each closed after a device
    synchronise: ``mark(name)`` ends the stage begun at the last mark."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        _sync(self.dev)
        now = time.perf_counter()
        self.seconds[name] = round(now - self._last, 4)
        self._last = now


def run_pair_pipeline(
    emit_nc_path: Union[str, Path],
    s2_stack_tif: Union[str, Path],
    out_root: Union[str, Path],
    *,
    mask_file: Union[str, Path, None] = None,
    ortho_config: OrthoConfig = OrthoConfig(),
    fusion_config: PolyFusionConfig = PolyFusionConfig(),
    tiling_config: TilingConfig = TilingConfig(),
    sr_config: Optional[RidgeSRConfig] = RidgeSRConfig(),
    coreg_config: Optional[CoregConfig] = None,
    coregister: bool = False,
    s2_scale: float = 1e-4,
    max_tiles: Optional[int] = None,
    train_sr: bool = True,
    predict_sr_cube: bool = False,
    engine: str = "auto",
    fused_warm_run: bool = False,
    device=None,
) -> PairRunResult:
    """Full pairs pipeline on local inputs (``pipeline.py:359``): ortho
    -> [coreg] -> overlap crop -> OT+poly fusion -> paired tiling ->
    spectral-SR train/eval [-> the 10 m SR product]. Coregistration
    (config #5's coreg step) runs when ``coregister`` is set; a failed
    match is recorded and the pipeline continues with the
    un-coregistered stack (the reference's attempts-ledger idiom; only
    data errors count as a failed match, see
    :func:`~hyperres_torch.coreg.coregister_s2_to_emit`).

    ``engine``: 'fused' (or 'auto') runs the fusion by the fused plan on
    the ortho stage's UTM cube, kept on the device (no host round trip
    between ortho and fusion); 'phases' is the stage-wise path on the
    ENVI product read back from disk. ``device``: default the current
    CUDA device; ``"cpu"`` runs every stage on the CPU. The cube comes
    to the host where the reference's does: for the SR training set.
    ``info["stages"]`` holds the host seconds of each stage (ortho,
    coreg, crop, fusion, fused GeoTIFF, tiling, SR fit, SR predict, SR
    GeoTIFF), each ended by a device synchronise."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    stages = _Stages(dev)
    run = RunPaths.build(emit_nc=emit_nc_path, local_root=out_root)
    report = ReportWriter(run.local_report_md).start()

    # 1. orthorectify onto the S2-anchored 60 m grid (the device cube is
    # kept on the device for the fused fusion plan)
    ortho_res = orthorectify_granule(
        emit_nc_path, run.local_emit_utm, s2_stack_tif,
        mask_file=mask_file,
        config=ortho_config,
        save_info_path=run.local_meta / "ortho_info.json",
        keep_device_cube=(engine in ("auto", "fused")), device=dev)
    report.section("Orthorectification", [
        f"product: {ortho_res.info.get('product')}",
        *([f"quality mask: {ortho_res.info['mask']}"]
          if "mask" in ortho_res.info else []),
        f"UTM grid: {ortho_res.utm_grid.width}x{ortho_res.utm_grid.height}"
        f" @ {ortho_res.utm_grid.dx} m",
        f"outputs: {list(ortho_res.info.get('outputs', {}))}",
    ])
    stages.mark("ortho")

    # 2. crop both to the overlap
    emit_utm_tif = ortho_res.info["outputs"].get("data_utm_tif")
    if emit_utm_tif is None:
        raise ValueError("ortho run produced no data_utm_tif "
                         "(save_geotiffs disabled?)")

    # 2a. optional coregistration of the S2 stack to the EMIT reference
    coreg_info = None
    s2_input = Path(s2_stack_tif)
    if coregister:
        s2_coreg_tif = run.local_s2 / "s2_coregistered.tif"
        coreg_info = coregister_s2_to_emit(
            emit_ref_tif=emit_utm_tif,
            s2_tgt_tif=s2_stack_tif,
            emit_nc_path=emit_nc_path,
            out_s2_tif=s2_coreg_tif,
            config=coreg_config or CoregConfig(), device=dev)
        if coreg_info["final"].get("success"):
            s2_input = s2_coreg_tif
        report.section("Coregistration", [
            f"success: {coreg_info['final'].get('success')}",
            f"band: {coreg_info['final'].get('s2_code')}",
            f"mean shift px: {coreg_info['final'].get('mean_shift_px')}",
            f"attempts: {len(coreg_info['attempts'])}",
        ])
        stages.mark("coreg")

    s2_overlap = run.local_s2 / "s2_overlap.tif"
    emit_overlap = run.local_emit / "emit_overlap.tif"
    crop_to_overlap(s2_input, emit_utm_tif, s2_overlap, emit_overlap)
    stages.mark("crop")

    # 3. fusion on the overlap. The emit side stays on the device when
    # the ortho stage kept its cube (fused engine); the ENVI product is
    # only re-read from disk on the phase-wise / idempotent-skip paths.
    r = envi.EnviReader(ortho_res.data_envi_bin.with_suffix(".hdr"))
    emit_grid = r.grid
    wl = (ortho_res.wavelengths if ortho_res.wavelengths is not None
          else r.wavelengths)
    emit_cube = ortho_res.device_cube
    emit_cube_np: Optional[np.ndarray] = None
    if emit_cube is None:
        emit_cube_np = r.read().astype(np.float32)
        emit_cube = emit_cube_np
    with TiffReader(s2_overlap) as t:
        s2_stack = t.read().astype(np.float32)
        s2_grid_c = t.grid
        s2_nodata = t.nodata
        descs = t.descriptions
    code_idx = {str(d).split("_")[0]: i for i, d in enumerate(descs) if d}
    rgb_idx = (code_idx.get("B02", 0), code_idx.get("B03", 1),
               code_idx.get("B04", 2))
    fusion = fuse_pair(
        emit_cube, wl, emit_grid, s2_stack, s2_grid_c,
        good_mask=ortho_res.good_mask,
        s2_rgb_band_idx=rgb_idx, s2_scale=s2_scale, s2_nodata=s2_nodata,
        config=fusion_config, engine=engine,
        fused_warm_run=fused_warm_run, device=dev)
    stages.mark("fusion")
    fused_tif = run.local_root / "fused_rgb_10m.tif"
    write_geotiff(fused_tif,
                  np.moveaxis(np.nan_to_num(fusion.fused_10m,
                                            nan=NO_DATA_VALUE), -1, 0),
                  s2_grid_c, nodata=NO_DATA_VALUE,
                  descriptions=["B04_matched", "B03_matched", "B02_matched"])
    report.section("Fusion (OT + poly)", [
        f"valid 60 m pixels: {fusion.info['n_valid_60m']}",
        f"poly degree: {fusion.info['degree']}",
        f"stage seconds: {fusion.info['stages']}",
        f"fused: {fused_tif.name}",
    ])
    stages.mark("fused_geotiff")

    # 4. paired tiling
    tiles = find_valid_paired_tiles(
        emit_overlap, s2_overlap,
        emit_tile_size=tiling_config.emit_tile_size,
        scale=tiling_config.scale,
        max_black_frac=tiling_config.max_black_frac,
        max_tiles=max_tiles if max_tiles is not None
        else tiling_config.max_tiles, device=dev)
    records: List[TileRecord] = []
    for t_info in tiles:
        eo, so = save_tile_pair(emit_overlap, s2_overlap, t_info,
                                run.local_tiles,
                                emit_scale=tiling_config.emit_u16_scale,
                                emit_nodata_u16=tiling_config.emit_u16_nodata,
                                device=dev)
        b32, b32_idx = write_emit_b32_tile(
            eo, num_keep=min(tiling_config.b32_keep,
                             emit_cube.shape[-1]))
        rec = TileRecord(
            idx=t_info["idx"], emit_tif=str(eo), s2_tif=str(so),
            emit_black_frac=t_info["emit_black_frac"],
            s2_black_frac=t_info["s2_black_frac"],
            emit_geo=tif_geo_summary(eo), s2_geo=tif_geo_summary(so),
            emit_window=vars(t_info["emit_window"]),
            s2_window=vars(t_info["s2_window"]),
            emit_b32_tif=str(b32),
            emit_b32_indices_0based=[int(i) for i in b32_idx])
        write_tile_metadata(rec, {k: str(v) for k, v in t_info.items()},
                            run.local_tile_meta,
                            emit_granule=Path(emit_nc_path).stem)
        records.append(rec)
    write_manifest_csv(run.local_manifest_csv, records)
    report.section("Tiles", [
        f"valid tiles: {len(tiles)}",
        f"tile size: {tiling_config.emit_tile_size} @60 m "
        f"(x{tiling_config.scale} at 10 m)",
        f"manifest: {run.local_manifest_csv.name}",
    ])
    stages.mark("tiling")

    # 5. spectral super-resolution model on the overlap
    sr_metrics = None
    if train_sr and sr_config is not None:
        if emit_cube_np is None:
            # the one trip of the device cube to the host, as the
            # reference's np.asarray of its device cube
            emit_cube_np = emit_cube.cpu().numpy()
        n_keep = min(sr_config.n_emit_bands, emit_cube_np.shape[-1])
        band_idx = subsample_bands_evenly(emit_cube_np.shape[-1], n_keep)
        emit32 = np.moveaxis(emit_cube_np[..., band_idx], -1, 0)
        s2_on_60 = resample_to_grid(
            np.moveaxis(s2_stack, 0, -1) * s2_scale, s2_grid_c, emit_grid,
            method="bilinear", nodata=(s2_nodata * s2_scale
                                       if s2_nodata is not None else None),
            fill=np.nan, device=dev)
        s2_60_bhw = np.moveaxis(s2_on_60, -1, 0)
        X, Y = flatten_pixels(s2_60_bhw, emit32, y_nodata=NO_DATA_VALUE)
        if X.shape[0] >= 100:
            model = RidgeSpectralSR(X.shape[1], Y.shape[1], sr_config,
                                    device=dev)
            model.fit(X, np.clip(Y, 1e-4, 1 - 1e-4))
            r2, rmse = (v.cpu().numpy() for v in model.evaluate(X, Y))
            sr_metrics = {
                "r2_per_band": [float(v) for v in r2],
                "rmse_per_band": [float(v) for v in rmse],
                "r2_mean": float(np.mean(r2)),
                "rmse_mean": float(np.mean(rmse)),
                "n_train_pixels": int(X.shape[0]),
                "band_indices": [int(i) for i in band_idx],
            }
            report.section("Spectral SR (ridge)", [
                f"train pixels: {sr_metrics['n_train_pixels']}",
                f"mean R2: {sr_metrics['r2_mean']:.4f}",
                f"mean RMSE: {sr_metrics['rmse_mean']:.5f}",
            ])
            stages.mark("sr_fit")
            if predict_sr_cube:
                # predict the full 10 m EMIT-band cube and archive it as
                # uint16 x10000 (Spectral_matching cells 8/27 +
                # tiles_helpers quantization convention): one call of
                # the u16 product (the SR kernel on the card), timed to
                # the codes on the host as the reference's NumPy result
                t_sr = time.perf_counter()
                q = model.predict_cube_u16(
                    s2_stack * s2_scale,
                    nodata=(s2_nodata * s2_scale
                            if s2_nodata is not None else None)
                ).cpu().numpy()
                sr_predict_s = time.perf_counter() - t_sr
                stages.mark("sr_predict")
                sr_tif = run.local_root / "emit_sr_10m.tif"
                write_geotiff(
                    sr_tif, q, s2_grid_c, nodata=65535,
                    tags={"scale_factor": "0.0001",
                          "band_indices":
                              ",".join(str(i) for i in band_idx)},
                    descriptions=[f"{float(wl[i]):.2f} nm"
                                  for i in band_idx])
                sr_metrics["sr_cube_tif"] = str(sr_tif)
                sr_metrics["sr_predict_seconds"] = round(sr_predict_s, 4)
                sr_metrics["sr_predict_px_per_s"] = round(
                    q.shape[1] * q.shape[2] / max(sr_predict_s, 1e-9))
                report.section("Spectral SR 10 m product",
                               [f"cube: {sr_tif.name} "
                                f"({q.shape[0]} bands)",
                                f"predict: {sr_predict_s:.3f} s "
                                f"({sr_metrics['sr_predict_px_per_s']:,}"
                                " px/s)"])
                stages.mark("sr_geotiff")

    total_s = time.perf_counter() - t_start
    report.section("Timing", [f"total seconds: {total_s:.3f}"])
    return PairRunResult(
        run=run, ortho_info=ortho_res.info, fusion=fusion,
        fused_tif=fused_tif, tiles=tiles, tile_records=records,
        sr_metrics=sr_metrics, report_path=run.local_report_md,
        info={"total_seconds": total_s, "coreg": coreg_info,
              "stages": stages.seconds})

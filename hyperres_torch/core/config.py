# Port-owned copy of hyperres/core/config.py, verbatim apart from its imports.
"""Typed per-stage configuration.

The reference has four *empty* ``config.py`` files; its real configuration
is kwarg defaults scattered across functions. Those defaults are the spec,
so they are centralised here (each field cites its source).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class OrthoConfig:
    """GLT orthorectification + S2-grid warp (EMIT_data/emit_proj.py)."""

    target_res_m: float = 60.0          # emit_proj.py:764
    band_chunk: int = 32                # emit_proj.py:969 (host IO chunking)
    # streaming ingest of the DATA cube: chunked HDF5 reads overlapped
    # with host->HBM transfer and device-side assembly (the production
    # successor of the reference's 32-band chunk loop). "u16" ships each
    # slab per-band-affine-quantized (half the transfer bytes, error
    # <= band_range/65534/2 — below sensor noise); "u12" packs 12-bit
    # values (25% fewer bytes than u16, error <= band_range/4094/2 —
    # still below sensor noise for reflectance); "f32" is bit-exact.
    streaming_ingest: bool = True
    ingest_transfer: str = "u16"
    ingest_depth: int = 3
    # fused GLT+warp kernel (single device program, no ortho
    # intermediate); False falls back to the two-step gather+warp
    fused_orthowarp: bool = True
    orthowarp_row_chunks: int = 64      # HBM peak control for the tap loop
    # "two_pass": Catmull-Smith scanline warp as two MXU banded matmuls
    # (~2.6x faster than the tap-loop gathers; sub-1e-3 deviation at
    # nodata boundaries only — see kernels.warp.orthowarp_two_pass).
    # "taploop": per-tap gathers, bit-identical to the two-step
    # gather+2D-cubic semantics the reference's gdalwarp implements.
    warp_kernel: str = "two_pass"
    # two-pass einsum backend: "auto" upgrades to the banded
    # block-sparse Pallas kernels on TPU when the warp geometry fits
    # their 384-sample windows (bit-level parity, ~26% faster full
    # pipeline measured round 3); "xla" forces the dense einsums
    warp_backend: str = "auto"
    resampling: str = "cubic"           # emit_proj.py:924 (-r cubic)
    write_xml: bool = True              # emit_proj.py:571
    save_geotiffs: bool = True          # emit_proj.py:577
    export_loc: bool = False            # emit_proj.py:568
    overwrite: bool = False             # emit_proj.py:573
    # uint16 export scaling for reflectance products (emit_proj.py:1008)
    reflectance_scale: Tuple[float, float] = (0.0, 1.0)
    # LOC per-band physical ranges (emit_proj.py:403-406)
    lon_range: Tuple[float, float] = (-180.0, 180.0)
    lat_range: Tuple[float, float] = (-90.0, 90.0)
    elev_range: Tuple[float, float] = (-1000.0, 12000.0)
    # OBS robust scaling percentiles + sampling stride (emit_proj.py:459-492)
    obs_percentiles: Tuple[float, float] = (1.0, 99.0)
    obs_sample_stride: int = 64
    # L2A quality-mask flag bands applied when a mask granule is given
    # (emit_tools.py:271-298; 0=cloud, 1=cirrus, 3=spacecraft — the
    # LPDAAC tutorial selection; bands 5/6 are data bands and rejected)
    quality_bands: Tuple[int, ...] = (0, 1, 3)
    # also apply the packed per-pixel-per-band mask (emit_tools.py:301-321)
    apply_band_mask: bool = False


@dataclass(frozen=True)
class SynthConfig:
    """SRF band synthesis (s2_emit/synth.py, srf.py)."""

    platform: str = "S2A"               # srf.py:21
    bands: Optional[Sequence[str]] = None  # default S2_BANDS_13
    rgb_order: Tuple[str, str, str] = ("B4", "B3", "B2")  # synth.py:47


@dataclass(frozen=True)
class OTConfig:
    """Sinkhorn optimal-transport matching (s2_emit/color.py:65-74)."""

    n_samples: int = 5000
    reg: float = 0.05
    num_itermax: int = 300
    stop_thr: float = 1e-6
    seed: int = 0
    # Sinkhorn-divergence shrinkage correction (adds one self-transport
    # Sinkhorn). False = reference parity: POT's raw entropic
    # barycentric map (s2_emit/color.py:100-104), whose blur is the
    # documented pipeline-vs-method PSNR gap.
    debias: bool = False


@dataclass(frozen=True)
class PolyFusionConfig:
    """OT + polynomial fusion (s2_emit/poly_regression.py:16-24, demo cell 81)."""

    degree: int = 4                      # demo cell 81 (module default is 2)
    min_pixels: int = 200                # poly_regression.py:38
    ot: OTConfig = field(default_factory=OTConfig)
    stretch_percentiles: Tuple[float, float] = (2.0, 98.0)  # color.py:25


@dataclass(frozen=True)
class LinearCalibConfig:
    """Per-band linear calibration (demo cells 65/72)."""

    min_pixels: int = 50                 # demo cell 72
    min_valid: float = 0.0


@dataclass(frozen=True)
class RidgeSRConfig:
    """Spectral super-resolution ridge model
    (legacy_notebooks/Spectral_matching.ipynb cells 22-27)."""

    degree: int = 3
    alpha: float = 1.0
    n_emit_bands: int = 32
    logit_eps: float = 1e-4              # cell 7
    batch_pixels: int = 200_000          # cell 8
    include_bias: bool = False           # PolynomialFeatures(include_bias=False)


@dataclass(frozen=True)
class CoregConfig:
    """FFT phase-correlation coregistration (s2_emit/arosics_coreg.py:92-112)."""

    window_size: Tuple[int, int] = (512, 512)
    grid_res: float = 600.0
    max_points: int = 500
    max_shift: int = 50
    min_reliability: float = 60.0
    tie_point_filter_level: int = 3
    # level-3 RANSAC consensus residual bound (px on the matching grid)
    ransac_thresh_px: float = 3.0
    prefer_bands: Tuple[str, ...] = ("B08", "B04")
    band_target_nm: Tuple[Tuple[str, float], ...] = (("B08", 842.0), ("B04", 665.0))
    out_gsd: Tuple[float, float] = (10.0, 10.0)
    resamp_calc: str = "cubic"
    resamp_deshift: str = "cubic"
    cliptoextent: bool = True
    # non-affine deshift: add interpolation of tie-point residuals on
    # top of the affine shift model (AROSICS' local shift field);
    # residual_mode "idw" or "tps" (thin-plate spline, smooth)
    local_residuals: bool = False
    residual_mode: str = "idw"


@dataclass(frozen=True)
class TilingConfig:
    """Paired tiling (tiles_helpers/utils.py:223-305)."""

    emit_tile_size: int = 100
    scale: int = 6
    max_black_frac: float = 0.0
    max_tiles: Optional[int] = None
    emit_u16_scale: float = 10000.0      # utils.py:316
    emit_u16_nodata: int = 65535
    b32_keep: int = 32                   # utils.py:444


@dataclass(frozen=True)
class PairSearchConfig:
    """EMIT/S2 pair discovery (s2_data/s2_utils.py:98-107, demo cells 12-18)."""

    days_window: int = 3
    max_tod_hours: float = 1.5
    min_overlap_frac: float = 0.6
    top_k_scl: int = 3
    max_s2_cloud_frac: float = 0.5
    stac_api: str = "https://earth-search.aws.element84.com/v1"
    stac_collection: str = "sentinel-2-l2a"

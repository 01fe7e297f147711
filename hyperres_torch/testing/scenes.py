# Port-owned copy of hyperres/testing/scenes.py, verbatim apart from its imports.
"""Synthetic EMIT x Sentinel-2 scene factory.

The reference has no test fixtures at all (SURVEY.md section 4); this
module fabricates physically structured scenes with known ground truth so
every pipeline stage can be tested end-to-end and benchmarked at real
granule scale:

- a shared continuous "world": smooth abundance fields mixing a few
  endmember spectra (vegetation-like red edge, soil ramp, water, urban),
- an EMIT granule: the world sampled on a rotated 60 m pushbroom swath,
  written as a real netCDF4/HDF5 file (via the framework codec) with GLT,
  geotransform, wavelengths and good-band flags — the exact envelope the
  granule reader expects from real EMIT files,
- a Sentinel-2 L2A-style stack: the world convolved with the S2 SRFs on a
  10 m UTM grid, written as a GeoTIFF with GDAL band descriptions
  ("B02_blue", ...) matching the reference's download format
  (s2_data/s2_utils.py:505-614).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

from ..core.constants import EMIT_BANDS
from ..core.crs import CRS
from ..core.grid import Grid
from ..io.hdf5 import HDF5Writer
from ..io.tiff import write_geotiff
from ..spectral.srf_tables import builtin_srf

# S2 band order of the reference's 10 m spectral stack
# (s2_data/s2_utils.py:505-614): native 10 m bands + upsampled 20 m bands.
S2_STACK_BANDS = ["B02", "B03", "B04", "B08", "B05", "B06", "B07", "B8A",
                  "B11", "B12"]
S2_STACK_DESCRIPTIONS = {
    "B02": "B02_blue", "B03": "B03_green", "B04": "B04_red",
    "B08": "B08_nir", "B05": "B05_rededge1", "B06": "B06_rededge2",
    "B07": "B07_rededge3", "B8A": "B8A_narrownir", "B11": "B11_swir1",
    "B12": "B12_swir2",
}

# stack code -> short SRF-table band name (srf_tables uses B1..B12)
S2_CODE_TO_SHORT = {
    "B02": "B2", "B03": "B3", "B04": "B4", "B05": "B5", "B06": "B6",
    "B07": "B7", "B08": "B8", "B8A": "B8A", "B11": "B11", "B12": "B12",
}


def emit_wavelength_grid(n_bands: int = EMIT_BANDS) -> Tuple[np.ndarray, np.ndarray]:
    """EMIT-like wavelength axis (380-2493 nm, ~7.43 nm pitch) and a
    good-band mask that blanks the atmospheric water absorption windows."""
    wl = np.linspace(381.0, 2493.0, n_bands)
    good = np.ones(n_bands, dtype=bool)
    good &= ~((wl > 1325.0) & (wl < 1475.0))
    good &= ~((wl > 1770.0) & (wl < 1975.0))
    return wl, good


def endmember_spectra(wl: np.ndarray) -> np.ndarray:
    """(K, B) smooth endmember spectra in [0.01, 0.9]."""
    wl = np.asarray(wl, dtype=np.float64)
    x = (wl - wl.min()) / (wl.max() - wl.min())

    # vegetation: low visible, sharp red edge near 700 nm, NIR plateau,
    # SWIR water dips
    veg = (0.05 + 0.45 / (1.0 + np.exp(-(wl - 710.0) / 18.0))
           - 0.12 * np.exp(-0.5 * ((wl - 1450.0) / 90.0) ** 2)
           - 0.10 * np.exp(-0.5 * ((wl - 1940.0) / 110.0) ** 2)
           + 0.04 * np.exp(-0.5 * ((wl - 560.0) / 40.0) ** 2))
    # soil: gently increasing ramp with broad clay feature
    soil = (0.12 + 0.35 * x - 0.06 * np.exp(-0.5 * ((wl - 2200.0) / 80.0) ** 2))
    # water: dark, decaying
    water = 0.08 * np.exp(-3.0 * x) + 0.01
    # urban/bright: high flat with mild slope
    urban = 0.35 + 0.15 * x

    out = np.stack([veg, soil, water, urban], axis=0)
    return np.clip(out, 0.01, 0.9)


def abundance_maps(x_m: np.ndarray, y_m: np.ndarray,
                   seed: int = 0,
                   freq_range: Tuple[float, float] = (0.15, 0.9),
                   n_harmonics: int = 4) -> np.ndarray:
    """(..., K) smooth positive abundance fields over UTM coords (metres),
    normalised to sum to 1. Deterministic given the seed.
    ``freq_range`` (cycles/km) and ``n_harmonics`` set the world's
    spatial texture — the default is smooth at the 60 m scale (the
    geometric-oracle assumption); coregistration tests raise the range
    so matching windows contain real structure."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x_m, dtype=np.float64) / 1000.0
    y = np.asarray(y_m, dtype=np.float64) / 1000.0
    fields = []
    for k in range(4):
        phase = rng.uniform(0, 2 * np.pi, size=n_harmonics)
        freq = rng.uniform(freq_range[0], freq_range[1],
                           size=(n_harmonics, 2))
        f = np.zeros_like(x)
        for p, (fx, fy) in zip(phase, freq):
            f = f + np.sin(fx * x + fy * y + p)
        fields.append(np.exp(0.8 * f * (4.0 / n_harmonics) ** 0.5))
    a = np.stack(fields, axis=-1)
    return a / a.sum(axis=-1, keepdims=True)


def albedo_field(x_m: np.ndarray, y_m: np.ndarray, seed: int = 0,
                 amp: float = 0.0,
                 freq_range: Tuple[float, float] = (1.0, 7.0),
                 n_harmonics: int = 32) -> np.ndarray:
    """Multiplicative broadband brightness texture shared by ALL bands.

    Real scenes' fine spatial structure is dominated by albedo /
    illumination variation that is common across the spectrum — which is
    exactly what cross-band phase correlation (EMIT band vs S2 band)
    locks onto. The default world (independent per-endmember abundance
    fields) lacks that shared structure, so coregistration tests enable
    this field. ``amp == 0`` returns 1 (no-op)."""
    if amp <= 0.0:
        return np.ones_like(np.asarray(x_m, dtype=np.float64))
    rng = np.random.default_rng(seed + 7919)
    x = np.asarray(x_m, dtype=np.float64) / 1000.0
    y = np.asarray(y_m, dtype=np.float64) / 1000.0
    phase = rng.uniform(0, 2 * np.pi, size=n_harmonics)
    freq = rng.uniform(freq_range[0], freq_range[1], size=(n_harmonics, 2))
    f = np.zeros_like(x)
    for p, (fx, fy) in zip(phase, freq):
        f = f + np.sin(fx * x + fy * y + p)
    f = f / np.sqrt(n_harmonics / 2.0)  # ~unit variance
    return np.clip(1.0 + amp * f, 0.2, None)


def truth_reflectance(x_m, y_m, spectra: np.ndarray, seed: int = 0,
                      noise: float = 0.0,
                      noise_seed: int = 1,
                      freq_range: Tuple[float, float] = (0.15, 0.9),
                      n_harmonics: int = 4,
                      albedo_amp: float = 0.0,
                      albedo_freq_range: Tuple[float, float] = (1.0, 7.0),
                      albedo_harmonics: int = 32) -> np.ndarray:
    """Reflectance (..., B) of the world at UTM points."""
    a = abundance_maps(x_m, y_m, seed=seed, freq_range=freq_range,
                       n_harmonics=n_harmonics)
    r = a @ spectra
    if albedo_amp > 0.0:
        r = r * albedo_field(x_m, y_m, seed=seed, amp=albedo_amp,
                             freq_range=albedo_freq_range,
                             n_harmonics=albedo_harmonics)[..., None]
    if noise > 0.0:
        rng = np.random.default_rng(noise_seed)
        r = r + rng.normal(scale=noise, size=r.shape)
    return np.clip(r, 0.005, 0.95).astype(np.float32)


@dataclass
class SyntheticScene:
    emit_nc_path: Path
    s2_tif_path: Path
    s2_grid: Grid
    emit_raw_shape: Tuple[int, int]
    ortho_grid: Grid
    wavelengths: np.ndarray
    good_bands: np.ndarray
    spectra: np.ndarray
    swath_center_utm: Tuple[float, float]
    swath_angle_deg: float
    utm_crs: CRS

    def raw_pixel_utm(self, rows, cols):
        """UTM coordinates of raw swath pixels (centres)."""
        th = np.radians(self.swath_angle_deg)
        cx, cy = self.swath_center_utm
        h, w = self.emit_raw_shape
        u = (np.asarray(cols, dtype=np.float64) - w / 2.0) * 60.0
        v = -(np.asarray(rows, dtype=np.float64) - h / 2.0) * 60.0
        x = cx + u * np.cos(th) - v * np.sin(th)
        y = cy + u * np.sin(th) + v * np.cos(th)
        return x, y

    def utm_to_raw(self, x, y):
        th = np.radians(self.swath_angle_deg)
        cx, cy = self.swath_center_utm
        h, w = self.emit_raw_shape
        dx = np.asarray(x, dtype=np.float64) - cx
        dy = np.asarray(y, dtype=np.float64) - cy
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        cols = u / 60.0 + w / 2.0
        rows = -v / 60.0 + h / 2.0
        return rows, cols


def make_scene(
    out_dir: Path,
    *,
    raw_shape: Tuple[int, int] = (96, 112),
    n_bands: int = EMIT_BANDS,
    s2_size: int = 720,
    s2_origin: Tuple[float, float] = (399960.0, 5800020.0),
    utm_zone: int = 33,
    swath_angle_deg: float = 13.0,
    seed: int = 0,
    noise: float = 0.002,
    compress_granule: bool = True,
    s2_dtype: str = "uint16",
    world_freq_range: Tuple[float, float] = (0.15, 0.9),
    world_harmonics: int = 4,
    world_albedo_amp: float = 0.0,
    world_albedo_freq_range: Tuple[float, float] = (1.0, 7.0),
    world_albedo_harmonics: int = 32,
) -> SyntheticScene:
    """Fabricate a paired EMIT granule + S2 stack over a shared world."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    utm = CRS.utm(utm_zone, True)
    s2_grid = Grid(utm, s2_origin[0], s2_origin[1], 10.0, 10.0,
                   s2_size, s2_size)

    wl, good = emit_wavelength_grid(n_bands)
    spectra = endmember_spectra(wl)

    # swath centred on the S2 tile centre
    cx = s2_origin[0] + s2_size * 10.0 / 2.0
    cy = s2_origin[1] - s2_size * 10.0 / 2.0

    scene = SyntheticScene(
        emit_nc_path=out_dir / "EMIT_L2A_RFL_001_synthetic_000.nc",
        s2_tif_path=out_dir / "s2_stack_10m.tif",
        s2_grid=s2_grid,
        emit_raw_shape=raw_shape,
        ortho_grid=None,  # set below
        wavelengths=wl,
        good_bands=good,
        spectra=spectra,
        swath_center_utm=(cx, cy),
        swath_angle_deg=swath_angle_deg,
        utm_crs=utm,
    )

    h, w = raw_shape
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rx, ry = scene.raw_pixel_utm(rows, cols)
    raw = truth_reflectance(rx, ry, spectra, seed=seed, noise=noise,
                            freq_range=world_freq_range,
                            n_harmonics=world_harmonics,
                            albedo_amp=world_albedo_amp,
                            albedo_freq_range=world_albedo_freq_range,
                            albedo_harmonics=world_albedo_harmonics)

    # ortho geographic grid covering the swath
    lon, lat = utm.to_geographic(rx, ry)
    res_deg = 60.0 / 111320.0 / np.cos(np.radians(float(lat.mean())))
    res_deg_y = 60.0 / 111320.0
    lon0 = float(lon.min()) - res_deg
    lat0 = float(lat.max()) + res_deg_y
    ow = int(np.ceil((float(lon.max()) + res_deg - lon0) / res_deg))
    oh = int(np.ceil((lat0 - (float(lat.min()) - res_deg_y)) / res_deg_y))
    ortho_grid = Grid(CRS.geographic(), lon0, lat0, res_deg, res_deg_y, ow, oh)
    scene.ortho_grid = ortho_grid

    # GLT: nearest raw pixel of each ortho cell centre, 1-based, 0 outside
    oxs, oys = ortho_grid.pixel_center_coords()
    olon, olat = np.meshgrid(oxs, oys)
    oux, ouy = utm.from_geographic(olon, olat)
    orows, ocols = scene.utm_to_raw(oux, ouy)
    ri = np.round(orows).astype(np.int64)
    ci = np.round(ocols).astype(np.int64)
    inside = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
    glt_x = np.where(inside, ci + 1, 0).astype(np.int32)
    glt_y = np.where(inside, ri + 1, 0).astype(np.int32)

    # location rasters (lon/lat per raw pixel)
    rlon, rlat = utm.to_geographic(rx, ry)
    elev = (300.0 + 50.0 * np.sin(rx / 2000.0) * np.cos(ry / 3000.0))

    # ---- write the granule ----
    wgran = HDF5Writer(scene.emit_nc_path)
    chunk_b = min(32, n_bands)
    wgran.create_dataset(
        "/reflectance", raw.astype(np.float32),
        chunks=(min(64, h), min(64, w), chunk_b),
        compression="deflate" if compress_granule else None,
        attrs={"dimensions": "downtrack crosstrack bands".split(),
               "units": "unitless", "_FillValue": np.float32(-9999.0)})
    wgran.create_group("/sensor_band_parameters")
    wgran.create_dataset("/sensor_band_parameters/wavelengths",
                         wl.astype(np.float32),
                         attrs={"units": "nanometers"})
    wgran.create_dataset("/sensor_band_parameters/fwhm",
                         np.full(n_bands, 8.4, dtype=np.float32),
                         attrs={"units": "nanometers"})
    wgran.create_dataset("/sensor_band_parameters/good_wavelengths",
                         good.astype(np.float32))
    wgran.create_group("/location")
    wgran.create_dataset("/location/glt_x", glt_x.astype(np.float64))
    wgran.create_dataset("/location/glt_y", glt_y.astype(np.float64))
    wgran.create_dataset("/location/lon", rlon.astype(np.float64))
    wgran.create_dataset("/location/lat", rlat.astype(np.float64))
    wgran.create_dataset("/location/elev", elev.astype(np.float64))
    wgran.set_attrs(
        "/",
        geotransform=np.array(ortho_grid.geotransform, dtype=np.float64),
        time_coverage_start="2023-08-19T11:01:26+0000",
        time_coverage_end="2023-08-19T11:01:38+0000",
        spatial_ref="GEOGCS[\"WGS 84\"]",
    )
    wgran.save()

    # ---- write the S2 stack ----
    srf = builtin_srf("S2A")
    sxs, sys_ = s2_grid.pixel_center_coords()
    sx, sy = np.meshgrid(sxs, sys_)
    a = abundance_maps(sx, sy, seed=seed, freq_range=world_freq_range,
                       n_harmonics=world_harmonics)  # (H, W, K)
    alb = albedo_field(sx, sy, seed=seed, amp=world_albedo_amp,
                       freq_range=world_albedo_freq_range,
                       n_harmonics=world_albedo_harmonics)
    stack = []
    for code in S2_STACK_BANDS:
        lam, rsp = srf[S2_CODE_TO_SHORT[code]]
        rsp_on = np.interp(wl, lam, rsp, left=0.0, right=0.0)
        num = np.trapezoid(spectra * rsp_on[None, :], x=wl, axis=-1)
        den = np.trapezoid(rsp_on, x=wl)
        band_spec = num / (den + 1e-32)  # (K,) band value per endmember
        band = np.clip((a @ band_spec) * alb, 0.0, 1.0)
        stack.append(band.astype(np.float32))
    stack = np.stack(stack, axis=0)
    descs = [S2_STACK_DESCRIPTIONS[c] for c in S2_STACK_BANDS]
    if s2_dtype == "uint16":
        data = np.clip(np.rint(stack * 10000.0), 0, 65534).astype(np.uint16)
        write_geotiff(scene.s2_tif_path, data, s2_grid, nodata=65535,
                      descriptions=descs, tiled=True,
                      tags={"SCALE": "10000"})
    else:
        write_geotiff(scene.s2_tif_path, stack, s2_grid, nodata=-9999.0,
                      descriptions=descs, tiled=True)
    return scene


def make_mask_granule(
    out_path: Path,
    raw_shape: Tuple[int, int],
    *,
    n_bands: int = EMIT_BANDS,
    cloud_mask: "np.ndarray | None" = None,
    cirrus_mask: "np.ndarray | None" = None,
    band_mask: "np.ndarray | None" = None,
) -> Path:
    """Fabricate an EMIT L2A-style mask granule: 8 quality flag/data
    bands (cloud=0, cirrus=1, dilated=2, spacecraft=3, AOD=4(data),
    H2O=5(data), aggregate=6(data), padding) + the packed per-band mask
    (emit_tools.py:271-321 layout, the envelope EmitMaskGranule reads)."""
    h, w = raw_shape
    mask = np.zeros((h, w, 8), dtype=np.float32)
    if cloud_mask is not None:
        mask[..., 0] = np.asarray(cloud_mask, dtype=np.float32)
    if cirrus_mask is not None:
        mask[..., 1] = np.asarray(cirrus_mask, dtype=np.float32)
    if band_mask is None:
        band_mask = np.zeros((h, w, n_bands), dtype=np.uint8)
    bm = np.asarray(band_mask, dtype=np.uint8)
    pad = (-bm.shape[-1]) % 8
    if pad:
        bm = np.concatenate(
            [bm, np.zeros((h, w, pad), dtype=np.uint8)], axis=-1)
    packed = np.packbits(bm, axis=-1)
    wgr = HDF5Writer(Path(out_path))
    wgr.create_dataset("/mask", mask,
                       attrs={"units": "flag", "_FillValue": np.float32(-9999.0)})
    wgr.create_dataset("/band_mask", packed)
    wgr.save()
    return Path(out_path)

"""Quantized GeoTIFF product exports for ortho outputs
(``hyperres/ortho/products.py``).

- reflectance 0..1 -> uint16 0..10000 with scale_factor metadata
  (EMIT_data/emit_proj.py:248-276, scale_mode="emit_reflectance_0_1"),
- LOC lon/lat/elev with fixed physical ranges and per-band scale/offset
  decode metadata (emit_proj.py:399-456),
- OBS with per-band robust p1-p99 ranges from a strided sample
  (emit_proj.py:459-559).

Each product has a quantizer (``reflectance_u16``, ``loc_u16``,
``obs_u16``) that returns the u16 codes where the cube lies and the
decode record the file's tags are made from, a writer (``write_*_u16``)
that writes codes and record as a GeoTIFF, and ``export_*_u16``, the two
in turn. The quantizers take the cube as a tensor (CUDA or CPU) or an
ndarray (used on the CPU). The quantization is ``kernels.stats.
quantize_u16``: on the card it runs the quantize kernel, with validity
(finite and not ``nodata_src``) tested in the kernel, so no mask is
built; only the OBS ranges (2 x bands values) come back to the host. An
ndarray or a CPU tensor takes the kernel's plain version.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.grid import Grid
from ..io.tiff import write_geotiff
from ..kernels.stats import quantize_u16, strided_band_minmax

Cube = Union[np.ndarray, torch.Tensor]
Codes = Union[np.ndarray, torch.Tensor]


def _as_tensor(cube: Cube) -> torch.Tensor:
    """The cube as a float32 tensor where it lies (an ndarray on the
    CPU, without a copy when it is float32 already)."""
    if isinstance(cube, torch.Tensor):
        return cube.to(torch.float32)
    return torch.from_numpy(np.asarray(cube, dtype=np.float32))


def _host_bands_first(q: Codes) -> np.ndarray:
    """(H, W, B) codes as the (B, H, W) host array a GeoTIFF takes."""
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    return np.moveaxis(q, -1, 0)


def reflectance_u16(
    cube_hwb: Cube,
    *,
    scale_range: Tuple[float, float] = (0.0, 1.0),
    nodata_src: float = -9999.0,
    nodata_u16: int = 65535,
) -> Tuple[torch.Tensor, Dict]:
    """[lo, hi] reflectance -> uint16 0..10000 codes where the cube lies
    (gdal_translate -scale lo hi 0 10000; emit_proj.py:265-270), and the
    decode record ``{"scale": [lo, hi, 0, 10000], "nodata_uint16"}``."""
    lo, hi = float(scale_range[0]), float(scale_range[1])
    if hi <= lo:
        raise ValueError(f"Bad reflectance scale range {scale_range}")
    # quantize_u16 maps [lo, hi_eff] -> [0, 65535]; choosing
    # hi_eff = lo + (hi - lo) * 65535/10000 sends x = hi to code 10000,
    # i.e. gdal_translate -scale lo hi 0 10000
    hi_eff = lo + (hi - lo) * 65535.0 / 10000.0
    q = quantize_u16(_as_tensor(cube_hwb), lo, hi_eff,
                     nodata_u16=nodata_u16, nodata_src=nodata_src)
    return q, {"scale": [lo, hi, 0, 10000], "nodata_uint16": int(nodata_u16)}


def write_reflectance_u16(q: Codes, grid: Grid, dst_tif: Path,
                          decode: Dict, *, zlevel: int = 1) -> Dict:
    """Reflectance codes -> GeoTIFF (deflate, predictor 2) with the
    reference's decode metadata tags; returns ``{"dst", **decode}``."""
    lo, hi = decode["scale"][:2]
    nodata_u16 = decode["nodata_uint16"]
    write_geotiff(
        dst_tif, _host_bands_first(q), grid, nodata=nodata_u16,
        compress="deflate", zlevel=zlevel, predictor=2, tiled=True,
        tags={"scale_factor": f"{(hi - lo) / 10000.0:.16g}",
              "add_offset": f"{lo:.16g}",
              "units": "reflectance",
              "uint16_nodata": str(int(nodata_u16))})
    return {"dst": str(dst_tif), **decode}


def export_reflectance_u16(
    cube_hwb: Cube,
    grid: Grid,
    dst_tif: Path,
    *,
    scale_range: Tuple[float, float] = (0.0, 1.0),
    nodata_src: float = -9999.0,
    nodata_u16: int = 65535,
    zlevel: int = 1,
) -> Dict:
    """:func:`reflectance_u16`, then :func:`write_reflectance_u16`."""
    q, decode = reflectance_u16(cube_hwb, scale_range=scale_range,
                                nodata_src=nodata_src, nodata_u16=nodata_u16)
    return write_reflectance_u16(q, grid, dst_tif, decode, zlevel=zlevel)


def loc_u16(
    loc_hwb: Cube,
    *,
    lon_range=(-180.0, 180.0),
    lat_range=(-90.0, 90.0),
    elev_range=(-1000.0, 12000.0),
    nodata_src: float = -9999.0,
    nodata_u16: int = 0,
) -> Tuple[torch.Tensor, Dict]:
    """LOC (lon, lat, elev) -> uint16 codes with per-band physical ranges
    (emit_proj.py:399-456), and the decode record (true = raw * scale +
    offset). The three bands go through one quantize call with per-band
    lo/hi (float32, as the reference's per-band calls round them)."""
    ranges = [lon_range, lat_range, elev_range]
    cube = _as_tensor(loc_hwb)
    lo_t, hi_t = (torch.tensor([float(r[i]) for r in ranges],
                               dtype=torch.float32, device=cube.device)
                  for i in (0, 1))
    q = quantize_u16(cube, lo_t, hi_t, nodata_u16=nodata_u16,
                     nodata_src=nodata_src)
    return q, {
        "scales": [(hi - lo) / 65535.0 for lo, hi in ranges],
        "offsets": [lo for lo, _ in ranges],
        "ranges": [list(r) for r in ranges],
        "nodata_uint16": int(nodata_u16),
        "note": "Recover: true = raw*scale + offset",
    }


def _band_tags(decode: Dict):
    return [{"scale": f"{s:.16g}", "offset": f"{o:.16g}"}
            for s, o in zip(decode["scales"], decode["offsets"])]


def write_loc_u16(q: Codes, grid: Grid, dst_tif: Path, decode: Dict
                  ) -> Dict:
    """LOC codes -> GeoTIFF with per-band scale / offset tags; returns
    ``{"dst", "uint16_decode": decode}``."""
    write_geotiff(dst_tif, _host_bands_first(q), grid,
                  nodata=decode["nodata_uint16"], compress="deflate",
                  predictor=2, tiled=True,
                  descriptions=["longitude", "latitude", "elevation"],
                  band_tags=_band_tags(decode))
    return {"dst": str(dst_tif), "uint16_decode": decode}


def export_loc_u16(
    loc_hwb: Cube,
    grid: Grid,
    dst_tif: Path,
    *,
    lon_range=(-180.0, 180.0),
    lat_range=(-90.0, 90.0),
    elev_range=(-1000.0, 12000.0),
    nodata_src: float = -9999.0,
    nodata_u16: int = 0,
) -> Dict:
    """:func:`loc_u16`, then :func:`write_loc_u16`."""
    q, decode = loc_u16(loc_hwb, lon_range=lon_range, lat_range=lat_range,
                        elev_range=elev_range, nodata_src=nodata_src,
                        nodata_u16=nodata_u16)
    return write_loc_u16(q, grid, dst_tif, decode)


def obs_u16(
    obs_hwb: Cube,
    *,
    nodata_src: float = -9999.0,
    nodata_u16: int = 0,
    sample_stride: int = 64,
    percentiles: Tuple[float, float] = (1.0, 99.0),
) -> Tuple[torch.Tensor, Dict]:
    """OBS geometry bands -> uint16 codes with per-band robust p1-p99
    ranges estimated on a strided sample (emit_proj.py:459-559), and the
    decode record. The ranges come to the host in one read (2 x bands
    values), where a range of no width opens to 1e-6 in float64."""
    cube = _as_tensor(obs_hwb)
    lo, hi = strided_band_minmax(cube, nodata_src, stride=sample_stride,
                                 pmin=percentiles[0], pmax=percentiles[1])
    lo, hi = torch.stack([lo, hi]).cpu().numpy().astype(np.float64)
    hi = np.where(hi <= lo, lo + 1e-6, hi)
    q = quantize_u16(
        cube, torch.as_tensor(lo, dtype=torch.float32, device=cube.device),
        torch.as_tensor(hi, dtype=torch.float32, device=cube.device),
        nodata_u16=nodata_u16, nodata_src=nodata_src)
    return q, {
        "scales": ((hi - lo) / 65535.0).tolist(),
        "offsets": lo.tolist(),
        "nodata_uint16": int(nodata_u16),
        "percentiles": list(percentiles),
        "sample_stride": int(sample_stride),
    }


def write_obs_u16(q: Codes, grid: Grid, dst_tif: Path, decode: Dict, *,
                  band_names: Optional[Sequence[str]] = None) -> Dict:
    """OBS codes -> GeoTIFF with per-band scale / offset tags and the
    band names; returns ``{"dst", "uint16_decode": decode}``."""
    write_geotiff(dst_tif, _host_bands_first(q), grid,
                  nodata=decode["nodata_uint16"], compress="deflate",
                  predictor=2, tiled=True,
                  descriptions=list(band_names) if band_names else None,
                  band_tags=_band_tags(decode))
    return {"dst": str(dst_tif), "uint16_decode": decode}


def export_obs_u16(
    obs_hwb: Cube,
    grid: Grid,
    dst_tif: Path,
    *,
    band_names: Optional[Sequence[str]] = None,
    nodata_src: float = -9999.0,
    nodata_u16: int = 0,
    sample_stride: int = 64,
    percentiles: Tuple[float, float] = (1.0, 99.0),
) -> Dict:
    """:func:`obs_u16`, then :func:`write_obs_u16`."""
    q, decode = obs_u16(obs_hwb, nodata_src=nodata_src, nodata_u16=nodata_u16,
                        sample_stride=sample_stride, percentiles=percentiles)
    return write_obs_u16(q, grid, dst_tif, decode, band_names=band_names)

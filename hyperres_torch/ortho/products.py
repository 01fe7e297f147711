"""Quantized GeoTIFF product exports for ortho outputs
(``hyperres/ortho/products.py``).

- reflectance 0..1 -> uint16 0..10000 with scale_factor metadata
  (EMIT_data/emit_proj.py:248-276, scale_mode="emit_reflectance_0_1"),
- LOC lon/lat/elev with fixed physical ranges and per-band scale/offset
  decode metadata (emit_proj.py:399-456),
- OBS with per-band robust p1-p99 ranges from a strided sample
  (emit_proj.py:459-559).

Each export takes the cube as a tensor (CUDA or CPU) or an ndarray (used
on the CPU). The quantization is ``kernels.stats.quantize_u16``: on the
card it runs the quantize kernel, with validity (finite and not
``nodata_src``) tested in the kernel, so no mask is built and only the
u16 array comes back to the host. An ndarray or a CPU tensor takes the
kernel's plain version.
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


def _as_tensor(cube: Cube) -> torch.Tensor:
    """The cube as a float32 tensor where it lies (an ndarray on the
    CPU, without a copy when it is float32 already)."""
    if isinstance(cube, torch.Tensor):
        return cube.to(torch.float32)
    return torch.from_numpy(np.asarray(cube, dtype=np.float32))


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
    """[lo, hi] reflectance -> uint16 0..10000 GeoTIFF (deflate,
    predictor 2) with the reference's decode metadata tags
    (gdal_translate -scale lo hi 0 10000; emit_proj.py:265-270)."""
    lo, hi = float(scale_range[0]), float(scale_range[1])
    if hi <= lo:
        raise ValueError(f"Bad reflectance scale range {scale_range}")
    # quantize_u16 maps [lo, hi_eff] -> [0, 65535]; choosing
    # hi_eff = lo + (hi - lo) * 65535/10000 sends x = hi to code 10000,
    # i.e. gdal_translate -scale lo hi 0 10000
    hi_eff = lo + (hi - lo) * 65535.0 / 10000.0
    q = quantize_u16(_as_tensor(cube_hwb), lo, hi_eff,
                     nodata_u16=nodata_u16, nodata_src=nodata_src)
    q = q.cpu().numpy()
    scale_factor = (hi - lo) / 10000.0
    write_geotiff(
        dst_tif, np.moveaxis(q, -1, 0), grid, nodata=nodata_u16,
        compress="deflate", zlevel=zlevel, predictor=2, tiled=True,
        tags={"scale_factor": f"{scale_factor:.16g}",
              "add_offset": f"{lo:.16g}",
              "units": "reflectance",
              "uint16_nodata": str(int(nodata_u16))})
    return {
        "dst": str(dst_tif),
        "scale": [lo, hi, 0, 10000],
        "nodata_uint16": int(nodata_u16),
    }


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
    """LOC (lon, lat, elev) -> uint16 with per-band physical ranges and
    decode metadata true = raw*scale + offset (emit_proj.py:399-456).
    The three bands go through one quantize call with per-band lo/hi
    (float32, as the reference's per-band calls round them)."""
    ranges = [lon_range, lat_range, elev_range]
    cube = _as_tensor(loc_hwb)
    lo_t, hi_t = (torch.tensor([float(r[i]) for r in ranges],
                               dtype=torch.float32, device=cube.device)
                  for i in (0, 1))
    q = quantize_u16(cube, lo_t, hi_t, nodata_u16=nodata_u16,
                     nodata_src=nodata_src)
    q = q.cpu().numpy()
    scales = [(hi - lo) / 65535.0 for lo, hi in ranges]
    offsets = [lo for lo, _ in ranges]
    band_tags = [{"scale": f"{s:.16g}", "offset": f"{o:.16g}"}
                 for s, o in zip(scales, offsets)]
    write_geotiff(dst_tif, np.moveaxis(q, -1, 0), grid, nodata=nodata_u16,
                  compress="deflate", predictor=2, tiled=True,
                  descriptions=["longitude", "latitude", "elevation"],
                  band_tags=band_tags)
    return {
        "dst": str(dst_tif),
        "uint16_decode": {
            "scales": scales,
            "offsets": offsets,
            "ranges": [list(r) for r in ranges],
            "nodata_uint16": int(nodata_u16),
            "note": "Recover: true = raw*scale + offset",
        },
    }


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
    """OBS geometry bands -> uint16 with per-band robust p1-p99 ranges
    estimated on a strided sample (emit_proj.py:459-559)."""
    cube = _as_tensor(obs_hwb)
    lo, hi = strided_band_minmax(cube, nodata_src, stride=sample_stride,
                                 pmin=percentiles[0], pmax=percentiles[1])
    lo = lo.cpu().numpy().astype(np.float64)
    hi = hi.cpu().numpy().astype(np.float64)
    hi = np.where(hi <= lo, lo + 1e-6, hi)
    q = quantize_u16(
        cube, torch.as_tensor(lo, dtype=torch.float32, device=cube.device),
        torch.as_tensor(hi, dtype=torch.float32, device=cube.device),
        nodata_u16=nodata_u16, nodata_src=nodata_src)
    q = q.cpu().numpy()
    scales = ((hi - lo) / 65535.0).tolist()
    offsets = lo.tolist()
    band_tags = [{"scale": f"{s:.16g}", "offset": f"{o:.16g}"}
                 for s, o in zip(scales, offsets)]
    write_geotiff(dst_tif, np.moveaxis(q, -1, 0), grid, nodata=nodata_u16,
                  compress="deflate", predictor=2, tiled=True,
                  descriptions=list(band_names) if band_names else None,
                  band_tags=band_tags)
    return {
        "dst": str(dst_tif),
        "uint16_decode": {
            "scales": scales,
            "offsets": offsets,
            "nodata_uint16": int(nodata_u16),
            "percentiles": list(percentiles),
            "sample_stride": int(sample_stride),
        },
    }

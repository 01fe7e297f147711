"""Scene-level spectral synthesis + grid transfer APIs
(``hyperres/spectral/synth.py``).

File-level counterparts of the reference's synthesis utilities:
- ``crop_to_overlap`` — intersect bounds, round windows, write two
  cropped GeoTIFFs preserving tags/descriptions (s2_emit/synth.py:61-139),
- ``downsample_s2_to_grid`` / ``reproject_stack_to_grid`` — the
  notebook grid resamplers (demo cell 73) over framework rasters,
- ``make_grid_template_from_raster`` — demo cell 76,
- pseudo-S2 synthesis from ENVI cubes (the kernels carry the math;
  these wrappers carry the reference's file API).

The functions that compute on the device take ``device`` (default the
current CUDA device; ``"cpu"`` for the CPU).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.grid import Grid, intersect_bounds
from ..device import resolve_device
from ..io import envi
from ..io.tiff import TiffReader, write_geotiff
from ..kernels.host import build_box_weight_matrix, build_srf_weight_matrix
from ..kernels.srf import (
    pseudo_s2_rgb, pseudo_s2_srf_integral, srf_synthesize,
)
from ..kernels.warp import resample_to_grid
from .srf_tables import builtin_srf, load_srf

__all__ = [
    "crop_to_overlap", "downsample_s2_to_grid", "reproject_stack_to_grid",
    "make_grid_template_from_raster", "pseudo_s2_from_envi",
    "pseudo_s2_srf_integral", "pseudo_s2_rgb", "builtin_srf", "load_srf",
    "build_srf_weight_matrix", "build_box_weight_matrix", "srf_synthesize",
]


def crop_to_overlap(
    s2_path: Union[str, Path],
    emit_path: Union[str, Path],
    out_s2_path: Union[str, Path],
    out_emit_path: Union[str, Path],
) -> Tuple[Path, Path]:
    """Crop both rasters to their common extent (s2_emit/synth.py:61-139):
    CRS must match, windows are rounded, tags/descriptions preserved."""
    with TiffReader(s2_path) as s2_ds, TiffReader(emit_path) as emit_ds:
        if s2_ds.grid is None or emit_ds.grid is None:
            raise ValueError("Both rasters must be georeferenced")
        if s2_ds.grid.crs != emit_ds.grid.crs:
            raise ValueError(
                f"CRS mismatch: {s2_ds.grid.crs} != {emit_ds.grid.crs}.")
        inter = intersect_bounds(s2_ds.grid.bounds, emit_ds.grid.bounds)
        if inter is None:
            raise ValueError("No overlap between S2 and EMIT extents.")

        s2_win = s2_ds.grid.window_of(inter)
        emit_win = emit_ds.grid.window_of(inter)
        s2_data = s2_ds.read(window=s2_win)
        emit_data = emit_ds.read(window=emit_win)

        write_geotiff(out_s2_path, s2_data,
                      s2_ds.grid.window_grid(s2_win), nodata=s2_ds.nodata,
                      compress="deflate", predictor=2
                      if np.issubdtype(s2_data.dtype, np.integer) else 1,
                      descriptions=s2_ds.descriptions,
                      tags=s2_ds.dataset_tags, band_tags=s2_ds.band_tags)
        write_geotiff(out_emit_path, emit_data,
                      emit_ds.grid.window_grid(emit_win),
                      nodata=emit_ds.nodata, compress="deflate",
                      predictor=2
                      if np.issubdtype(emit_data.dtype, np.integer) else 1,
                      descriptions=emit_ds.descriptions,
                      tags=emit_ds.dataset_tags, band_tags=emit_ds.band_tags)
    return Path(out_s2_path), Path(out_emit_path)


def _grid_of(path: Union[str, Path]) -> Grid:
    p = Path(path)
    if p.suffix.lower() == ".hdr" or p.with_suffix(".hdr").exists():
        r = envi.EnviReader(p if p.suffix.lower() == ".hdr"
                            else p.with_suffix(".hdr"))
        if r.grid is None:
            raise ValueError(f"No georeferencing in {p}")
        return r.grid
    with TiffReader(p) as r:
        if r.grid is None:
            raise ValueError(f"No georeferencing in {p}")
        return r.grid


def downsample_s2_to_grid(
    src_path: Union[str, Path],
    dst_grid: Union[Grid, str, Path],
    band_indexes: Sequence[int],
    src_scale: Optional[float] = None,
    resampling: str = "average",
    nodata: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """Selected 1-based bands of ``src_path`` resampled onto ``dst_grid``;
    returns (nbands, Hd, Wd) float32 (demo cell 73 semantics, including
    the 1-based band indexing and optional scaling)."""
    if not isinstance(dst_grid, Grid):
        dst_grid = _grid_of(dst_grid)
    with TiffReader(src_path) as src:
        data = src.read(bands=[b - 1 for b in band_indexes]).astype(
            np.float32)
        src_grid = src.grid
        if nodata is None:
            nodata = src.nodata
    hwb = np.moveaxis(data, 0, -1)
    out = resample_to_grid(hwb, src_grid, dst_grid, method=resampling,
                           nodata=nodata, fill=np.nan, device=device)
    out = np.moveaxis(out, -1, 0)
    if src_scale is not None:
        out = out * float(src_scale)
    return out.astype(np.float32)


def reproject_stack_to_grid(
    src_stack: np.ndarray,
    src_grid: Union[Grid, str, Path],
    dst_grid: Union[Grid, str, Path],
    resampling: str = "bilinear",
    nodata: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """(C, H, W) stack from src grid to dst grid (demo cell 73)."""
    if not isinstance(src_grid, Grid):
        src_grid = _grid_of(src_grid)
    if not isinstance(dst_grid, Grid):
        dst_grid = _grid_of(dst_grid)
    hwb = np.moveaxis(np.asarray(src_stack, dtype=np.float32), 0, -1)
    out = resample_to_grid(hwb, src_grid, dst_grid, method=resampling,
                           nodata=nodata, fill=np.nan, device=device)
    return np.moveaxis(out, -1, 0).astype(np.float32)


def make_grid_template_from_raster(src_path: Union[str, Path],
                                   out_path: Union[str, Path]) -> Path:
    """Single-band zero template carrying the source's grid (demo cell 76)."""
    g = _grid_of(src_path)
    write_geotiff(out_path, np.zeros((1, g.height, g.width),
                                     dtype=np.float32), g)
    return Path(out_path)


def pseudo_s2_from_envi(
    hdr_path: Union[str, Path],
    *,
    platform: str = "S2A",
    srf_xlsx: Union[str, Path, None] = None,
    good_mask: Optional[np.ndarray] = None,
    bands: Optional[List[str]] = None,
    device=None,
) -> Tuple[Dict[str, Optional[np.ndarray]], Grid]:
    """Load an EMIT ENVI cube and synthesize pseudo-S2 bands on device.
    Returns ({band: (H, W) or None}, grid)."""
    dev = resolve_device(device)
    r = envi.EnviReader(hdr_path)
    cube = r.read().astype(np.float32)
    wl = r.wavelengths
    if wl is None:
        raise ValueError(f"ENVI header has no wavelengths: {hdr_path}")
    srf = load_srf(platform, srf_xlsx, bands=bands)
    out = pseudo_s2_srf_integral(cube, wl, srf, good_mask=good_mask,
                                 device=dev)
    return out, r.grid

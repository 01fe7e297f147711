# Port-owned copy of hyperres/catalog/s2_stack.py, verbatim apart from its
# imports and the resample's device.
"""Sentinel-2 stack assembly, truecolor download, and grid-snapped crops.

Host-side counterparts of the reference's S2 download helpers
(s2_data/s2_utils.py):
- ``build_s2_spectral_stack`` — assemble the 9/10-band 10 m stack from
  per-band rasters: native 10 m bands nearest, 20 m bands bilinear, band
  descriptions "B02_blue"... (:505-614); asset download happens through
  the injectable StacClient so the assembly itself is testable offline;
- ``download_s2_truecolor`` — the visual asset, or an RGB composite from
  B04/B03/B02 (:463-482);
- ``crop_s2_stack_to_te`` — crop to a target extent snapped to the
  stack's own grid, preserving band descriptions (:617-783);
with the reference's file-existence caching everywhere (:635-637).

``stac`` is the port's :class:`~hyperres_torch.catalog.clients.StacClient`
(its ``download_asset(item, key, dest) -> Path`` is all this module
calls). The 20 m bands' upsample runs on ``device`` (default the current
CUDA device; ``"cpu"`` for the CPU).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from ..core.grid import Window, snap_extent_to_anchor
from ..device import resolve_device
from ..io.tiff import TiffReader, write_geotiff
from ..kernels.warp import resample_to_grid
from .clients import StacClient

# asset key -> (band description, resampling onto the 10 m grid)
S2_STACK_ASSETS: List[Tuple[str, str, str]] = [
    ("blue", "B02_blue", "nearest"),
    ("green", "B03_green", "nearest"),
    ("red", "B04_red", "nearest"),
    ("nir", "B08_nir", "nearest"),
    ("rededge1", "B05_rededge1", "bilinear"),
    ("rededge2", "B06_rededge2", "bilinear"),
    ("rededge3", "B07_rededge3", "bilinear"),
    ("nir08", "B8A_nir08", "bilinear"),       # optional
    ("swir16", "B11_swir16", "bilinear"),
    ("swir22", "B12_swir22", "bilinear"),
]
REQUIRED_ASSETS = ["blue", "green", "red", "nir", "rededge1", "rededge2",
                   "rededge3", "swir16", "swir22"]


def build_s2_spectral_stack(
    band_paths: Dict[str, Union[str, Path]],
    out_stack: Union[str, Path],
    overwrite: bool = False,
    device=None,
) -> Path:
    """Assemble the 10 m spectral stack from per-band GeoTIFFs keyed by
    asset name (blue, green, ..., swir22). The 'blue' band defines the
    reference grid; 20 m bands are bilinearly upsampled; 'nir08' is
    included only when its resolution differs from 'nir'
    (s2_utils.py:560-567)."""
    dev = resolve_device(device)
    out_stack = Path(out_stack)
    if out_stack.exists() and not overwrite:
        return out_stack
    missing = [k for k in REQUIRED_ASSETS if k not in band_paths]
    if missing:
        raise ValueError(f"Missing required assets: {missing}. "
                         f"Available: {list(band_paths)}")

    with TiffReader(band_paths["blue"]) as ref:
        ref_grid = ref.grid
        out_dtype = ref.dtype
        ref_nodata = ref.nodata

    include_nir08 = False
    if "nir08" in band_paths:
        with TiffReader(band_paths["nir"]) as a, \
                TiffReader(band_paths["nir08"]) as b:
            include_nir08 = abs(a.grid.dx) != abs(b.grid.dx)
    if not include_nir08:
        print("WARNING: 'nir08' not included (missing or same resolution "
              "as 'nir'). Output will have 9 bands.")

    bands = []
    descs = []
    for key, desc, method in S2_STACK_ASSETS:
        if key == "nir08" and not include_nir08:
            continue
        if key not in band_paths:
            continue
        with TiffReader(band_paths[key]) as src:
            data = src.read()[0].astype(np.float32)
            grid = src.grid
            nodata = src.nodata
        if grid == ref_grid:
            out = data
        else:
            out = resample_to_grid(data, grid, ref_grid, method=method,
                                   nodata=nodata,
                                   fill=nodata if nodata is not None else 0.0,
                                   device=dev)
        bands.append(np.asarray(out))
        descs.append(desc)

    stack = np.stack(bands)
    if np.issubdtype(np.dtype(out_dtype), np.integer):
        # round, don't floor: bilinear upsampling of the 20 m bands
        # produces fractional DNs and astype truncation would bias
        # every interpolated pixel ~0.5 DN low (GDAL rounds on write)
        stack = np.rint(stack)
    stack = stack.astype(out_dtype)
    write_geotiff(out_stack, stack, ref_grid, nodata=ref_nodata,
                  compress="deflate", predictor=2
                  if np.issubdtype(stack.dtype, np.integer) else 1,
                  tiled=True, descriptions=descs)
    return out_stack


def download_s2_spectral_stack(
    item: dict,
    s2_dir: Union[str, Path],
    stac: StacClient,
    overwrite: bool = False,
    device=None,
) -> Path:
    """Download the per-band assets of a STAC item and assemble the
    10-band stack (s2_utils.py:505-614) on ``device``."""
    s2_dir = Path(s2_dir)
    s2_dir.mkdir(parents=True, exist_ok=True)
    item_id = item.get("id", "s2item")
    out_stack = s2_dir / f"{item_id}_S2_10band_10m.tif"
    if out_stack.exists() and not overwrite:
        return out_stack
    assets = item.get("assets", {})
    band_paths: Dict[str, Path] = {}
    for key, _, _ in S2_STACK_ASSETS:
        if key not in assets:
            continue
        href = assets[key].get("href", "")
        suffix = Path(href.split("?")[0]).suffix or ".tif"
        band_paths[key] = stac.download_asset(
            item, key, s2_dir / f"{item_id}_{key}{suffix}")
    return build_s2_spectral_stack(band_paths, out_stack,
                                   overwrite=overwrite, device=device)


def download_s2_truecolor(
    item: dict,
    s2_dir: Union[str, Path],
    stac: StacClient,
    overwrite: bool = False,
) -> Path:
    """The 'visual' truecolor asset, or an RGB composite from
    B04/B03/B02 (s2_utils.py:463-482)."""
    s2_dir = Path(s2_dir)
    s2_dir.mkdir(parents=True, exist_ok=True)
    item_id = item.get("id", "s2item")
    out = s2_dir / f"{item_id}_truecolor.tif"
    if out.exists() and not overwrite:
        return out
    assets = item.get("assets", {})
    if "visual" in assets:
        return stac.download_asset(item, "visual", out)
    band_paths = {}
    for key in ("red", "green", "blue"):
        if key not in assets:
            raise ValueError(f"No visual asset and missing band {key!r}")
        band_paths[key] = stac.download_asset(
            item, key, s2_dir / f"{item_id}_{key}.tif")
    stacks = []
    grid = None
    nodata = None
    for key in ("red", "green", "blue"):
        with TiffReader(band_paths[key]) as r:
            stacks.append(r.read()[0])
            grid = r.grid
            nodata = r.nodata
    rgb = np.stack(stacks)
    write_geotiff(out, rgb, grid, nodata=nodata, compress="deflate",
                  tiled=True, descriptions=["B04_red", "B03_green",
                                            "B02_blue"])
    return out


def crop_s2_stack_to_te(
    s2_stack_path: Union[str, Path],
    out_path: Union[str, Path],
    left: float, bottom: float, right: float, top: float,
    *,
    chunk: int = 1024,
    overwrite: bool = False,
) -> Path:
    """Crop the stack to a target extent snapped (inward) to the stack's
    own grid, copying in ``chunk``-sized windows
    (s2_utils.py:617-783)."""
    out_path = Path(out_path)
    if out_path.exists() and not overwrite:
        return out_path
    with TiffReader(s2_stack_path) as src:
        grid = src.grid
        te = snap_extent_to_anchor((left, bottom, right, top),
                                   (grid.x0, grid.y0), grid.dx, grid.dy)
        win = grid.window_of(te)
        if win.width <= 0 or win.height <= 0:
            raise ValueError("Empty crop window for the requested extent")
        # chunked read (windowed block decode keeps memory bounded)
        out = np.zeros((src.count, win.height, win.width), dtype=src.dtype)
        for r0 in range(0, win.height, chunk):
            rh = min(chunk, win.height - r0)
            for c0 in range(0, win.width, chunk):
                cw = min(chunk, win.width - c0)
                sub = src.read(window=Window(win.col_off + c0,
                                             win.row_off + r0, cw, rh))
                out[:, r0:r0 + rh, c0:c0 + cw] = sub
        write_geotiff(out_path, out, grid.window_grid(win),
                      nodata=src.nodata, compress="deflate",
                      predictor=2 if np.issubdtype(out.dtype, np.integer)
                      else 1, tiled=True, descriptions=src.descriptions,
                      tags=src.dataset_tags)
    return out_path

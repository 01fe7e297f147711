# Port-owned copy of hyperres/catalog/cloud.py, verbatim; its relative
# imports resolve to the port's copies. The SCL classes are counted with
# NumPy on the host, as there.
"""SCL (scene classification layer) cloud metrics.

Reference semantics (s2_data/cloud_utils.py):
- cloud classes {8, 9, 10, 11} (:31),
- valid pixels are scl != 0 (:33-53),
- ``scl_metrics`` full class histogram + cloud_frac_valid (:82-101),
computed over a lon/lat region-of-interest polygon. The reference reads
remote windows via /vsicurl; here the SCL raster is a local GeoTIFF
(downloaded by the catalog client) or an in-memory array, and the ROI
mask is rasterised with the framework's own geometry + CRS stack.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..core.constants import SCL_CLASS_NAMES, SCL_CLOUD_CLASSES
from ..core.grid import Grid
from ..io.tiff import TiffReader
from .geometry import LonLatPolygon


def _roi_mask(grid: Grid, roi: Optional[LonLatPolygon],
              shape: Tuple[int, int]) -> np.ndarray:
    if roi is None:
        return np.ones(shape, dtype=bool)
    xs, ys = grid.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    lon, lat = grid.crs.to_geographic(X, Y)
    return roi.contains_points(np.asarray(lon), np.asarray(lat))


def _load_scl(scl: Union[str, Path, np.ndarray],
              grid: Optional[Grid]) -> Tuple[np.ndarray, Optional[Grid]]:
    if isinstance(scl, (str, Path)):
        with TiffReader(scl) as r:
            return r.read()[0], r.grid
    return np.asarray(scl), grid


def count_cloud_pixels(scl: Union[str, Path, np.ndarray],
                       roi: Optional[LonLatPolygon] = None,
                       grid: Optional[Grid] = None) -> Tuple[int, int]:
    """(cloud_pixels, valid_pixels) over the ROI — the SCL ranking count
    (cloud_utils.py:33-53)."""
    data, grid = _load_scl(scl, grid)
    mask = (_roi_mask(grid, roi, data.shape)
            if grid is not None else np.ones(data.shape, dtype=bool))
    valid = mask & (data != 0)
    cloud = valid & np.isin(data, SCL_CLOUD_CLASSES)
    return int(cloud.sum()), int(valid.sum())


def scl_metrics(scl: Union[str, Path, np.ndarray],
                roi: Optional[LonLatPolygon] = None,
                grid: Optional[Grid] = None) -> Dict:
    """Full class histogram + cloud_frac_valid (cloud_utils.py:82-101)."""
    data, grid = _load_scl(scl, grid)
    mask = (_roi_mask(grid, roi, data.shape)
            if grid is not None else np.ones(data.shape, dtype=bool))
    sub = data[mask]
    valid = sub[sub != 0]
    hist = {int(c): int((sub == c).sum()) for c in range(12)}
    named = {SCL_CLASS_NAMES.get(c, str(c)): n for c, n in hist.items()}
    clouds = int(np.isin(valid, SCL_CLOUD_CLASSES).sum())
    return {
        "n_roi": int(sub.size),
        "n_valid": int(valid.size),
        "n_cloud": clouds,
        "cloud_frac_valid": (clouds / valid.size) if valid.size else 1.0,
        "class_counts": hist,
        "class_counts_named": named,
    }


def open_remote_scl(href: str, fetch_range=None):
    """(scl_array, grid) from a remote COG via HTTP range reads — the
    /vsicurl-style probing the reference uses for SCL ranking
    (cloud_utils.py:33-53), transferring only the blocks touched."""
    from ..io.tiff import TiffReader

    with TiffReader.open_url(href, fetch_range=fetch_range) as r:
        return r.read()[0], r.grid

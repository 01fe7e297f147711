"""Port-owned copies of ``hyperres/core`` (constants, CRS math, grids,
config dataclasses), so that the port imports nothing of ``hyperres``."""

from .constants import (
    NO_DATA_VALUE,
    GLT_NODATA_VALUE,
    EMIT_BANDS,
    EMIT_GSD_M,
    S2_GSD_M,
    EMIT_S2_SCALE,
    EMIT_U16_SCALE,
    EMIT_U16_NODATA,
    S2_BANDS_13,
)
from .crs import CRS, transform, utm_zone_from_lonlat, equal_area_sqm
from .grid import (
    Grid,
    Window,
    intersect_bounds,
    snap_extent_to_anchor,
    s2_anchored_target_grid,
)
from .cube import Raster, SpectralCube, subsample_bands_evenly
from . import config

__all__ = [
    "NO_DATA_VALUE", "GLT_NODATA_VALUE", "EMIT_BANDS", "EMIT_GSD_M",
    "S2_GSD_M", "EMIT_S2_SCALE", "EMIT_U16_SCALE", "EMIT_U16_NODATA",
    "S2_BANDS_13",
    "CRS", "transform", "utm_zone_from_lonlat", "equal_area_sqm",
    "Grid", "Window", "intersect_bounds", "snap_extent_to_anchor",
    "s2_anchored_target_grid",
    "Raster", "SpectralCube", "subsample_bands_evenly",
    "config",
]

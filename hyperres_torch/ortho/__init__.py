"""GLT orthorectification of EMIT granules onto the S2-anchored UTM
grid, and its quantized GeoTIFF products (``hyperres/ortho``)."""

from . import products
from .pipeline import (OBS_BAND_NAMES, OrthoGeometry, OrthoProducts,
                       OrthoResult, convert_granules, orthorectify_cube,
                       orthorectify_granule, raster_meta)

__all__ = ["OrthoResult", "convert_granules", "orthorectify_granule",
           "raster_meta", "OBS_BAND_NAMES", "products", "OrthoGeometry",
           "OrthoProducts", "orthorectify_cube"]

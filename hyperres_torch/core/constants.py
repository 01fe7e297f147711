# Port-owned copy of hyperres/core/constants.py, verbatim apart from its
# imports and the reference pipeline's location, which the docstring names
# by its repository instead of a local path.
"""Framework-wide constants.

These encode the data contracts of the EMIT / Sentinel-2 fusion domain as
established by the reference pipeline
(martasumyk/hyperspectral_super-resolution):

- ``NO_DATA_VALUE`` (-9999): EMIT fill value used for orthorectified cubes
  (reference: EMIT_data/emit_proj.py:27, EMIT_data/emit_tools.py:153).
- ``GLT_NODATA_VALUE`` (0): the geometry-lookup-table sentinel; GLT indices
  are 1-based and 0 marks an unmapped ortho pixel
  (reference: EMIT_data/emit_tools.py:153-180).
- ``EMIT_BANDS`` (285): the EMIT spectral axis after band-mask unpacking
  (reference: EMIT_data/emit_tools.py:319).
- ``EMIT_GSD_M`` (60.0): EMIT ground sample distance on the ortho grid and
  the target resolution of the S2-anchored UTM grid
  (reference: EMIT_data/emit_proj.py:764, 802).
- ``EMIT_MASKED_REFLECTANCE`` (-0.01): sentinel for pixels masked upstream
  in EMIT L2A reflectance (reference: tiles_helpers/utils.py:201-220).
- ``EMIT_U16_*``: uint16 quantization convention for archived tiles:
  reflectance x 10000, nodata 65535 (reference: tiles_helpers/utils.py:316-373).
"""

from __future__ import annotations

NO_DATA_VALUE: float = -9999.0
GLT_NODATA_VALUE: int = 0
EMIT_BANDS: int = 285
EMIT_GSD_M: float = 60.0
S2_GSD_M: float = 10.0
EMIT_S2_SCALE: int = 6  # EMIT 60 m / S2 10 m
EMIT_MASKED_REFLECTANCE: float = -0.01

EMIT_U16_SCALE: float = 10000.0
EMIT_U16_NODATA: int = 65535

# WGS84 ellipsoid
WGS84_A: float = 6378137.0
WGS84_F: float = 1.0 / 298.257223563
WGS84_B: float = WGS84_A * (1.0 - WGS84_F)
WGS84_E2: float = WGS84_F * (2.0 - WGS84_F)

# Sentinel-2 band codes, 13-band convention (reference: s2_emit/srf.py:11)
S2_BANDS_13 = [
    "B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B8A", "B9", "B10",
    "B11", "B12",
]

# SCL (scene classification layer) classes considered cloud
# (reference: s2_data/cloud_utils.py:31)
SCL_CLOUD_CLASSES = (8, 9, 10, 11)

SCL_CLASS_NAMES = {
    0: "NO_DATA",
    1: "SATURATED_DEFECTIVE",
    2: "DARK_AREA",
    3: "CLOUD_SHADOW",
    4: "VEGETATION",
    5: "NOT_VEGETATED",
    6: "WATER",
    7: "UNCLASSIFIED",
    8: "CLOUD_MEDIUM_PROB",
    9: "CLOUD_HIGH_PROB",
    10: "THIN_CIRRUS",
    11: "SNOW_ICE",
}

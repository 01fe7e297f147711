"""SRF tables, their resolver and cache, and the scene-level synthesis
and grid-transfer API (``hyperres/spectral``)."""

from .srf_tables import (
    builtin_srf, describe_srf_source, load_srf, load_srf_from_xlsx,
    band_resolution_m, warn_if_parametric_srf,
    S2A_BAND_TABLE, S2B_BAND_TABLE, S2_BOX_TABLE,
)
from .srf_cache import (
    import_srf_tables, load_srf_from_csv, load_srf_npz, measured_srf,
    save_srf_npz,
)
from .synth import (
    crop_to_overlap, downsample_s2_to_grid, reproject_stack_to_grid,
    make_grid_template_from_raster, pseudo_s2_from_envi,
    pseudo_s2_srf_integral, pseudo_s2_rgb,
)

__all__ = [
    "builtin_srf", "describe_srf_source", "load_srf", "load_srf_from_xlsx",
    "band_resolution_m", "warn_if_parametric_srf",
    "import_srf_tables", "load_srf_from_csv", "load_srf_npz",
    "measured_srf", "save_srf_npz",
    "S2A_BAND_TABLE", "S2B_BAND_TABLE", "S2_BOX_TABLE",
    "crop_to_overlap", "downsample_s2_to_grid", "reproject_stack_to_grid",
    "make_grid_template_from_raster", "pseudo_s2_from_envi",
    "pseudo_s2_srf_integral", "pseudo_s2_rgb",
]

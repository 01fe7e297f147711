"""Visualisation (``hyperres/viz``): host-only copies of the
reference's quicklooks and its single-file HTML viewer."""

from .quicklook import (
    nearest_band_index, percentile_stretch, show_emit_rgb_from_envi,
    emit_rgb_from_cube, load_s2_rgb_u8, resize_s2_rgb_to, show_side_by_side,
    print_raster_geometry, plot_scl_map, plot_tile_pair_simple,
    compute_shared_stretch_params, apply_stretch, plot_s2_truecolor,
)

__all__ = [
    "nearest_band_index", "percentile_stretch", "show_emit_rgb_from_envi",
    "emit_rgb_from_cube", "load_s2_rgb_u8", "resize_s2_rgb_to",
    "show_side_by_side", "print_raster_geometry", "plot_scl_map",
    "plot_tile_pair_simple", "compute_shared_stretch_params",
    "apply_stretch", "plot_s2_truecolor",
]

"""Catalog search and pair discovery (``hyperres/catalog``): lon/lat
polygon geometry, the CMR (EMIT) and STAC (Sentinel-2) clients, the SCL
cloud metrics, EMIT x S2 pair discovery, and the Sentinel-2 stack
assembly, truecolor download and grid-snapped crops. All host code; the
network goes through injectable fetchers (``requests`` is imported only
by the default ones), and the 20 m bands' upsample of ``s2_stack`` runs
on ``device``."""

from .geometry import (
    LonLatPolygon, emit_geom_wgs84_from_umm, overlap_emit_fraction,
    point_buffer_bbox,
)
from .clients import (
    CmrClient, StacClient, CatalogUnavailableError, best_asset_key,
    choose_nearest, choose_best_emit_per_date, granule_datetime,
    search_emit_granules,
)
from .cloud import count_cloud_pixels, scl_metrics, open_remote_scl
from .pairing import (
    find_best_s2_for_emit_item, local_solar_time_hours, circ_hours_diff,
    discover_pairs,
)
from .s2_stack import (
    S2_STACK_ASSETS, REQUIRED_ASSETS, build_s2_spectral_stack,
    crop_s2_stack_to_te, download_s2_spectral_stack, download_s2_truecolor,
)

__all__ = [
    "LonLatPolygon", "emit_geom_wgs84_from_umm", "overlap_emit_fraction",
    "point_buffer_bbox",
    "CmrClient", "StacClient", "CatalogUnavailableError", "best_asset_key",
    "choose_nearest", "choose_best_emit_per_date", "granule_datetime",
    "search_emit_granules",
    "count_cloud_pixels", "scl_metrics", "open_remote_scl",
    "find_best_s2_for_emit_item", "local_solar_time_hours",
    "circ_hours_diff", "discover_pairs",
    "S2_STACK_ASSETS", "REQUIRED_ASSETS", "build_s2_spectral_stack",
    "crop_s2_stack_to_te", "download_s2_spectral_stack",
    "download_s2_truecolor",
]

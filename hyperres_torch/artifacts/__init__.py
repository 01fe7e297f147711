# Port-owned copy of hyperres/artifacts/__init__.py, verbatim apart from
# this header: the same exports.
from .runpaths import RunPaths
from .report import ReportWriter
from .metadata import (
    emit_polygon_bounds_wgs84, emit_file_records, emit_related_urls,
    write_emit_metadata, write_s2_metadata, tif_geo_summary,
    TileRecord, write_tile_metadata, write_manifest_csv, write_archive_map,
)
from .copy import copy_any

__all__ = [
    "RunPaths", "ReportWriter",
    "emit_polygon_bounds_wgs84", "emit_file_records", "emit_related_urls",
    "write_emit_metadata", "write_s2_metadata", "tif_geo_summary",
    "TileRecord", "write_tile_metadata", "write_manifest_csv",
    "write_archive_map", "copy_any",
]

# Port-owned copy of hyperres/artifacts/metadata.py (:21-377), verbatim
# apart from this header and write_manifest_csv, which writes pandas'
# CSV with the standard library (the card's machine has no pandas).
"""Metadata summaries + manifests — schema parity with
documentation/pairs_artifacts.py (EMIT UMM summaries :208-347, S2 STAC
summaries :380-467, tif geo summaries :475-502, per-tile JSON :505-597,
manifest.csv :600-618). These JSON/CSV schemas are the reference's
de-facto observability API and are reproduced field-for-field."""

from __future__ import annotations

import csv
import datetime as dt
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from ..core.crs import CRS
from ..io.tiff import TiffReader
from .report import ReportWriter, utc_now_iso
from .runpaths import ensure_dir


def write_json(path: Union[str, Path], obj: Any) -> Path:
    path = Path(path)
    ensure_dir(path.parent)
    path.write_text(json.dumps(obj, indent=2, default=str))
    return path


# ---------------------------------------------------------------------------
# EMIT (CMR UMM) summaries
# ---------------------------------------------------------------------------

def emit_polygon_bounds_wgs84(umm: dict):
    polys = (
        umm.get("SpatialExtent", {})
        .get("HorizontalSpatialDomain", {})
        .get("Geometry", {})
        .get("GPolygons", [])
    )
    if not polys:
        return None, None
    pts = polys[0].get("Boundary", {}).get("Points", [])
    if not pts:
        return None, None
    lons = [p["Longitude"] for p in pts if "Longitude" in p]
    lats = [p["Latitude"] for p in pts if "Latitude" in p]
    if not lons or not lats:
        return None, None
    bounds = [float(min(lons)), float(min(lats)),
              float(max(lons)), float(max(lats))]
    centroid = {"lon": (bounds[0] + bounds[2]) / 2.0,
                "lat": (bounds[1] + bounds[3]) / 2.0}
    return bounds, centroid


def emit_file_records(umm: dict) -> List[dict]:
    recs = umm.get("DataGranule", {}).get(
        "ArchiveAndDistributionInformation", [])
    return [{
        "name": r.get("Name"),
        "size_bytes": r.get("SizeInBytes"),
        "format": r.get("Format"),
        "checksum": r.get("Checksum", {}),
    } for r in recs]


def emit_related_urls(umm: dict) -> List[dict]:
    keep = []
    for u in umm.get("RelatedUrls", []) or []:
        if u.get("Type") in ("GET DATA", "GET DATA VIA DIRECT ACCESS",
                             "EXTENDED METADATA", "USE SERVICE API"):
            keep.append({"url": u.get("URL", ""), "type": u.get("Type"),
                         "subtype": u.get("Subtype"),
                         "description": u.get("Description")})
    return keep


def write_emit_metadata(emit_item: dict, out_dir: Union[str, Path], *,
                        report: Optional[ReportWriter] = None) -> dict:
    out_dir = ensure_dir(out_dir)
    meta_raw_path = out_dir / "emit_meta_raw.json"
    umm_raw_path = out_dir / "emit_umm_raw.json"
    summary_path = out_dir / "emit_summary.json"

    write_json(meta_raw_path, emit_item.get("meta", {}) or {})
    write_json(umm_raw_path, emit_item.get("umm", {}) or {})

    umm = emit_item.get("umm", {}) or {}
    tr = (umm.get("TemporalExtent") or {}).get("RangeDateTime", {})
    begin = tr.get("BeginningDateTime")
    end = tr.get("EndingDateTime")
    bounds_wgs84, centroid_wgs84 = emit_polygon_bounds_wgs84(umm)
    add_attrs = {a["Name"]: a.get("Values")
                 for a in (umm.get("AdditionalAttributes") or [])
                 if isinstance(a, dict) and "Name" in a}

    summary = {
        "granule_ur": umm.get("GranuleUR"),
        "native_id": (emit_item.get("meta", {}) or {}).get("native-id"),
        "concept_id": (emit_item.get("meta", {}) or {}).get("concept-id"),
        "collection": umm.get("CollectionReference"),
        "time": {"begin": begin, "end": end},
        "cloud_cover_umm": umm.get("CloudCover"),
        "spatial": {"bounds_wgs84": bounds_wgs84,
                    "centroid_wgs84": centroid_wgs84},
        "orbit_scene": {
            "ORBIT": add_attrs.get("ORBIT"),
            "ORBIT_SEGMENT": add_attrs.get("ORBIT_SEGMENT"),
            "SCENE": add_attrs.get("SCENE"),
        },
        "pge": umm.get("PGEVersionClass"),
        "software": {
            "SOFTWARE_BUILD_VERSION": add_attrs.get("SOFTWARE_BUILD_VERSION"),
            "SOFTWARE_DELIVERY_VERSION":
                add_attrs.get("SOFTWARE_DELIVERY_VERSION"),
        },
        "files": emit_file_records(umm),
        "related_urls": emit_related_urls(umm),
        "size_mb_from_item": emit_item.get("size"),
    }
    write_json(summary_path, summary)

    if report is not None:
        report.section("EMIT (from CMR UMM)", [
            f"GranuleUR: {summary['granule_ur']}",
            f"Native ID: {summary['native_id']}",
            f"Time begin/end: {begin} -> {end}",
            f"CloudCover (UMM): {summary['cloud_cover_umm']}",
            f"Bounds WGS84 (UMM polygon): {bounds_wgs84}",
            f"Centroid WGS84: {centroid_wgs84}",
            f"Orbit/Scene: ORBIT={summary['orbit_scene']['ORBIT']} "
            f"SCENE={summary['orbit_scene']['SCENE']}",
            f"Raw metadata: {umm_raw_path.name}, {meta_raw_path.name}",
        ])
    return summary


# ---------------------------------------------------------------------------
# Sentinel-2 (STAC) summaries
# ---------------------------------------------------------------------------

def _bounds_from_bbox(bbox) -> Optional[List[float]]:
    if not bbox or len(bbox) != 4:
        return None
    return [float(v) for v in bbox]


def _centroid_from_bounds(bounds) -> Optional[Dict[str, float]]:
    if not bounds:
        return None
    xmin, ymin, xmax, ymax = bounds
    return {"lon": (xmin + xmax) / 2.0, "lat": (ymin + ymax) / 2.0}


def _pick_s2_assets_minimal(s2_dict: dict) -> dict:
    assets = s2_dict.get("assets", {}) or {}
    out = {}
    for k in ["visual", "B02", "B03", "B04", "B08", "B11", "B12", "SCL"]:
        a = assets.get(k)
        if isinstance(a, dict):
            out[k] = {"href": a.get("href"), "type": a.get("type")}
    return out


def write_s2_metadata(s2_item: Any, out_dir: Union[str, Path], *,
                      report: Optional[ReportWriter] = None) -> dict:
    out_dir = ensure_dir(out_dir)
    s2_dict = (s2_item if isinstance(s2_item, dict)
               else (s2_item.to_dict() if hasattr(s2_item, "to_dict")
                     else {}))
    raw_path = out_dir / "s2_item_raw.json"
    summary_path = out_dir / "s2_summary.json"
    write_json(raw_path, s2_dict)

    props = s2_dict.get("properties", {}) or {}
    bounds = _bounds_from_bbox(s2_dict.get("bbox"))

    summary = {
        "id": s2_dict.get("id"),
        "datetime": props.get("datetime"),
        "created": props.get("created"),
        "updated": props.get("updated"),
        "platform": props.get("platform"),
        "product_uri": props.get("s2:product_uri"),
        "mgrs": {
            "grid_code": props.get("grid:code"),
            "utm_zone": props.get("mgrs:utm_zone"),
            "latitude_band": props.get("mgrs:latitude_band"),
            "grid_square": props.get("mgrs:grid_square"),
        },
        "projection": {"proj:code": props.get("proj:code")},
        "spatial": {
            "bbox_wgs84": bounds,
            "centroid_wgs84": _centroid_from_bounds(bounds),
            "geometry_type": (s2_dict.get("geometry") or {}).get("type"),
        },
        "clouds": {
            "eo:cloud_cover": props.get("eo:cloud_cover"),
            "s2:cloud_shadow_percentage":
                props.get("s2:cloud_shadow_percentage"),
            "s2:medium_proba_clouds_percentage":
                props.get("s2:medium_proba_clouds_percentage"),
            "s2:high_proba_clouds_percentage":
                props.get("s2:high_proba_clouds_percentage"),
            "s2:thin_cirrus_percentage":
                props.get("s2:thin_cirrus_percentage"),
        },
        "scene_percentages": {
            k: props.get(k) for k in (
                "s2:nodata_pixel_percentage", "s2:dark_features_percentage",
                "s2:vegetation_percentage", "s2:not_vegetated_percentage",
                "s2:water_percentage", "s2:unclassified_percentage",
                "s2:snow_ice_percentage")
        },
        "sun": {"view:sun_azimuth": props.get("view:sun_azimuth"),
                "view:sun_elevation": props.get("view:sun_elevation")},
        "processing": {
            "s2:processing_baseline": props.get("s2:processing_baseline"),
            "s2:generation_time": props.get("s2:generation_time"),
            "processing:software": props.get("processing:software"),
            "earthsearch:s3_path": props.get("earthsearch:s3_path"),
            "earthsearch:boa_offset_applied":
                props.get("earthsearch:boa_offset_applied"),
        },
        "assets_minimal": _pick_s2_assets_minimal(s2_dict),
    }
    write_json(summary_path, summary)

    if report is not None:
        report.section("Sentinel-2 (from STAC)", [
            f"ID: {summary['id']}",
            f"Datetime: {summary['datetime']}",
            f"Platform: {summary['platform']}",
            f"Product URI: {summary['product_uri']}",
            f"proj:code: {summary['projection']['proj:code']}",
            f"MGRS: {summary['mgrs']}",
            f"BBox WGS84: {summary['spatial']['bbox_wgs84']}",
            f"Centroid WGS84: {summary['spatial']['centroid_wgs84']}",
            f"eo:cloud_cover (%): {summary['clouds']['eo:cloud_cover']}",
            f"Raw metadata: {raw_path.name}",
        ])
    return summary


# ---------------------------------------------------------------------------
# GeoTIFF geo summaries + tile metadata + manifest
# ---------------------------------------------------------------------------

def tif_geo_summary(path: Union[str, Path]) -> dict:
    """Spatial summary of a GeoTIFF (pairs_artifacts.py:475-502)."""
    p = Path(path)
    with TiffReader(p) as r:
        out: Dict[str, Any] = {
            "path": str(p),
            "width": r.width,
            "height": r.height,
            "count": r.count,
            "dtype": str(r.dtype),
            "nodata": r.nodata,
        }
        if r.grid is not None:
            g = r.grid
            out["crs"] = str(g.crs)
            out["transform"] = list(g.geotransform)
            out["bounds_crs"] = list(g.bounds)
            if g.crs.is_geographic:
                wgs = g.bounds
            else:
                wgs = g.bounds_in(CRS.geographic())
            out["bounds_wgs84"] = list(wgs)
            xmin, ymin, xmax, ymax = wgs
            out["centroid_wgs84"] = {"lon": (xmin + xmax) / 2.0,
                                     "lat": (ymin + ymax) / 2.0}
    return out


@dataclass
class TileRecord:
    idx: int
    emit_tif: str
    s2_tif: str
    plot_png: Optional[str] = None
    emit_black_frac: Optional[float] = None
    s2_black_frac: Optional[float] = None
    emit_geo: Optional[dict] = None
    s2_geo: Optional[dict] = None
    emit_window: Optional[dict] = None
    s2_window: Optional[dict] = None
    emit_b32_tif: Optional[str] = None
    emit_b32_indices_0based: Optional[List[int]] = None

    def to_manifest_row(self) -> dict:
        row = {
            "idx": int(self.idx),
            "emit_tif": self.emit_tif,
            "s2_tif": self.s2_tif,
            "plot_png": self.plot_png,
            "emit_black_frac": self.emit_black_frac,
            "s2_black_frac": self.s2_black_frac,
            "emit_b32_tif": self.emit_b32_tif,
        }

        def _pull(prefix: str, g: Optional[dict]):
            if not isinstance(g, dict):
                return
            row[f"{prefix}_crs"] = g.get("crs")
            row[f"{prefix}_bounds_crs"] = g.get("bounds_crs")
            row[f"{prefix}_bounds_wgs84"] = g.get("bounds_wgs84")
            row[f"{prefix}_centroid_wgs84"] = g.get("centroid_wgs84")

        _pull("emit", self.emit_geo)
        _pull("s2", self.s2_geo)
        return row


def write_tile_metadata(
    record: TileRecord,
    tile_info: dict,
    out_dir: Union[str, Path],
    *,
    emit_granule: Optional[str] = None,
    emit_time: Any = None,
    s2_id: Optional[str] = None,
    s2_datetime: Optional[str] = None,
    params: Optional[dict] = None,
) -> Tuple[Path, dict]:
    out_dir = ensure_dir(out_dir)
    doc = {
        "tile_id": int(record.idx),
        "created_utc": utc_now_iso(),
        "pair": {
            "emit_granule": emit_granule,
            "emit_time": emit_time,
            "s2_id": s2_id,
            "s2_datetime": s2_datetime,
        },
        "geometry": {"emit_tile": record.emit_geo,
                     "s2_tile": record.s2_geo},
        "windows": {"emit_window": record.emit_window,
                    "s2_window": record.s2_window},
        "params": params or {},
        "quality": {"emit_black_frac": record.emit_black_frac,
                    "s2_black_frac": record.s2_black_frac},
        "files": {
            "emit_tif": record.emit_tif,
            "s2_tif": record.s2_tif,
            "plot_png": record.plot_png,
            "emit_b32_tif": record.emit_b32_tif,
        },
        "tile_info": tile_info or {},
    }
    path = out_dir / f"tile_{record.idx:03d}.json"
    write_json(path, doc)
    return path, record.to_manifest_row()


def _csv_column(values: List[Any]) -> List[str]:
    """One column's cells as ``pandas.DataFrame(rows).to_csv`` writes
    them: a column of ints as ints; numbers mixed with floats or missing
    values as floats (``repr``), a missing value empty; anything else
    by ``str``, a missing value empty."""
    present = [v for v in values if v is not None]
    numeric = bool(present) and all(
        isinstance(v, (int, float)) and not isinstance(v, bool)
        for v in present)
    if numeric and (len(present) < len(values)
                    or any(isinstance(v, float) for v in present)):
        return ["" if v is None or v != v else repr(float(v))
                for v in values]
    return ["" if v is None else str(v) for v in values]


def write_manifest_csv(path: Union[str, Path], rows) -> Path:
    """The manifest as ``pandas.DataFrame(rows).to_csv(path,
    index=False)`` writes it (``metadata.py:346``): the columns are the
    rows' keys in order of first appearance, cells as
    :func:`_csv_column` formats them, minimal quoting."""
    path = Path(path)
    ensure_dir(path.parent)
    if not rows:
        path.write_text("\n")
        return path
    if isinstance(rows[0], TileRecord):
        data = [r.to_manifest_row() for r in rows]
    else:
        data = rows
    cols: List[str] = []
    for row in data:
        cols.extend(k for k in row if k not in cols)
    cells = [_csv_column([row.get(k) for row in data]) for k in cols]
    with path.open("w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        w.writerows(zip(*cells))
    return path


def write_archive_map(path: Union[str, Path], mapping: Dict[str, Any], *,
                      report: Optional[ReportWriter] = None) -> Path:
    path = write_json(path, mapping)
    if report is not None:
        report.section("Archive map", [f"{k}: {v}"
                                       for k, v in mapping.items()])
    return path

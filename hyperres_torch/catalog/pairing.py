# Port-owned copy of hyperres/catalog/pairing.py, verbatim; its relative
# imports resolve to the port's copies.
"""EMIT x Sentinel-2 pair discovery.

The reference's ``find_best_s2_for_emit_item`` contract
(s2_data/s2_utils.py:98-225):
1. STAC search within +-days of the EMIT acquisition over the EMIT bbox,
2. filter by local-solar-time-of-day difference <= max_tod_diff_h and
   EMIT-overlap fraction >= min_emit_overlap,
3. rank by (tod_diff, -overlap, meta cloud), take top-k,
4. re-rank the top-k by *actual* SCL cloud fraction over the overlap
   polygon,
returning (best_item, cloud_frac, debug_dict) with the reference's
reason-ledger keys.
"""

from __future__ import annotations

import datetime as dt
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..core.config import PairSearchConfig
from .clients import StacClient, best_asset_key, CatalogUnavailableError
from .cloud import count_cloud_pixels
from .geometry import (
    LonLatPolygon, emit_geom_wgs84_from_umm, overlap_emit_fraction,
)
from ..artifacts.metadata import emit_polygon_bounds_wgs84


def _to_utc(d: dt.datetime) -> dt.datetime:
    if d.tzinfo is None:
        return d.replace(tzinfo=dt.timezone.utc)
    return d.astimezone(dt.timezone.utc)


def local_solar_time_hours(dt_utc: dt.datetime, lon_deg: float) -> float:
    """(s2_utils.py:73-77)."""
    dt_utc = _to_utc(dt_utc)
    h = dt_utc.hour + dt_utc.minute / 60.0 + dt_utc.second / 3600.0
    return (h + lon_deg / 15.0) % 24.0


def circ_hours_diff(a: float, b: float) -> float:
    """(s2_utils.py:79-80)."""
    d = abs(a - b) % 24.0
    return min(d, 24.0 - d)


def find_best_s2_for_emit_item(
    emit_item: dict,
    *,
    stac: StacClient,
    config: PairSearchConfig = PairSearchConfig(),
    scl_fetcher: Optional[Callable] = None,
    workdir: Optional[Path] = None,
) -> Tuple[Optional[dict], Optional[float], Dict]:
    """``scl_fetcher(item, asset_key) -> (scl_path_or_array, grid)``
    overrides SCL access (tests pass local rasters; the default downloads
    the asset next to ``workdir``)."""
    cfg = config
    umm = emit_item.get("umm") or {}
    begin = (umm.get("TemporalExtent") or {}).get(
        "RangeDateTime", {}).get("BeginningDateTime")
    if not begin:
        return None, None, {"reason": "emit_missing_begin_time"}
    emit_dt = _to_utc(dt.datetime.fromisoformat(begin.replace("Z", "+00:00")))

    emit_geom = emit_geom_wgs84_from_umm(umm)
    if emit_geom is None:
        bounds, centroid = emit_polygon_bounds_wgs84(umm)
        if not bounds:
            return None, None, {"reason": "emit_missing_polygon"}
        emit_geom = LonLatPolygon.from_bounds(*bounds)
        anchor_lon = centroid["lon"]
    else:
        anchor_lon = emit_geom.centroid()[0]

    emit_lst = local_solar_time_hours(emit_dt, anchor_lon)

    dt0 = emit_dt - dt.timedelta(days=cfg.days_window)
    dt1 = emit_dt + dt.timedelta(days=cfg.days_window)
    time_range = (f"{dt0.isoformat().replace('+00:00', 'Z')}/"
                  f"{dt1.isoformat().replace('+00:00', 'Z')}")

    items = stac.search(collections=[cfg.stac_collection],
                        bbox=emit_geom.bounds(),
                        datetime_range=time_range)
    if not items:
        return None, None, {"reason": "no_s2_items",
                            "time_range": time_range}

    cand = []
    for it in items:
        props = it.get("properties", {}) or {}
        s2_dt_str = props.get("datetime")
        geom = it.get("geometry")
        if not s2_dt_str or geom is None:
            continue
        s2_dt = _to_utc(dt.datetime.fromisoformat(
            s2_dt_str.replace("Z", "+00:00")))
        tod_d = circ_hours_diff(emit_lst,
                                local_solar_time_hours(s2_dt, anchor_lon))
        if tod_d > cfg.max_tod_hours:
            continue
        s2_geom = LonLatPolygon.from_geojson(geom)
        if s2_geom is None:
            continue
        frac_emit, overlap_geom = overlap_emit_fraction(emit_geom, s2_geom)
        if overlap_geom is None or frac_emit < cfg.min_overlap_frac:
            continue
        meta_cc = float(props.get("eo:cloud_cover", 999.0))
        cand.append((tod_d, frac_emit, meta_cc, it, overlap_geom))

    if not cand:
        return None, None, {
            "reason": "no_candidates_after_tod_and_overlap",
            "time_range": time_range,
            "n_items": len(items),
        }

    cand.sort(key=lambda x: (x[0], -x[1], x[2]))
    cand = cand[:max(1, min(cfg.top_k_scl, len(cand)))]

    best = None
    # one stable download dir for the whole call: a fresh mkdtemp per
    # candidate leaked directories AND defeated download_asset's
    # file-existence caching across calls
    wd = Path(workdir) if workdir is not None else (
        Path(tempfile.gettempdir()) / "hyperres_scl_cache")
    for tod_d, frac_emit, meta_cc, it, overlap_geom in cand:
        key = best_asset_key(it.get("assets", {}), "scl")
        if key is None or key.lower() == "scl-jp2":
            continue
        try:
            if scl_fetcher is not None:
                scl, grid = scl_fetcher(it, key)
            else:
                wd.mkdir(parents=True, exist_ok=True)
                scl = stac.download_asset(
                    it, key, wd / f"{it.get('id', 'scl')}_SCL.tif")
                grid = None
            clouds, total = count_cloud_pixels(scl, overlap_geom, grid)
        except (CatalogUnavailableError, ValueError, OSError):
            continue
        cloud_frac = (clouds / total) if total else 1.0
        rank = (tod_d, -frac_emit, cloud_frac)
        if best is None or rank < best["rank"]:
            best = {"item": it, "cloud_frac": cloud_frac, "rank": rank,
                    "tod_d": tod_d, "frac_emit": frac_emit,
                    "meta_cc": meta_cc}

    if best is None:
        return None, None, {"reason": "all_scl_failed",
                            "n_prefilter": len(cand)}

    dbg = {
        "emit_begin": begin,
        "time_range": time_range,
        "emit_lst": emit_lst,
        "picked": {
            "tod_diff_h": best["tod_d"],
            "emit_overlap_frac": best["frac_emit"],
            "meta_cloud_pct": best["meta_cc"],
            "scl_cloud_frac": best["cloud_frac"],
        },
        "n_items": len(items),
        "n_prefilter": len(cand),
    }
    return best["item"], best["cloud_frac"], dbg


def discover_pairs(
    *,
    cmr,
    stac: StacClient,
    bbox,
    temporal,
    config: PairSearchConfig = PairSearchConfig(),
    scl_fetcher: Optional[Callable] = None,
    workdir=None,
) -> List[Dict]:
    """The pair-discovery loop (demo notebook cells 20-24): CMR search ->
    least-cloudy EMIT granule per date -> best S2 match per granule ->
    keep pairs whose SCL cloud fraction is within
    ``config.max_s2_cloud_frac``. Returns
    [{emit_item, s2_item, cloud_frac, debug}] sorted by date."""
    from .clients import choose_best_emit_per_date

    items = cmr.search(bbox=bbox, temporal=temporal)
    best_per_date = choose_best_emit_per_date(items)
    pairs: List[Dict] = []
    for date in sorted(best_per_date):
        emit_item = best_per_date[date]
        s2_item, cloud_frac, dbg = find_best_s2_for_emit_item(
            emit_item, stac=stac, config=config,
            scl_fetcher=scl_fetcher, workdir=workdir)
        rec = {"date": date, "emit_item": emit_item, "s2_item": s2_item,
               "cloud_frac": cloud_frac, "debug": dbg}
        if s2_item is not None and cloud_frac is not None \
                and cloud_frac <= config.max_s2_cloud_frac:
            rec["kept"] = True
            pairs.append(rec)
        else:
            rec["kept"] = False
            pairs.append(rec)
    return pairs

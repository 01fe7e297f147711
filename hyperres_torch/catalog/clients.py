# Port-owned copy of hyperres/catalog/clients.py, verbatim: ``requests`` is
# imported inside the two default fetchers, so importing the module needs
# no ``requests``.
"""HTTP catalog clients: NASA CMR (EMIT) and STAC (Sentinel-2).

Replaces earthaccess (EMIT_data/EMIT_utils.py:31-116) and pystac-client
(s2_data/s2_utils.py:137-144) with direct ``requests`` calls. All network
access goes through an injectable ``fetch_json`` / ``download`` so the
logic is testable offline and degrades with a clear error when there is
no egress.
"""

from __future__ import annotations

import datetime as dt
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

CMR_GRANULE_SEARCH = "https://cmr.earthdata.nasa.gov/search/granules.umm_json"
EMIT_L2A_RFL_COLLECTION = "EMITL2ARFL"


class CatalogUnavailableError(RuntimeError):
    """Raised when a catalog HTTP request fails (e.g. no egress)."""


def _default_fetch_json(url: str, params: Optional[dict] = None,
                        method: str = "GET",
                        body: Optional[dict] = None,
                        headers: Optional[dict] = None,
                        timeout: float = 60.0) -> dict:
    import requests
    try:
        if method == "POST":
            r = requests.post(url, json=body, headers=headers,
                              timeout=timeout)
        else:
            r = requests.get(url, params=params, headers=headers,
                             timeout=timeout)
        r.raise_for_status()
        return r.json()
    except Exception as e:  # pragma: no cover - network dependent
        raise CatalogUnavailableError(f"{method} {url} failed: {e}") from e


def _default_download(url: str, dst: Path, timeout: float = 600.0,
                      token: Optional[str] = None) -> Path:
    """Streaming download; Earthdata bearer token from the argument or
    the EARTHDATA_TOKEN env var (the earthaccess.login equivalent,
    EMIT_utils.py:31-32)."""
    import os

    import requests
    headers = {}
    token = token or os.environ.get("EARTHDATA_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    try:
        with requests.get(url, stream=True, timeout=timeout,
                          headers=headers) as r:
            r.raise_for_status()
            dst.parent.mkdir(parents=True, exist_ok=True)
            with open(dst, "wb") as f:
                for chunk in r.iter_content(1 << 20):
                    f.write(chunk)
        return dst
    except Exception as e:  # pragma: no cover - network dependent
        raise CatalogUnavailableError(f"download {url} failed: {e}") from e


# ---------------------------------------------------------------------------
# CMR / EMIT
# ---------------------------------------------------------------------------

class CmrClient:
    """Granule search on NASA CMR (earthaccess.search_data equivalent,
    EMIT_utils.py:75-88)."""

    def __init__(self, fetch_json: Callable = _default_fetch_json,
                 download: Callable = _default_download):
        self.fetch_json = fetch_json
        self.download = download

    def search(
        self,
        *,
        short_name: str = EMIT_L2A_RFL_COLLECTION,
        bbox: Optional[Sequence[float]] = None,
        temporal: Optional[Tuple[str, str]] = None,
        cloud_cover: Optional[Tuple[float, float]] = None,
        page_size: int = 200,
        max_pages: int = 10,
    ) -> List[dict]:
        """Returns UMM items: [{"meta": ..., "umm": ...}]."""
        params: Dict[str, Any] = {
            "short_name": short_name,
            "page_size": page_size,
        }
        if bbox is not None:
            params["bounding_box"] = ",".join(f"{v:.8f}" for v in bbox)
        if temporal is not None:
            params["temporal"] = f"{temporal[0]},{temporal[1]}"
        if cloud_cover is not None:
            params["cloud_cover"] = f"{cloud_cover[0]},{cloud_cover[1]}"
        items: List[dict] = []
        for page in range(1, max_pages + 1):
            params["page_num"] = page
            doc = self.fetch_json(CMR_GRANULE_SEARCH, params=params)
            batch = doc.get("items", [])
            items.extend(batch)
            if len(batch) < page_size:
                break
        return items

    @staticmethod
    def data_urls(item: dict, patterns: Sequence[str] = ("_RFL_", "_MASK_")
                  ) -> List[str]:
        """Direct-download URLs filtered like the reference's asset filter
        (EMIT_utils.py:99-106)."""
        urls = []
        for u in (item.get("umm", {}).get("RelatedUrls") or []):
            if u.get("Type") in ("GET DATA", "GET DATA VIA DIRECT ACCESS"):
                url = u.get("URL", "")
                if any(p in url for p in patterns) and url.endswith(".nc"):
                    urls.append(url)
        return urls

    def download_granule_files(self, item: dict, out_dir: Union[str, Path],
                               patterns: Sequence[str] = ("_RFL_", "_MASK_"),
                               overwrite: bool = False) -> List[Path]:
        """download_reflectance equivalent (EMIT_utils.py:109-116) with
        file-existence caching."""
        out_dir = Path(out_dir)
        paths = []
        for url in self.data_urls(item, patterns):
            dst = out_dir / url.rsplit("/", 1)[-1]
            if dst.exists() and not overwrite:
                paths.append(dst)
                continue
            paths.append(self.download(url, dst))
        return paths


def granule_datetime(item: dict) -> Optional[dt.datetime]:
    begin = ((item.get("umm", {}).get("TemporalExtent") or {})
             .get("RangeDateTime", {}).get("BeginningDateTime"))
    if not begin:
        return None
    return dt.datetime.fromisoformat(begin.replace("Z", "+00:00"))


def choose_nearest(items: List[dict], target: dt.datetime) -> Optional[dict]:
    """Granule nearest in time (EMIT_utils.py:91-97). A tz-naive target
    is treated as UTC (granule timestamps are tz-aware)."""
    if target.tzinfo is None:
        target = target.replace(tzinfo=dt.timezone.utc)
    dated = []
    for i in items:
        d = granule_datetime(i)
        if d is not None:
            dated.append((abs((d - target).total_seconds()), i))
    if not dated:
        return None
    return min(dated, key=lambda t: t[0])[1]


def choose_best_emit_per_date(items: List[dict]) -> Dict[str, dict]:
    """Least-cloudy granule per calendar date (EMIT_utils.py:172-182)."""
    best: Dict[str, dict] = {}
    for it in items:
        d = granule_datetime(it)
        if d is None:
            continue
        key = d.date().isoformat()
        cc = it.get("umm", {}).get("CloudCover")
        cc = float(cc) if cc is not None else 999.0
        cur = best.get(key)
        cur_cc = (float(cur["umm"].get("CloudCover"))
                  if cur and cur["umm"].get("CloudCover") is not None
                  else 999.0)
        if cur is None or cc < cur_cc:
            best[key] = it
    return best


# ---------------------------------------------------------------------------
# STAC / Sentinel-2
# ---------------------------------------------------------------------------

class StacClient:
    """Minimal STAC API search (pystac-client equivalent)."""

    def __init__(self, api_url: str,
                 fetch_json: Callable = _default_fetch_json,
                 download: Callable = _default_download):
        self.api_url = api_url.rstrip("/")
        self.fetch_json = fetch_json
        self.download = download

    def search(
        self,
        *,
        collections: Sequence[str],
        bbox: Optional[Sequence[float]] = None,
        datetime_range: Optional[str] = None,
        limit: int = 100,
        max_items: int = 500,
    ) -> List[dict]:
        """Returns STAC item dicts, following 'next' pagination links."""
        body: Dict[str, Any] = {
            "collections": list(collections),
            "limit": limit,
        }
        if bbox is not None:
            body["bbox"] = [float(v) for v in bbox]
        if datetime_range is not None:
            body["datetime"] = datetime_range
        url = f"{self.api_url}/search"
        items: List[dict] = []
        method = "POST"
        while url and len(items) < max_items:
            doc = self.fetch_json(url, method=method,
                                  body=body if method == "POST" else None)
            items.extend(doc.get("features", []))
            next_link = next((l for l in doc.get("links", [])
                              if l.get("rel") == "next"), None)
            if next_link is None:
                break
            url = next_link.get("href")
            method = str(next_link.get("method", "POST")).upper()
            # STAC API pagination: merge=true means the link's body
            # augments the ORIGINAL request (stac-fastapi sends
            # {'token': ...} that way); replacing wholesale would drop
            # the collections/bbox/datetime filters from page 2 on
            link_body = next_link.get("body")
            if link_body is not None:
                if next_link.get("merge"):
                    body = {**body, **link_body}
                else:
                    body = link_body
        return items[:max_items]

    def download_asset(self, item: dict, asset_key: str,
                       dst: Union[str, Path], overwrite: bool = False
                       ) -> Path:
        dst = Path(dst)
        if dst.exists() and not overwrite:
            return dst
        href = item["assets"][asset_key]["href"]
        return self.download(href, dst)


def best_asset_key(assets: dict, base: str) -> Optional[str]:
    """Prefer COG over JP2 asset variants (cloud_utils.py:57-67)."""
    keys = {k.lower(): k for k in assets}
    for cand in (base.lower(), f"{base.lower()}-cog"):
        if cand in keys:
            return keys[cand]
    for k_low, k in keys.items():
        if k_low.startswith(base.lower()) and not k_low.endswith("-jp2"):
            return k
    return None


def search_emit_granules(
    client: CmrClient,
    lon: float,
    lat: float,
    buffer_m: float,
    temporal: Tuple[str, str],
    cloud_cover: Optional[Tuple[float, float]] = None,
) -> List[dict]:
    """Point + geodesic-buffer EMIT search — the reference's search
    convenience (EMIT_utils.py:51-88): AEQD buffer bbox around the point,
    then a CMR granule query."""
    from .geometry import point_buffer_bbox

    bbox = point_buffer_bbox(lon, lat, buffer_m)
    return client.search(bbox=bbox, temporal=temporal,
                         cloud_cover=cloud_cover)

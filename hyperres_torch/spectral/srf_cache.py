# Port-owned copy of hyperres/spectral/srf_cache.py (line 1), verbatim apart from its
# imports and the package data directory, which is this package's own.
"""Measured-SRF persistence: import the official Copernicus response
tables once, cache them as compact ``.npz``, and serve them offline.

The reference downloads the Copernicus workbook on every run
(s2_emit/srf.py:6-9). Here the measured curves are imported once — from
the workbook (``.xlsx``, needs pandas+engine) or a CSV export of its
"Spectral Responses" sheet — and persisted either into the package data
directory (``hyperres_torch/spectral/data/``, shipped with the code) or a user
cache. :func:`measured_srf` is the lookup the SRF resolver
(``srf_tables.load_srf``) consults before falling back to the builtin
parametric model.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.constants import S2_BANDS_13
from ..kernels.host import SRFDict

PACKAGE_DATA_DIR = Path(__file__).parent / "data"

# workbook the reference pulls (s2_emit/srf.py:6-9) — used by the CLI
# import command when a URL fetch is requested
COPERNICUS_SRF_URL = (
    "https://sentinels.copernicus.eu/documents/247904/685211/"
    "S2-SRF_COPE-GSEG-EOPG-TN-15-0007_3.2.xlsx"
)


def user_cache_dir() -> Path:
    env = os.environ.get("HYPERRES_SRF_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "hyperres" / "srf"


def _npz_name(platform: str) -> str:
    return f"srf_{platform.lower()}.npz"


def save_srf_npz(srf: SRFDict, path: Union[str, Path],
                 source: str = "") -> Path:
    """Persist an SRF dict as ``{band}_wl`` / ``{band}_resp`` arrays."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload: Dict[str, np.ndarray] = {
        "bands": np.asarray(sorted(srf), dtype="U8"),
        "source": np.asarray(source, dtype="U256"),
    }
    for band, (wl, resp) in srf.items():
        payload[f"{band}_wl"] = np.asarray(wl, dtype=np.float64)
        payload[f"{band}_resp"] = np.asarray(resp, dtype=np.float64)
    np.savez_compressed(path, **payload)
    return path


def load_srf_npz(path: Union[str, Path],
                 bands: Optional[List[str]] = None) -> SRFDict:
    with np.load(path) as z:
        have = [str(b) for b in z["bands"]]
        bands = bands or have
        out: SRFDict = {}
        for b in bands:
            if f"{b}_wl" not in z:
                raise KeyError(
                    f"Band {b!r} not in SRF cache {path} (has {have})")
            out[b] = (z[f"{b}_wl"].copy(), z[f"{b}_resp"].copy())
    return out


def measured_srf(platform: str = "S2A",
                 bands: Optional[List[str]] = None) -> Optional[SRFDict]:
    """Measured SRF tables if previously imported: package data dir
    first (tables shipped with the code), then the user cache. Returns
    None when neither exists (caller falls back to the parametric
    model). ``HYPERRES_SRF_SOURCE=parametric`` disables the lookup."""
    if os.environ.get("HYPERRES_SRF_SOURCE") == "parametric":
        return None
    name = _npz_name(platform)
    for root in (PACKAGE_DATA_DIR, user_cache_dir()):
        p = root / name
        if p.exists():
            return load_srf_npz(p, bands=bands)
    return None


def load_srf_from_csv(
    csv_path: Union[str, Path],
    platform: str = "S2A",
    bands: Optional[List[str]] = None,
    wavelength_col: str = "SR_WL",
    col_prefix: Optional[str] = None,
) -> SRFDict:
    """Parse a CSV export of the workbook's "Spectral Responses" sheet
    (same column conventions as the reference loader: ``SR_WL`` plus
    ``{platform}_SR_AV_{band}`` columns, s2_emit/srf.py:20-52)."""
    bands = bands or S2_BANDS_13
    platform = platform.upper()
    if col_prefix is None:
        col_prefix = f"{platform}_SR_AV_"
    csv_path = Path(csv_path)
    with open(csv_path, "r", encoding="utf-8-sig") as f:
        header = f.readline().strip().split(",")
    cols = {name.strip(): i for i, name in enumerate(header)}
    if wavelength_col not in cols:
        raise ValueError(
            f"Column {wavelength_col!r} not in {csv_path} "
            f"(has {list(cols)[:6]}...)")
    data = np.genfromtxt(csv_path, delimiter=",", skip_header=1,
                         dtype=np.float64, filling_values=np.nan)
    if data.ndim == 1:
        data = data[None, :]
    wl = data[:, cols[wavelength_col]]
    out: SRFDict = {}
    for b in bands:
        col = f"{col_prefix}{b}"
        if col not in cols:
            raise KeyError(f"Column {col!r} not found in {csv_path}")
        resp = data[:, cols[col]]
        m = np.isfinite(wl) & np.isfinite(resp) & (resp > 0)
        out[b] = (wl[m].copy(), resp[m].copy())
    return out


def import_srf_tables(
    src: Union[str, Path],
    platform: str = "S2A",
    dest: Union[str, Path] = "user",
    bands: Optional[List[str]] = None,
) -> Path:
    """Parse measured SRF tables from a workbook (``.xlsx``) or CSV sheet
    export and persist them where :func:`measured_srf` will find them.
    ``dest``: 'user' (cache dir), 'package' (ship with the code), or an
    explicit directory."""
    src = Path(src)
    if src.suffix.lower() in (".xlsx", ".xls"):
        from .srf_tables import load_srf_from_xlsx
        srf = load_srf_from_xlsx(src, platform=platform, bands=bands)
    elif src.suffix.lower() == ".csv":
        srf = load_srf_from_csv(src, platform=platform, bands=bands)
    else:
        raise ValueError(f"Unsupported SRF source format: {src.suffix!r}")
    if dest == "user":
        root = user_cache_dir()
    elif dest == "package":
        root = PACKAGE_DATA_DIR
    else:
        root = Path(dest)
    return save_srf_npz(srf, root / _npz_name(platform),
                        source=str(src.name))


def fetch_srf_workbook(dest_path: Union[str, Path],
                       url: str = COPERNICUS_SRF_URL,
                       timeout: float = 60.0) -> Path:
    """Download the official workbook (network required) — the CLI
    ``srf --fetch`` path; everything else in this module is offline."""
    import urllib.request

    dest_path = Path(dest_path)
    dest_path.parent.mkdir(parents=True, exist_ok=True)
    with urllib.request.urlopen(url, timeout=timeout) as r, \
            open(dest_path, "wb") as f:
        f.write(r.read())
    return dest_path

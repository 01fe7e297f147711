"""Sentinel-2 spectral response functions (SRF).

A port-owned copy of ``hyperres/spectral/srf_tables.py``: the band
tables, the parametric model ``builtin_srf`` (``:89``), the workbook
loader (``:117``) on the port's own xlsx codec, and the resolver
``load_srf`` (``:161``) with ``warn_if_parametric_srf`` (``:177``) and
``describe_srf_source`` (``:205``). The resolver prefers measured tables
imported into the package data directory or the user cache
(:mod:`.srf_cache`; the cache directory and the environment variables
are the reference's, so both packages resolve the same table on one
machine) and falls back to the parametric model, with a warning.

Returned SRFs use the reference's dict contract:
``{band: (lambda_nm, response)}`` with response > 0 on its support.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.constants import S2_BANDS_13

from ..kernels.host import SRFDict

# Band -> (centre_nm, bandwidth_nm, native_resolution_m) per platform.
# Values follow the published Sentinel-2 MSI band definitions (the S2A/S2B
# centres differ by a few nm for the visible/red-edge bands).
S2A_BAND_TABLE: Dict[str, Tuple[float, float, int]] = {
    "B1": (442.7, 21.0, 60),
    "B2": (492.4, 66.0, 10),
    "B3": (559.8, 36.0, 10),
    "B4": (664.6, 31.0, 10),
    "B5": (704.1, 15.0, 20),
    "B6": (740.5, 15.0, 20),
    "B7": (782.8, 20.0, 20),
    "B8": (832.8, 106.0, 10),
    "B8A": (864.7, 21.0, 20),
    "B9": (945.1, 20.0, 60),
    "B10": (1373.5, 31.0, 60),
    "B11": (1613.7, 91.0, 20),
    "B12": (2202.4, 175.0, 20),
}

S2B_BAND_TABLE: Dict[str, Tuple[float, float, int]] = {
    "B1": (442.3, 21.0, 60),
    "B2": (492.1, 66.0, 10),
    "B3": (559.0, 36.0, 10),
    "B4": (665.0, 31.0, 10),
    "B5": (703.8, 16.0, 20),
    "B6": (739.1, 15.0, 20),
    "B7": (779.7, 20.0, 20),
    "B8": (833.0, 106.0, 10),
    "B8A": (864.0, 22.0, 20),
    "B9": (943.2, 21.0, 60),
    "B10": (1376.9, 30.0, 60),
    "B11": (1610.4, 94.0, 20),
    "B12": (2185.7, 185.0, 20),
}


# Simplified rectangular band-pass table used by the reference's
# box-integral variant (demo notebook cell 57): centre +- bandwidth/2.
S2_BOX_TABLE: Dict[str, Tuple[float, float]] = {
    "B1": (443.0, 20.0),
    "B2": (490.0, 65.0),
    "B3": (560.0, 35.0),
    "B4": (665.0, 30.0),
    "B5": (705.0, 15.0),
    "B6": (740.0, 15.0),
    "B7": (783.0, 20.0),
    "B8": (842.0, 115.0),
    "B8A": (865.0, 20.0),
    "B9": (945.0, 20.0),
    "B11": (1610.0, 90.0),
    "B12": (2190.0, 180.0),
}


def _band_table(platform: str) -> Dict[str, Tuple[float, float, int]]:
    platform = platform.upper()
    if platform == "S2A":
        return S2A_BAND_TABLE
    if platform == "S2B":
        return S2B_BAND_TABLE
    raise ValueError(f"Unknown platform {platform!r} (expected S2A/S2B)")


# -- hyperres/spectral/srf_tables.py:89 --------------------------------------

def builtin_srf(platform: str = "S2A",
                bands: Optional[List[str]] = None,
                exponent: float = 4.0,
                step_nm: float = 1.0) -> SRFDict:
    """Parametric SRF: a super-Gaussian ``exp(-(2|x-c|/w)^(2p))`` per band,
    sampled at 1 nm over the support where response > 1e-4. The flat-top
    shape approximates the measured MSI responses far better than a plain
    Gaussian while remaining fully self-contained."""
    table = _band_table(platform)
    bands = bands or S2_BANDS_13
    out: SRFDict = {}
    for b in bands:
        if b not in table:
            raise KeyError(f"Band {b!r} not in {platform} table")
        centre, width, _res = table[b]
        half_support = width  # generous support; tails decay fast
        lam = np.arange(centre - half_support, centre + half_support + step_nm,
                        step_nm)
        resp = np.exp(-((2.0 * np.abs(lam - centre) / width) ** (2.0 * exponent)))
        keep = resp > 1e-4
        out[b] = (lam[keep].astype(np.float64), resp[keep].astype(np.float64))
    return out


# -- hyperres/spectral/srf_tables.py:113-222 ---------------------------------

def band_resolution_m(band: str, platform: str = "S2A") -> int:
    return _band_table(platform)[band][2]


def load_srf_from_xlsx(
    xlsx_path: Union[str, Path],
    platform: str = "S2A",
    bands: Optional[List[str]] = None,
    wavelength_col: str = "SR_WL",
    col_prefix: Optional[str] = None,
) -> SRFDict:
    """Parse the official Copernicus SRF workbook (same sheet/column
    conventions as the reference loader, s2_emit/srf.py:20-52) with the
    in-repo stdlib-only xlsx codec (:mod:`hyperres_torch.io.xlsx`) — no
    pandas / openpyxl stack needed for one KB-scale table."""
    from ..io.xlsx import read_table, sheet_names

    bands = bands or S2_BANDS_13
    platform = platform.upper()
    if col_prefix is None:
        col_prefix = f"{platform}_SR_AV_"

    names = sheet_names(xlsx_path)
    candidates = [s for s in names
                  if "Spectral Responses" in s and platform in s]
    if not candidates:
        raise ValueError(
            f"No sheet containing 'Spectral Responses' and '{platform}'. "
            f"Sheets: {names}")
    header, data = read_table(xlsx_path, candidates[0])
    cols = {name: j for j, name in enumerate(header)}
    if wavelength_col not in cols:
        raise ValueError(
            f"Column {wavelength_col!r} not in sheet {candidates[0]!r} "
            f"(has {header[:6]}...)")
    wavelength_nm = data[:, cols[wavelength_col]]
    out: SRFDict = {}
    for b in bands:
        col = f"{col_prefix}{b}"
        if col not in cols:
            raise KeyError(f"Column '{col}' not found")
        resp = data[:, cols[col]]
        m = np.isfinite(wavelength_nm) & np.isfinite(resp) & (resp > 0)
        out[b] = (wavelength_nm[m].astype(float), resp[m].astype(float))
    return out


def load_srf(platform: str = "S2A",
             xlsx_path: Optional[Union[str, Path]] = None,
             bands: Optional[List[str]] = None) -> SRFDict:
    """The canonical SRF resolver. Order: explicit workbook path ->
    previously imported measured tables (package data / user cache, see
    ``srf_cache.import_srf_tables``) -> builtin parametric model.
    ``HYPERRES_SRF_SOURCE=parametric`` forces the last."""
    if xlsx_path is not None and Path(xlsx_path).exists():
        return load_srf_from_xlsx(xlsx_path, platform=platform, bands=bands)
    from .srf_cache import measured_srf
    cached = measured_srf(platform, bands=bands)
    if cached is not None:
        return cached
    return builtin_srf(platform=platform, bands=bands)


def warn_if_parametric_srf(platform: str = "S2A",
                           context: str = "SRF synthesis") -> str:
    """Warn loudly when the resolver would fall back to the built-in
    parametric model — both fusion engines call this at plan-build /
    fuse time so a real-data run cannot silently synthesize pseudo-S2
    bands from unmeasured curves. Returns the resolved source string.

    The parametric-vs-measured divergence is bounded in
    docs/PARITY.md ("SRF sensitivity"): centre +-2 nm / FWHM +-5% /
    exponent 3..5 perturbations move synthesized band values by at
    most 0.006 reflectance (5.3% relative), and the OT/poly
    calibration absorbs most of that — the fused product stays within
    ~49 dB of the unperturbed result. Import measured tables once with
    ``spectral.import_srf_tables`` to remove the bias entirely."""
    src = describe_srf_source(platform)
    if src == "parametric":
        warnings.warn(
            f"{context}: using the built-in PARAMETRIC Sentinel-2 "
            f"{platform} SRF model, not measured Copernicus curves — "
            "synthesized band values can deviate from the reference "
            "(bounded in docs/PARITY.md 'SRF sensitivity'). Import the "
            "measured tables once with "
            "`hyperres_torch.spectral.import_srf_tables(workbook)`.",
            UserWarning, stacklevel=3)
    return src


def describe_srf_source(platform: str = "S2A",
                        xlsx_path: Optional[Union[str, Path]] = None
                        ) -> str:
    """Which table :func:`load_srf` would resolve to, for run ledgers —
    the resolver consults per-machine cache state, so every fusion run
    records the source it actually used ("workbook:<path>" |
    "measured-cache:<path>" | "parametric")."""
    if xlsx_path is not None and Path(xlsx_path).exists():
        return f"workbook:{xlsx_path}"
    from .srf_cache import PACKAGE_DATA_DIR, _npz_name, user_cache_dir
    if os.environ.get("HYPERRES_SRF_SOURCE") != "parametric":
        name = _npz_name(platform)
        for root in (PACKAGE_DATA_DIR, user_cache_dir()):
            if (root / name).exists():
                return f"measured-cache:{root / name}"
    return "parametric"

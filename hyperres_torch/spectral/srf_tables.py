"""Sentinel-2 spectral response functions: the parametric model.

A jax-free copy of the parts of ``hyperres/spectral/srf_tables.py``
that the fused plan uses (the band tables and ``builtin_srf``,
``srf_tables.py:25-115``). The reference's resolver ``load_srf``
prefers measured tables imported into a user cache; the port does not
read those yet, so a plan built without an explicit ``srf=`` table uses
this parametric model (and says so with a warning).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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

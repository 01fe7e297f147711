"""Frozen copy of the spectral tables the benchmark's scene and reference
read: the EMIT-like wavelength axis and good-band mask, the four
endmember spectra, the parametric S2A response of B2 / B3 / B4 and the
SRF weight matrix of the synthesis integral.

Copied from ``hyperres_torch/testing/bench_scene.py``
(``emit_wavelength_grid``, ``endmember_spectra``) and
``hyperres_torch/spectral/srf_tables.py`` (``S2A_BAND_TABLE``,
``builtin_srf``) and ``hyperres_torch/kernels/host.py``
(``trapezoid_weights``, ``build_srf_weight_matrix``). NumPy only.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

#: band -> (centre nm, width nm), the published S2A MSI definitions
S2A_BANDS: Dict[str, Tuple[float, float]] = {
    "B2": (492.4, 66.0), "B3": (559.8, 36.0), "B4": (664.6, 31.0),
}
RGB_BANDS = ("B2", "B3", "B4")


def emit_wavelength_grid(n_bands: int = 285):
    """381-2493 nm evenly, and the good-band mask that blanks the two
    water-absorption windows."""
    wl = np.linspace(381.0, 2493.0, n_bands)
    good = np.ones(n_bands, dtype=bool)
    good &= ~((wl > 1325.0) & (wl < 1475.0))
    good &= ~((wl > 1770.0) & (wl < 1975.0))
    return wl, good


def endmember_spectra(wl: np.ndarray) -> np.ndarray:
    """(4, B) vegetation, soil, water, urban spectra in [0.01, 0.9]."""
    wl = np.asarray(wl, dtype=np.float64)
    x = (wl - wl.min()) / (wl.max() - wl.min())
    veg = (0.05 + 0.45 / (1.0 + np.exp(-(wl - 710.0) / 18.0))
           - 0.12 * np.exp(-0.5 * ((wl - 1450.0) / 90.0) ** 2)
           - 0.10 * np.exp(-0.5 * ((wl - 1940.0) / 110.0) ** 2)
           + 0.04 * np.exp(-0.5 * ((wl - 560.0) / 40.0) ** 2))
    soil = 0.12 + 0.35 * x - 0.06 * np.exp(-0.5 * ((wl - 2200.0) / 80.0) ** 2)
    water = 0.08 * np.exp(-3.0 * x) + 0.01
    urban = 0.35 + 0.15 * x
    return np.clip(np.stack([veg, soil, water, urban], axis=0), 0.01, 0.9)


def s2a_srf(bands: Sequence[str] = RGB_BANDS, exponent: float = 4.0,
            step_nm: float = 1.0):
    """{band: (nm, response)}: a super-Gaussian exp(-(2|x-c|/w)^(2p))
    sampled at 1 nm where the response exceeds 1e-4."""
    out = {}
    for b in bands:
        centre, width = S2A_BANDS[b]
        lam = np.arange(centre - width, centre + width + step_nm, step_nm)
        resp = np.exp(-((2.0 * np.abs(lam - centre) / width)
                        ** (2.0 * exponent)))
        keep = resp > 1e-4
        out[b] = (lam[keep].astype(np.float64), resp[keep].astype(np.float64))
    return out


def srf_weight_matrix(wl: np.ndarray, srf, good_mask=None,
                      bands: Sequence[str] = RGB_BANDS) -> np.ndarray:
    """(B, S) float32 W with synth = R @ W: each response interpolated
    onto the wavelengths (0 outside), times the good-band mask, over its
    trapezoid integral."""
    wl = np.asarray(wl, dtype=np.float64)
    tw = np.zeros_like(wl)
    dx = np.diff(wl)
    tw[:-1] += dx / 2.0
    tw[1:] += dx / 2.0
    cols = []
    for b in bands:
        lam, rsp = srf[b]
        r = np.interp(wl, lam, rsp, left=0.0, right=0.0)
        if good_mask is not None:
            r = r * np.asarray(good_mask, dtype=np.float64)
        cols.append(tw * r / (float(tw @ r) + 1e-32))
    return np.stack(cols, axis=1).astype(np.float32)

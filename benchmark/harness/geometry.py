"""Frozen copy of the projection and grid arithmetic the benchmark needs.

The scene generator and the plain reference both use it: the UTM
transverse Mercator of WGS84 (Karney's order-6 Krueger series), the
geographic <-> UTM transform, a north-up grid as plain numbers, and the
S2-anchored 60 m target grid. Copied from ``hyperres_torch/core/crs.py``
(``_kruger_coeffs``, ``tm_forward``, ``tm_inverse``) and
``hyperres_torch/core/grid.py`` (``Grid`` arithmetic, ``bounds_in``,
``snap_extent_to_anchor``, ``s2_anchored_target_grid``); NumPy float64
only. Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
_E = math.sqrt(WGS84_E2)
_N = WGS84_F / (2.0 - WGS84_F)
UTM_K0 = 0.9996
UTM_FALSE_EASTING = 500_000.0
UTM_FALSE_NORTHING_SOUTH = 10_000_000.0


def _kruger_coeffs(n: float):
    n2, n3, n4, n5, n6 = n * n, n**3, n**4, n**5, n**6
    rect_a = 1.0 + n2 / 4.0 + n4 / 64.0 + n6 / 256.0
    alpha = (
        n / 2.0 - 2.0 / 3.0 * n2 + 5.0 / 16.0 * n3 + 41.0 / 180.0 * n4
        - 127.0 / 288.0 * n5 + 7891.0 / 37800.0 * n6,
        13.0 / 48.0 * n2 - 3.0 / 5.0 * n3 + 557.0 / 1440.0 * n4
        + 281.0 / 630.0 * n5 - 1983433.0 / 1935360.0 * n6,
        61.0 / 240.0 * n3 - 103.0 / 140.0 * n4 + 15061.0 / 26880.0 * n5
        + 167603.0 / 181440.0 * n6,
        49561.0 / 161280.0 * n4 - 179.0 / 168.0 * n5
        + 6601661.0 / 7257600.0 * n6,
        34729.0 / 80640.0 * n5 - 3418889.0 / 1995840.0 * n6,
        212378941.0 / 319334400.0 * n6,
    )
    beta = (
        n / 2.0 - 2.0 / 3.0 * n2 + 37.0 / 96.0 * n3 - 1.0 / 360.0 * n4
        - 81.0 / 512.0 * n5 + 96199.0 / 604800.0 * n6,
        1.0 / 48.0 * n2 + 1.0 / 15.0 * n3 - 437.0 / 1440.0 * n4
        + 46.0 / 105.0 * n5 - 1118711.0 / 3870720.0 * n6,
        17.0 / 480.0 * n3 - 37.0 / 840.0 * n4 - 209.0 / 4480.0 * n5
        + 5569.0 / 90720.0 * n6,
        4397.0 / 161280.0 * n4 - 11.0 / 504.0 * n5
        - 830251.0 / 7257600.0 * n6,
        4583.0 / 161280.0 * n5 - 108847.0 / 3991680.0 * n6,
        20648693.0 / 638668800.0 * n6,
    )
    delta = (
        2.0 * n - 2.0 / 3.0 * n2 - 2.0 * n3 + 116.0 / 45.0 * n4
        + 26.0 / 45.0 * n5 - 2854.0 / 675.0 * n6,
        7.0 / 3.0 * n2 - 8.0 / 5.0 * n3 - 227.0 / 45.0 * n4
        + 2704.0 / 315.0 * n5 + 2323.0 / 945.0 * n6,
        56.0 / 15.0 * n3 - 136.0 / 35.0 * n4 - 1262.0 / 105.0 * n5
        + 73814.0 / 2835.0 * n6,
        4279.0 / 630.0 * n4 - 332.0 / 35.0 * n5 - 399572.0 / 14175.0 * n6,
        4174.0 / 315.0 * n5 - 144838.0 / 6237.0 * n6,
        601676.0 / 22275.0 * n6,
    )
    return rect_a, alpha, beta, delta


_RECT_A_FACTOR, _ALPHA, _BETA, _DELTA = _kruger_coeffs(_N)
_RECT_A = WGS84_A / (1.0 + _N) * _RECT_A_FACTOR


def tm_forward(lon_deg, lat_deg, lon0_deg, k0=UTM_K0, false_e=0.0,
               false_n=0.0):
    """Geographic (deg) -> transverse Mercator (m)."""
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lam = lon - math.radians(lon0_deg)
    lam = (lam + math.pi) % (2.0 * math.pi) - math.pi
    sphi = np.sin(lat)
    t = np.sinh(np.arctanh(sphi) - _E * np.arctanh(_E * sphi))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))
    xi, eta = xi_p, eta_p
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * np.sin(2.0 * j * xi_p) * np.cosh(2.0 * j * eta_p)
        eta = eta + a * np.cos(2.0 * j * xi_p) * np.sinh(2.0 * j * eta_p)
    return false_e + k0 * _RECT_A * eta, false_n + k0 * _RECT_A * xi


def tm_inverse(x, y, lon0_deg, k0=UTM_K0, false_e=0.0, false_n=0.0):
    """Transverse Mercator (m) -> geographic (deg)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xi = (y - false_n) / (k0 * _RECT_A)
    eta = (x - false_e) / (k0 * _RECT_A)
    xi_p, eta_p = xi, eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * np.sin(2.0 * j * xi) * np.cosh(2.0 * j * eta)
        eta_p = eta_p - b * np.cos(2.0 * j * xi) * np.sinh(2.0 * j * eta)
    chi = np.arcsin(np.clip(np.sin(xi_p) / np.cosh(eta_p), -1.0, 1.0))
    phi = chi
    for j, d in enumerate(_DELTA, start=1):
        phi = phi + d * np.sin(2.0 * j * chi)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.degrees(lam) + lon0_deg, np.degrees(phi)


@dataclass(frozen=True)
class Crs:
    """``"geographic"`` or ``"utm"`` with (zone, north)."""

    kind: str
    zone: int = 0
    north: bool = True

    def _tm(self):
        return (self.zone * 6 - 183, UTM_K0, UTM_FALSE_EASTING,
                0.0 if self.north else UTM_FALSE_NORTHING_SOUTH)

    def to_geographic(self, x, y):
        if self.kind == "geographic":
            return x, y
        return tm_inverse(x, y, *self._tm())

    def from_geographic(self, lon, lat):
        if self.kind == "geographic":
            return lon, lat
        return tm_forward(lon, lat, *self._tm())


GEOGRAPHIC = Crs("geographic")


def transform(src: Crs, dst: Crs, x, y):
    if src == dst:
        return x, y
    lon, lat = src.to_geographic(x, y)
    return dst.from_geographic(lon, lat)


@dataclass(frozen=True)
class GridSpec:
    """A north-up grid: x0 / y0 the outer corner of the top-left pixel,
    dx / dy > 0 (row step -dy)."""

    crs: Crs
    x0: float
    y0: float
    dx: float
    dy: float
    width: int
    height: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def bounds(self):
        return (self.x0, self.y0 - self.height * self.dy,
                self.x0 + self.width * self.dx, self.y0)

    def pixel_center_coords(self):
        return (self.x0 + (np.arange(self.width) + 0.5) * self.dx,
                self.y0 - (np.arange(self.height) + 0.5) * self.dy)

    def colrow_of(self, x, y):
        return ((x - self.x0) / self.dx - 0.5, (self.y0 - y) / self.dy - 0.5)

    def bounds_in(self, dst: Crs, densify: int = 21):
        left, bottom, right, top = self.bounds
        t = np.linspace(0.0, 1.0, densify)
        xs = np.concatenate([left + t * (right - left), np.full(densify, right),
                             right + t * (left - right), np.full(densify, left)])
        ys = np.concatenate([np.full(densify, top), top + t * (bottom - top),
                             np.full(densify, bottom), bottom + t * (top - bottom)])
        X, Y = transform(self.crs, dst, xs, ys)
        return (float(np.min(X)), float(np.min(Y)), float(np.max(X)),
                float(np.max(Y)))


def s2_anchored_target_grid(src: GridSpec, s2: GridSpec, xres: float = 60.0,
                            yres: float = 60.0) -> GridSpec:
    """The S2-anchored output grid: the source's bounds in the S2 CRS,
    intersected with the S2 extent and snapped inward to the lattice
    anchored at the S2 origin."""
    sb = src.bounds_in(s2.crs)
    b = s2.bounds
    left, bottom = max(sb[0], b[0]), max(sb[1], b[1])
    right, top = min(sb[2], b[2]), min(sb[3], b[3])
    if left >= right or bottom >= top:
        raise ValueError("no overlap between the source and the S2 extent")
    x0, y0, eps = s2.x0, s2.y0, 1e-9
    left2 = x0 + math.ceil(((left - x0) / xres) - eps) * xres
    right2 = x0 + math.floor(((right - x0) / xres) + eps) * xres
    top2 = y0 - math.ceil(((y0 - top) / yres) - eps) * yres
    bottom2 = y0 - math.floor(((y0 - bottom) / yres) + eps) * yres
    cols = int(round((right2 - left2) / xres))
    rows = int(round((top2 - bottom2) / yres))
    return GridSpec(s2.crs, left2, top2, xres, yres, cols, rows)

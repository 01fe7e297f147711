# Port-owned copy of hyperres/core/crs.py, verbatim apart from its imports.
"""Coordinate reference systems and projection math.

Self-contained replacement for the reference's use of pyproj/PROJ
(reference: EMIT_data/emit_proj.py:316, s2_data/s2_utils.py:79-95,
EMIT_data/EMIT_utils.py:51-73). The projections implemented are exactly the
ones the pipeline needs:

- geographic WGS84 (EPSG:4326) — EMIT ortho grids,
- UTM on WGS84 (EPSG:326xx/327xx) — Sentinel-2 grids and the S2-anchored
  EMIT 60 m product grid,
- Lambert cylindrical equal-area EPSG:6933 — equal-area overlap fractions,
- azimuthal equidistant (spherical) — point-buffer search bboxes.

The transverse Mercator implementation follows Karney's 6th-order Krüger
series ("Transverse Mercator with an accuracy of a few nanometers", 2011),
accurate to well under a millimetre anywhere within a UTM zone.

All projection math is written against an array-module parameter ``xp`` so
the identical code runs under numpy on the host and under ``jax.numpy``
inside jitted warp kernels (coordinate fields are then computed on-device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

from .constants import WGS84_A, WGS84_E2, WGS84_F

_E = math.sqrt(WGS84_E2)

# ---------------------------------------------------------------------------
# Krüger series coefficients (Karney 2011, order n^6), n = f / (2 - f)
# ---------------------------------------------------------------------------

_N = WGS84_F / (2.0 - WGS84_F)


def _kruger_coeffs(n: float):
    n2, n3, n4, n5, n6 = n * n, n**3, n**4, n**5, n**6
    rect_a = (
        1.0 + n2 / 4.0 + n4 / 64.0 + n6 / 256.0
    )  # A / (a / (1+n))
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
# Rectifying radius A
_RECT_A = WGS84_A / (1.0 + _N) * _RECT_A_FACTOR

UTM_K0 = 0.9996
UTM_FALSE_EASTING = 500_000.0
UTM_FALSE_NORTHING_SOUTH = 10_000_000.0


# ---------------------------------------------------------------------------
# Transverse Mercator core (elementwise; xp = numpy or jax.numpy)
# ---------------------------------------------------------------------------

def tm_forward(lon_deg, lat_deg, lon0_deg: float, k0: float = UTM_K0,
               false_e: float = 0.0, false_n: float = 0.0, xp: Any = np):
    """Geographic (deg) -> transverse Mercator (m). Karney series, order 6."""
    lon = xp.radians(xp.asarray(lon_deg, dtype=xp.float64)
                     if xp is np else xp.asarray(lon_deg))
    lat = xp.radians(xp.asarray(lat_deg, dtype=xp.float64)
                     if xp is np else xp.asarray(lat_deg))
    lam = lon - math.radians(lon0_deg)
    # wrap to [-pi, pi]
    lam = (lam + math.pi) % (2.0 * math.pi) - math.pi

    sphi = xp.sin(lat)
    t = xp.sinh(xp.arctanh(sphi) - _E * xp.arctanh(_E * sphi))
    xi_p = xp.arctan2(t, xp.cos(lam))
    eta_p = xp.arcsinh(xp.sin(lam) / xp.sqrt(t * t + xp.cos(lam) ** 2))

    xi = xi_p
    eta = eta_p
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * xp.sin(2.0 * j * xi_p) * xp.cosh(2.0 * j * eta_p)
        eta = eta + a * xp.cos(2.0 * j * xi_p) * xp.sinh(2.0 * j * eta_p)

    x = false_e + k0 * _RECT_A * eta
    y = false_n + k0 * _RECT_A * xi
    return x, y


def tm_inverse(x, y, lon0_deg: float, k0: float = UTM_K0,
               false_e: float = 0.0, false_n: float = 0.0, xp: Any = np):
    """Transverse Mercator (m) -> geographic (deg)."""
    x = xp.asarray(x, dtype=xp.float64) if xp is np else xp.asarray(x)
    y = xp.asarray(y, dtype=xp.float64) if xp is np else xp.asarray(y)
    xi = (y - false_n) / (k0 * _RECT_A)
    eta = (x - false_e) / (k0 * _RECT_A)

    xi_p = xi
    eta_p = eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * xp.sin(2.0 * j * xi) * xp.cosh(2.0 * j * eta)
        eta_p = eta_p - b * xp.cos(2.0 * j * xi) * xp.sinh(2.0 * j * eta)

    chi = xp.arcsin(xp.clip(xp.sin(xi_p) / xp.cosh(eta_p), -1.0, 1.0))
    phi = chi
    for j, d in enumerate(_DELTA, start=1):
        phi = phi + d * xp.sin(2.0 * j * chi)
    lam = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))

    lon = xp.degrees(lam) + lon0_deg
    lat = xp.degrees(phi)
    return lon, lat


# ---------------------------------------------------------------------------
# Lambert cylindrical equal area, EPSG:6933 (lat_ts = 30, lon0 = 0)
# ---------------------------------------------------------------------------

_CEA_LAT_TS = math.radians(30.0)
_CEA_K0 = math.cos(_CEA_LAT_TS) / math.sqrt(
    1.0 - WGS84_E2 * math.sin(_CEA_LAT_TS) ** 2)


def _authalic_q(sphi, xp: Any = np):
    return (1.0 - WGS84_E2) * (
        sphi / (1.0 - WGS84_E2 * sphi * sphi)
        - (1.0 / (2.0 * _E)) * xp.log((1.0 - _E * sphi) / (1.0 + _E * sphi))
    )


def cea6933_forward(lon_deg, lat_deg, xp: Any = np):
    """Geographic (deg) -> EPSG:6933 equal-area metres."""
    lon = xp.radians(xp.asarray(lon_deg, dtype=xp.float64)
                     if xp is np else xp.asarray(lon_deg))
    lat = xp.radians(xp.asarray(lat_deg, dtype=xp.float64)
                     if xp is np else xp.asarray(lat_deg))
    x = WGS84_A * _CEA_K0 * lon
    y = WGS84_A * _authalic_q(xp.sin(lat), xp=xp) / (2.0 * _CEA_K0)
    return x, y


# ---------------------------------------------------------------------------
# Azimuthal equidistant on the authalic sphere (search-buffer bboxes only;
# reference builds these with pyproj aeqd at EMIT_data/EMIT_utils.py:51-73)
# ---------------------------------------------------------------------------

_SPHERE_R = 6371007.1809  # authalic radius of WGS84


def aeqd_forward(lon_deg, lat_deg, lon0_deg: float, lat0_deg: float,
                 xp: Any = np):
    lon = xp.radians(xp.asarray(lon_deg, dtype=xp.float64)
                     if xp is np else xp.asarray(lon_deg))
    lat = xp.radians(xp.asarray(lat_deg, dtype=xp.float64)
                     if xp is np else xp.asarray(lat_deg))
    lon0 = math.radians(lon0_deg)
    lat0 = math.radians(lat0_deg)
    cos_c = (xp.sin(lat0) * xp.sin(lat)
             + xp.cos(lat0) * xp.cos(lat) * xp.cos(lon - lon0))
    c = xp.arccos(xp.clip(cos_c, -1.0, 1.0))
    sin_c = xp.sin(c)
    k = xp.where(sin_c == 0.0, 1.0, c / xp.where(sin_c == 0.0, 1.0, sin_c))
    x = _SPHERE_R * k * xp.cos(lat) * xp.sin(lon - lon0)
    y = _SPHERE_R * k * (xp.cos(lat0) * xp.sin(lat)
                         - xp.sin(lat0) * xp.cos(lat) * xp.cos(lon - lon0))
    return x, y


def aeqd_inverse(x, y, lon0_deg: float, lat0_deg: float, xp: Any = np):
    x = xp.asarray(x, dtype=xp.float64) if xp is np else xp.asarray(x)
    y = xp.asarray(y, dtype=xp.float64) if xp is np else xp.asarray(y)
    lat0 = math.radians(lat0_deg)
    rho = xp.sqrt(x * x + y * y)
    c = rho / _SPHERE_R
    safe_rho = xp.where(rho == 0.0, 1.0, rho)
    lat = xp.arcsin(xp.clip(
        xp.cos(c) * math.sin(lat0) + y * xp.sin(c) * math.cos(lat0) / safe_rho,
        -1.0, 1.0))
    lon = math.radians(lon0_deg) + xp.arctan2(
        x * xp.sin(c),
        safe_rho * xp.cos(c) * math.cos(lat0) - y * xp.sin(c) * math.sin(lat0))
    lat = xp.where(rho == 0.0, lat0, lat)
    lon = xp.where(rho == 0.0, math.radians(lon0_deg), lon)
    return xp.degrees(lon), xp.degrees(lat)


# ---------------------------------------------------------------------------
# CRS object
# ---------------------------------------------------------------------------

def utm_zone_from_lonlat(lon: float, lat: float) -> Tuple[int, bool]:
    zone = int(math.floor((lon + 180.0) / 6.0)) % 60 + 1
    return zone, lat >= 0.0


@dataclass(frozen=True)
class CRS:
    """A coordinate reference system. Hashable and comparable.

    kind: "geographic" | "utm" | "cea6933"
    For "utm": params = (zone, north).
    """

    kind: str
    params: tuple = ()

    # ---- constructors ----

    @staticmethod
    def geographic() -> "CRS":
        return CRS("geographic")

    @staticmethod
    def utm(zone: int, north: bool = True) -> "CRS":
        if not 1 <= zone <= 60:
            raise ValueError(f"Bad UTM zone {zone}")
        return CRS("utm", (int(zone), bool(north)))

    @staticmethod
    def cea6933() -> "CRS":
        return CRS("cea6933")

    @staticmethod
    def from_epsg(code: int) -> "CRS":
        code = int(code)
        if code == 4326:
            return CRS.geographic()
        if 32601 <= code <= 32660:
            return CRS.utm(code - 32600, north=True)
        if 32701 <= code <= 32760:
            return CRS.utm(code - 32700, north=False)
        if code == 6933:
            return CRS.cea6933()
        raise ValueError(f"Unsupported EPSG:{code}")

    @staticmethod
    def utm_for(lon: float, lat: float) -> "CRS":
        zone, north = utm_zone_from_lonlat(lon, lat)
        return CRS.utm(zone, north)

    # ---- properties ----

    @property
    def epsg(self) -> int:
        if self.kind == "geographic":
            return 4326
        if self.kind == "utm":
            zone, north = self.params
            return (32600 if north else 32700) + zone
        if self.kind == "cea6933":
            return 6933
        raise ValueError(self.kind)

    @property
    def is_geographic(self) -> bool:
        return self.kind == "geographic"

    def __str__(self) -> str:  # gdal-style
        return f"EPSG:{self.epsg}"

    def to_wkt(self) -> str:
        """Minimal WKT1 string for sidecar metadata (not for parsing)."""
        if self.kind == "geographic":
            return (
                'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",'
                '6378137,298.257223563]],PRIMEM["Greenwich",0],'
                'UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4326"]]'
            )
        if self.kind == "utm":
            zone, north = self.params
            hemi = "N" if north else "S"
            lon0 = zone * 6 - 183
            fn = 0.0 if north else UTM_FALSE_NORTHING_SOUTH
            return (
                f'PROJCS["WGS 84 / UTM zone {zone}{hemi}",'
                'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",'
                '6378137,298.257223563]],PRIMEM["Greenwich",0],'
                'UNIT["degree",0.0174532925199433]],'
                'PROJECTION["Transverse_Mercator"],'
                'PARAMETER["latitude_of_origin",0],'
                f'PARAMETER["central_meridian",{lon0}],'
                'PARAMETER["scale_factor",0.9996],'
                'PARAMETER["false_easting",500000],'
                f'PARAMETER["false_northing",{fn}],'
                'UNIT["metre",1],'
                f'AUTHORITY["EPSG","{self.epsg}"]]'
            )
        if self.kind == "cea6933":
            return (
                'PROJCS["WGS 84 / NSIDC EASE-Grid 2.0 Global",'
                'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",'
                '6378137,298.257223563]],PRIMEM["Greenwich",0],'
                'UNIT["degree",0.0174532925199433]],'
                'PROJECTION["Cylindrical_Equal_Area"],'
                'PARAMETER["standard_parallel_1",30],'
                'PARAMETER["central_meridian",0],'
                'PARAMETER["false_easting",0],'
                'PARAMETER["false_northing",0],UNIT["metre",1],'
                'AUTHORITY["EPSG","6933"]]'
            )
        raise ValueError(self.kind)

    # ---- transforms ----

    def _tm_params(self):
        zone, north = self.params
        lon0 = zone * 6 - 183
        fn = 0.0 if north else UTM_FALSE_NORTHING_SOUTH
        return lon0, UTM_K0, UTM_FALSE_EASTING, fn

    def to_geographic(self, x, y, xp: Any = np):
        """Projected coords -> (lon, lat) degrees."""
        if self.kind == "geographic":
            return x, y
        if self.kind == "utm":
            lon0, k0, fe, fn = self._tm_params()
            return tm_inverse(x, y, lon0, k0, fe, fn, xp=xp)
        raise ValueError(f"to_geographic not supported for {self.kind}")

    def from_geographic(self, lon, lat, xp: Any = np):
        """(lon, lat) degrees -> projected coords."""
        if self.kind == "geographic":
            return lon, lat
        if self.kind == "utm":
            lon0, k0, fe, fn = self._tm_params()
            return tm_forward(lon, lat, lon0, k0, fe, fn, xp=xp)
        if self.kind == "cea6933":
            return cea6933_forward(lon, lat, xp=xp)
        raise ValueError(f"from_geographic not supported for {self.kind}")


def transform(src: CRS, dst: CRS, x, y, xp: Any = np):
    """Transform coordinates between two CRS via the geographic hub."""
    if src == dst:
        return x, y
    lon, lat = src.to_geographic(x, y, xp=xp)
    return dst.from_geographic(lon, lat, xp=xp)


def polygon_area(xs, ys) -> float:
    """Shoelace area of a ring given vertex arrays (projected coords)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    return 0.5 * abs(float(
        np.dot(xs, np.roll(ys, -1)) - np.dot(ys, np.roll(xs, -1))))


def equal_area_sqm(lons, lats) -> float:
    """Area (m^2) of a lon/lat polygon via EPSG:6933, matching the
    reference's equal-area overlap computation (s2_data/s2_utils.py:82-95)."""
    x, y = cea6933_forward(np.asarray(lons), np.asarray(lats))
    return polygon_area(x, y)

# Port-owned copy of hyperres/catalog/geometry.py, verbatim apart from its
# imports and ``contains_points``, which runs matplotlib's crossing test
# (``Path.contains_points`` with radius 0) in NumPy, so that the port
# needs no matplotlib.
"""Lightweight lon/lat polygon geometry (shapely replacement).

Covers exactly what the pairing logic needs (s2_data/s2_utils.py:33-95):
UMM GPolygon parsing, equal-area polygon area via EPSG:6933, polygon
intersection for the EMIT-overlap fraction, bounds/centroid, and the
AEQD point-buffer bbox (EMIT_data/EMIT_utils.py:51-73).

Intersection uses Sutherland-Hodgman clipping, which is exact when the
clip polygon (the EMIT footprint, a ground-track quadrilateral) is
convex; non-convex clip polygons are clipped against their convex hull
(documented approximation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.crs import aeqd_inverse, cea6933_forward, polygon_area


@dataclass(frozen=True)
class LonLatPolygon:
    """A simple (single-ring, no holes) polygon in EPSG:4326."""

    ring: Tuple[Tuple[float, float], ...]  # closed not required

    @staticmethod
    def from_points(points: Sequence[Tuple[float, float]]
                    ) -> Optional["LonLatPolygon"]:
        pts = [(float(x), float(y)) for x, y in points
               if x is not None and y is not None]
        if len(pts) >= 2 and pts[0] == pts[-1]:
            pts = pts[:-1]
        if len(pts) < 3:
            return None
        return LonLatPolygon(tuple(pts))

    @staticmethod
    def from_bounds(left: float, bottom: float, right: float, top: float
                    ) -> "LonLatPolygon":
        return LonLatPolygon(((left, bottom), (right, bottom),
                              (right, top), (left, top)))

    @staticmethod
    def from_geojson(geom: dict) -> Optional["LonLatPolygon"]:
        """First/largest exterior ring of a GeoJSON Polygon/MultiPolygon."""
        if geom is None:
            return None
        gt = geom.get("type")
        if gt == "Polygon":
            rings = [geom["coordinates"][0]]
        elif gt == "MultiPolygon":
            rings = [poly[0] for poly in geom["coordinates"]]
        else:
            return None
        best = max(rings, key=lambda r: abs(_ring_area_lonlat(r)))
        return LonLatPolygon.from_points([(p[0], p[1]) for p in best])

    # ---- properties ----

    @property
    def is_empty(self) -> bool:
        return len(self.ring) < 3

    def bounds(self) -> Tuple[float, float, float, float]:
        xs = [p[0] for p in self.ring]
        ys = [p[1] for p in self.ring]
        return (min(xs), min(ys), max(xs), max(ys))

    def centroid(self) -> Tuple[float, float]:
        xs = np.array([p[0] for p in self.ring])
        ys = np.array([p[1] for p in self.ring])
        x2 = np.roll(xs, -1)
        y2 = np.roll(ys, -1)
        cross = xs * y2 - x2 * ys
        a = cross.sum() / 2.0
        if abs(a) < 1e-12:
            return float(xs.mean()), float(ys.mean())
        cx = ((xs + x2) * cross).sum() / (6.0 * a)
        cy = ((ys + y2) * cross).sum() / (6.0 * a)
        return float(cx), float(cy)

    def area_m2(self) -> float:
        """Equal-area (EPSG:6933) polygon area, the reference's area_m2
        (s2_utils.py:82-88)."""
        lons = np.array([p[0] for p in self.ring])
        lats = np.array([p[1] for p in self.ring])
        x, y = cea6933_forward(lons, lats)
        return polygon_area(x, y)

    def is_convex(self) -> bool:
        pts = np.asarray(self.ring, dtype=np.float64)
        n = len(pts)
        sign = 0.0
        for i in range(n):
            a, b, c = pts[i], pts[(i + 1) % n], pts[(i + 2) % n]
            cross = (b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0])
            if abs(cross) < 1e-15:
                continue
            if sign == 0.0:
                sign = np.sign(cross)
            elif np.sign(cross) != sign:
                return False
        return True

    def convex_hull(self) -> "LonLatPolygon":
        pts = sorted(set(self.ring))
        if len(pts) < 3:
            return self

        def half(points):
            out = []
            for p in points:
                while len(out) >= 2 and (
                        (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                        - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])
                        <= 0):
                    out.pop()
                out.append(p)
            return out

        lower = half(pts)
        upper = half(pts[::-1])
        return LonLatPolygon(tuple(lower[:-1] + upper[:-1]))

    def intersection(self, clip: "LonLatPolygon") -> Optional["LonLatPolygon"]:
        """Sutherland-Hodgman clip of self against ``clip`` (convexified
        if necessary). Returns None on empty intersection."""
        if self.is_empty or clip.is_empty:
            return None
        clip_poly = clip if clip.is_convex() else clip.convex_hull()
        cpts = list(clip_poly.ring)
        # ensure counter-clockwise clip ring
        if _ring_area_lonlat(cpts) < 0:
            cpts = cpts[::-1]
        output = list(self.ring)
        for i in range(len(cpts)):
            a = cpts[i]
            b = cpts[(i + 1) % len(cpts)]
            input_pts = output
            output = []
            if not input_pts:
                return None

            def inside(p):
                return ((b[0] - a[0]) * (p[1] - a[1])
                        - (b[1] - a[1]) * (p[0] - a[0])) >= -1e-15

            def intersect(p, q):
                dc = (a[0] - b[0], a[1] - b[1])
                dp = (p[0] - q[0], p[1] - q[1])
                n1 = a[0] * b[1] - a[1] * b[0]
                n2 = p[0] * q[1] - p[1] * q[0]
                denom = dc[0] * dp[1] - dc[1] * dp[0]
                if abs(denom) < 1e-18:
                    return q
                return ((n1 * dp[0] - n2 * dc[0]) / denom,
                        (n1 * dp[1] - n2 * dc[1]) / denom)

            s = input_pts[-1]
            for e in input_pts:
                if inside(e):
                    if not inside(s):
                        output.append(intersect(s, e))
                    output.append(e)
                elif inside(s):
                    output.append(intersect(s, e))
                s = e
        if len(output) < 3:
            return None
        return LonLatPolygon(tuple(output))

    def contains_points(self, lons: np.ndarray, lats: np.ndarray) -> np.ndarray:
        """Vectorised point-in-polygon: the crossing test of matplotlib's
        ``Path.contains_points`` (radius 0) on the implicitly closed
        ring, the same comparisons in float64; points with a non-finite
        coordinate are outside."""
        ring = np.asarray(self.ring, dtype=np.float64)
        tx = np.ravel(np.asarray(lons, dtype=np.float64))
        ty = np.ravel(np.asarray(lats, dtype=np.float64))
        inside = np.zeros(tx.shape, dtype=bool)
        if len(ring) < 3:
            return inside.reshape(np.shape(lons))
        finite = np.isfinite(tx) & np.isfinite(ty)
        vtx0, vty0 = ring[0]
        yflag0 = vty0 >= ty
        for vtx1, vty1 in np.concatenate([ring[1:], ring[:1]]):
            yflag1 = vty1 >= ty
            hit = (((vty1 - ty) * (vtx0 - vtx1)
                    >= (vtx1 - tx) * (vty0 - vty1)) == yflag1)
            inside ^= (yflag0 != yflag1) & hit
            yflag0 = yflag1
            vtx0, vty0 = vtx1, vty1
        return (inside & finite).reshape(np.shape(lons))


def _ring_area_lonlat(ring) -> float:
    pts = np.asarray([(p[0], p[1]) for p in ring], dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def emit_geom_wgs84_from_umm(umm: dict) -> Optional[LonLatPolygon]:
    """Largest UMM GPolygon as a polygon (s2_utils.py:33-66; the reference
    unions all GPolygons — granules carry one footprint in practice, so
    the largest ring is used)."""
    gpolys = (
        (umm.get("SpatialExtent") or {})
        .get("HorizontalSpatialDomain", {})
        .get("Geometry", {})
        .get("GPolygons", [])
    )
    polys = []
    for gp in gpolys:
        pts = (gp.get("Boundary") or {}).get("Points", [])
        poly = LonLatPolygon.from_points(
            [(p.get("Longitude"), p.get("Latitude")) for p in pts])
        if poly is not None:
            polys.append(poly)
    if not polys:
        return None
    return max(polys, key=lambda p: p.area_m2())


def overlap_emit_fraction(emit_geom: LonLatPolygon,
                          s2_geom: LonLatPolygon
                          ) -> Tuple[float, Optional[LonLatPolygon]]:
    """(fraction of EMIT covered, overlap polygon) —
    s2_utils.py:90-95."""
    inter = s2_geom.intersection(emit_geom)
    if inter is None:
        return 0.0, None
    a_inter = inter.area_m2()
    a_emit = max(emit_geom.area_m2(), 1e-9)
    return a_inter / a_emit, inter


def point_buffer_bbox(lon: float, lat: float, meters: float
                      ) -> Tuple[float, float, float, float]:
    """Geodesic point-buffer bbox via AEQD (EMIT_utils.py:51-73)."""
    xs = np.array([-meters, meters, 0.0, 0.0])
    ys = np.array([0.0, 0.0, -meters, meters])
    lons, lats = aeqd_inverse(xs, ys, lon, lat)
    return (float(np.min(lons)), float(np.min(lats)),
            float(np.max(lons)), float(np.max(lats)))

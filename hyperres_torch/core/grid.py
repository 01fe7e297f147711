# Port-owned copy of hyperres/core/grid.py, verbatim apart from its imports.
"""Raster grids: geotransforms, bounds, windows, and S2-anchored snapping.

Replaces the reference's mix of rasterio transforms and hand-rolled snap
math. The snapping contract is the reference's ``_compute_te``
(EMIT_data/emit_proj.py:354-382): the output grid is anchored at the
Sentinel-2 grid origin, the target extent is the EMIT/S2 intersection
snapped *inward* to whole 60 m cells of that anchored lattice, and 60 m
must be an integer multiple of the S2 pixel size
(EMIT_data/emit_proj.py:791-797).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import numpy as np

from .crs import CRS, transform as crs_transform

Bounds = Tuple[float, float, float, float]  # (left, bottom, right, top)


@dataclass(frozen=True)
class Window:
    """A pixel window (column/row offsets + size), rasterio-style."""

    col_off: int
    row_off: int
    width: int
    height: int

    def slices(self) -> Tuple[slice, slice]:
        return (slice(self.row_off, self.row_off + self.height),
                slice(self.col_off, self.col_off + self.width))


@dataclass(frozen=True)
class Grid:
    """A north-up raster grid: CRS + GDAL-style geotransform + shape.

    transform = (x0, dx, 0, y0, 0, -dy) with dx, dy > 0; x0/y0 is the
    outer corner of the top-left pixel. Rotated grids are rejected, same
    as the reference (EMIT_data/emit_proj.py:675-680).
    """

    crs: CRS
    x0: float
    y0: float
    dx: float
    dy: float  # positive; row step is -dy
    width: int
    height: int

    def __post_init__(self):
        if self.dx <= 0 or self.dy <= 0:
            raise ValueError(f"Pixel sizes must be positive: {self.dx}, {self.dy}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"Grid shape must be positive: {self.width}x{self.height}")

    # ---- constructors ----

    @staticmethod
    def from_geotransform(crs: CRS, gt, width: int, height: int) -> "Grid":
        gt = [float(v) for v in gt]
        if abs(gt[2]) > 1e-12 or abs(gt[4]) > 1e-12:
            raise ValueError(
                "Rotated/sheared geotransform not supported "
                f"(gt={gt})")
        return Grid(crs, gt[0], gt[3], gt[1], -gt[5], int(width), int(height))

    @staticmethod
    def from_bounds(crs: CRS, bounds: Bounds, dx: float, dy: float) -> "Grid":
        left, bottom, right, top = map(float, bounds)
        width = int(round((right - left) / dx))
        height = int(round((top - bottom) / dy))
        return Grid(crs, left, top, dx, dy, width, height)

    # ---- basic properties ----

    @property
    def geotransform(self) -> Tuple[float, float, float, float, float, float]:
        return (self.x0, self.dx, 0.0, self.y0, 0.0, -self.dy)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def bounds(self) -> Bounds:
        return (self.x0, self.y0 - self.height * self.dy,
                self.x0 + self.width * self.dx, self.y0)

    def pixel_center_coords(self, xp: Any = np):
        """(x, y) 1-D arrays of pixel-centre coordinates."""
        xs = self.x0 + (xp.arange(self.width) + 0.5) * self.dx
        ys = self.y0 - (xp.arange(self.height) + 0.5) * self.dy
        return xs, ys

    def xy_of(self, col, row, xp: Any = np):
        """Pixel-centre coordinate of fractional (col, row)."""
        return (self.x0 + (col + 0.5) * self.dx,
                self.y0 - (row + 0.5) * self.dy)

    def colrow_of(self, x, y, xp: Any = np):
        """Fractional (col, row) of a coordinate; pixel centres at integers."""
        return ((x - self.x0) / self.dx - 0.5,
                (self.y0 - y) / self.dy - 0.5)

    # ---- windows ----

    def window_of(self, bounds: Bounds) -> Window:
        """Pixel window covering ``bounds``, offsets/lengths rounded like
        rasterio's ``from_bounds().round_offsets().round_lengths()``
        (reference: s2_emit/synth.py:79-80)."""
        left, bottom, right, top = bounds
        col0 = int(round((left - self.x0) / self.dx))
        row0 = int(round((self.y0 - top) / self.dy))
        ncols = int(round((right - left) / self.dx))
        nrows = int(round((top - bottom) / self.dy))
        return Window(col0, row0, ncols, nrows)

    def window_grid(self, win: Window) -> "Grid":
        return replace(
            self,
            x0=self.x0 + win.col_off * self.dx,
            y0=self.y0 - win.row_off * self.dy,
            width=win.width,
            height=win.height,
        )

    def crop(self, bounds: Bounds) -> Tuple["Grid", Window]:
        win = self.window_of(bounds)
        return self.window_grid(win), win

    # ---- reprojection helpers ----

    def bounds_in(self, dst_crs: CRS, densify: int = 21) -> Bounds:
        """Grid bounds transformed to ``dst_crs`` by densifying the outline
        (the GDAL approach to curved edges under reprojection)."""
        left, bottom, right, top = self.bounds
        t = np.linspace(0.0, 1.0, densify)
        xs = np.concatenate([
            left + t * (right - left),            # top edge
            np.full(densify, right),              # right edge
            right + t * (left - right),           # bottom edge
            np.full(densify, left),               # left edge
        ])
        ys = np.concatenate([
            np.full(densify, top),
            top + t * (bottom - top),
            np.full(densify, bottom),
            bottom + t * (top - bottom),
        ])
        X, Y = crs_transform(self.crs, dst_crs, xs, ys)
        return (float(np.min(X)), float(np.min(Y)),
                float(np.max(X)), float(np.max(Y)))


def intersect_bounds(a: Bounds, b: Bounds) -> Optional[Bounds]:
    left = max(a[0], b[0])
    bottom = max(a[1], b[1])
    right = min(a[2], b[2])
    top = min(a[3], b[3])
    if left >= right or bottom >= top:
        return None
    return (left, bottom, right, top)


def snap_extent_to_anchor(
    bounds: Bounds,
    anchor_xy: Tuple[float, float],
    xres: float,
    yres: float,
    inward: bool = True,
) -> Bounds:
    """Snap an extent to the lattice defined by ``anchor_xy`` and the step
    (xres, yres). ``inward=True`` reproduces ``_compute_te``
    (EMIT_data/emit_proj.py:354-382): left/top move inward via ceil, and
    right/bottom inward via floor, with a 1e-9 epsilon guard."""
    left, bottom, right, top = map(float, bounds)
    x0, y0 = map(float, anchor_xy)
    eps = 1e-9
    if inward:
        left2 = x0 + math.ceil(((left - x0) / xres) - eps) * xres
        right2 = x0 + math.floor(((right - x0) / xres) + eps) * xres
        top2 = y0 - math.ceil(((y0 - top) / yres) - eps) * yres
        bottom2 = y0 - math.floor(((y0 - bottom) / yres) + eps) * yres
    else:
        left2 = x0 + math.floor(((left - x0) / xres) + eps) * xres
        right2 = x0 + math.ceil(((right - x0) / xres) - eps) * xres
        top2 = y0 - math.floor(((y0 - top) / yres) + eps) * yres
        bottom2 = y0 - math.ceil(((y0 - bottom) / yres) - eps) * yres
    if right2 <= left2 or top2 <= bottom2:
        raise ValueError(f"Snapped extent is invalid: {(left2, bottom2, right2, top2)}")
    return (left2, bottom2, right2, top2)


def s2_anchored_target_grid(
    src_grid: Grid,
    s2_grid: Grid,
    xres: float = 60.0,
    yres: float = 60.0,
) -> Grid:
    """Compute the S2-anchored 60 m output grid for an EMIT source.

    Mirrors the gdalwarp target-extent logic of the reference
    (EMIT_data/emit_proj.py:876-940 + ``_compute_te`` :354-382):
    intersect the source bounds (transformed to the S2 CRS) with the S2
    extent, then snap inward to the lattice anchored at the S2 origin.
    Enforces the 60-m-divides-S2-resolution contract
    (EMIT_data/emit_proj.py:791-797).
    """
    for step, s2_res in ((xres, s2_grid.dx), (yres, s2_grid.dy)):
        ratio = step / s2_res
        if abs(ratio - round(ratio)) > 1e-9:
            raise ValueError(
                f"target step {step} must be an integer multiple of S2 "
                f"resolution {s2_res}")

    src_bounds = src_grid.bounds_in(s2_grid.crs)
    inter = intersect_bounds(src_bounds, s2_grid.bounds)
    if inter is None:
        raise ValueError(
            "No overlap between source bounds and S2 extent in target CRS.")
    te = snap_extent_to_anchor(inter, (s2_grid.x0, s2_grid.y0), xres, yres)
    left, bottom, right, top = te
    cols = int(round((right - left) / xres))
    rows = int(round((top - bottom) / yres))
    if cols <= 0 or rows <= 0:
        raise ValueError(f"Bad target shape cols={cols}, rows={rows}")
    return Grid(s2_grid.crs, left, top, xres, yres, cols, rows)

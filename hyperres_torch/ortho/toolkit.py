# Port-owned copy of hyperres/ortho/toolkit.py: ``spatial_subset`` and
# ``ortho_browse`` verbatim (host code, as there); ``merge_emit`` gathers,
# places and composites each granule on ``device`` and fetches the mosaic
# once at the end.
"""Granule toolkit: raw-space subsetting, multi-granule mosaics, browse
orthos — the EMIT toolkit operations beyond the main product pipeline
(reference: EMIT_data/emit_tools.py ``spatial_subset`` :529-619,
``merge_emit`` :631-704, ``ortho_browse`` :707-736)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constants import GLT_NODATA_VALUE, NO_DATA_VALUE
from ..core.crs import CRS
from ..core.grid import Grid
from ..catalog.geometry import LonLatPolygon
from ..device import resolve_device
from ..io.granule import EmitGranule, apply_glt
from ..kernels.glt import orthorectify
from ..kernels.warp import resample_tensor_to_grid


@dataclass
class RawSubset:
    data: np.ndarray          # (h, w, B) raw-space subset
    glt: np.ndarray           # (Ho', Wo', 2) re-based 1-based GLT
    ortho_grid: Grid          # cropped ortho grid
    raw_window: Tuple[int, int, int, int]  # (row0, row1, col0, col1)


def spatial_subset(granule: EmitGranule,
                   polygon: LonLatPolygon) -> RawSubset:
    """Subset a granule in raw (swath) space to the pixels that map into
    ``polygon`` (lon/lat), with a re-based GLT so the subset remains
    orthorectifiable — emit_tools.spatial_subset semantics (:529-619)."""
    og = granule.ortho_grid
    xs, ys = og.pixel_center_coords()
    lon, lat = np.meshgrid(xs, ys)
    inside = polygon.contains_points(lon, lat)

    glt = granule.glt
    valid = np.all(glt != GLT_NODATA_VALUE, axis=-1) & inside
    if not valid.any():
        raise ValueError("Polygon selects no valid GLT cells")

    gx = glt[..., 0][valid] - 1
    gy = glt[..., 1][valid] - 1
    row0, row1 = int(gy.min()), int(gy.max()) + 1
    col0, col1 = int(gx.min()), int(gx.max()) + 1

    # ortho crop to the polygon's cell bbox
    oy, ox = np.nonzero(inside)
    or0, or1 = int(oy.min()), int(oy.max()) + 1
    oc0, oc1 = int(ox.min()), int(ox.max()) + 1
    sub_glt = glt[or0:or1, oc0:oc1].copy()
    sub_valid = np.all(sub_glt != GLT_NODATA_VALUE, axis=-1)
    # re-base to the raw window (stay 1-based, 0 = nodata); entries that
    # fall outside the window become nodata
    gx2 = sub_glt[..., 0] - col0
    gy2 = sub_glt[..., 1] - row0
    ok = (sub_valid & (gx2 >= 1) & (gx2 <= col1 - col0)
          & (gy2 >= 1) & (gy2 <= row1 - row0))
    sub_glt[..., 0] = np.where(ok, gx2, 0)
    sub_glt[..., 1] = np.where(ok, gy2, 0)

    # band-chunked read + per-slab window slice: never materialize the
    # full raw cube on the host (~3.4 GB for a real 285-band granule)
    slabs = []
    for b0 in range(0, granule.n_bands, 32):
        slab = granule.read_bands(b0, min(b0 + 32, granule.n_bands))
        slabs.append(slab[row0:row1, col0:col1, :])
    data = np.concatenate(slabs, axis=-1)
    from dataclasses import replace
    sub_grid = replace(og,
                       x0=og.x0 + oc0 * og.dx,
                       y0=og.y0 - or0 * og.dy,
                       width=oc1 - oc0, height=or1 - or0)
    return RawSubset(data=data, glt=sub_glt, ortho_grid=sub_grid,
                     raw_window=(row0, row1, col0, col1))


def merge_emit(granules: Sequence[EmitGranule],
               resolution_deg: Optional[Tuple[float, float]] = None,
               device=None) -> Tuple[np.ndarray, Grid]:
    """Mosaic multiple orthorectified granules onto a shared geographic
    grid, first-granule-wins where footprints overlap — the merge_emit /
    rioxarray.merge_arrays behaviour (:631-704). Returns
    ((H, W, B) float32 with -9999 nodata, grid).

    Each granule is read on the host (``read_cube``), gathered through
    its GLT, placed by nearest sampling onto its window of the mosaic
    lattice and composited into a mosaic that stays on ``device``
    (default the current CUDA device; ``"cpu"`` for the CPU); the mosaic
    is fetched once at the end."""
    if not granules:
        raise ValueError("No granules to merge")
    b = granules[0].n_bands
    for g in granules[1:]:
        if g.n_bands != b:
            raise ValueError("Granules have differing band counts")
    dev = resolve_device(device)

    grids = [g.ortho_grid for g in granules]
    if resolution_deg is None:
        dx = min(gr.dx for gr in grids)
        dy = min(gr.dy for gr in grids)
    else:
        dx, dy = resolution_deg
    left = min(gr.bounds[0] for gr in grids)
    bottom = min(gr.bounds[1] for gr in grids)
    right = max(gr.bounds[2] for gr in grids)
    top = max(gr.bounds[3] for gr in grids)
    width = int(np.ceil((right - left) / dx))
    height = int(np.ceil((top - bottom) / dy))
    out_grid = Grid(CRS.geographic(), left, top, dx, dy, width, height)

    from dataclasses import replace

    out = torch.full((height, width, b), NO_DATA_VALUE, dtype=torch.float32,
                     device=dev)
    for g in granules:
        gr = g.ortho_grid
        # mosaic-lattice-aligned window covering this granule's footprint
        # (clipped to the mosaic; granule cells outside it are dropped,
        # not smeared onto the edge)
        gl, gb, grt, gt = gr.bounds
        c0 = max(0, int(np.floor((gl - out_grid.x0) / dx)))
        c1 = min(width, int(np.ceil((grt - out_grid.x0) / dx)))
        r0 = max(0, int(np.floor((out_grid.y0 - gt) / dy)))
        r1 = min(height, int(np.ceil((out_grid.y0 - gb) / dy)))
        if c0 >= c1 or r0 >= r1:
            continue
        sub_grid = replace(out_grid,
                           x0=out_grid.x0 + c0 * dx,
                           y0=out_grid.y0 - r0 * dy,
                           width=c1 - c0, height=r1 - r0)
        ortho = orthorectify(g.read_cube(), g.glt, device=dev)
        # proper nearest resampling onto the mosaic lattice (the
        # rioxarray.merge_arrays behaviour) — each destination cell samples
        # its own nearest source cell, so off-lattice grids land within
        # half a pixel and out-of-window cells become nodata
        sub = resample_tensor_to_grid(
            ortho.to(torch.float32), gr, sub_grid, method="nearest",
            nodata=NO_DATA_VALUE, fill=NO_DATA_VALUE)
        del ortho
        region = out[r0:r1, c0:c1]
        take = ((sub[..., 0] != NO_DATA_VALUE)
                & (region[..., 0] == NO_DATA_VALUE))  # first wins
        region[take] = sub[take]
        del sub
    return out.cpu().numpy(), out_grid


def ortho_browse(rgb_raw: np.ndarray, glt: np.ndarray,
                 fill: float = 0.0) -> np.ndarray:
    """Orthorectify a browse RGB image through the GLT
    (emit_tools.ortho_browse :707-736)."""
    out = apply_glt(rgb_raw.astype(np.float32), np.asarray(glt),
                    fill_value=fill)
    if rgb_raw.dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return out

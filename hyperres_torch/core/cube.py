# Port-owned copy of hyperres/core/cube.py (Raster :23, SpectralCube :46,
# subsample_bands_evenly :91), verbatim apart from this header and two
# comments that named the TPU's array type and matrix unit.
"""Spectral cube and raster containers.

The framework-wide in-memory layout is **bands-last** ``(H, W, B)`` float32
for spectral cubes (matching the reference's analysis layout,
s2_emit/emit_io.py:7-16) and ``(B, H, W)`` for band stacks at file
boundaries. Device code operates on bands-last because the hot ops (GLT
gather, SRF matmul) contract over the trailing spectral axis, which maps
straight onto matrix-unit tiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

import numpy as np

from .constants import NO_DATA_VALUE
from .grid import Grid


@dataclass
class Raster:
    """A georeferenced band stack: data (B, H, W) + grid + nodata."""

    data: Any  # np.ndarray or torch.Tensor, (B, H, W)
    grid: Grid
    nodata: Optional[float] = None
    band_names: Optional[list] = None
    tags: Dict[str, str] = field(default_factory=dict)
    band_tags: Optional[list] = None  # list of dicts, one per band

    @property
    def count(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self, xp: Any = np):
        """(H, W) mask of pixels finite and != nodata in every band."""
        ok = xp.isfinite(self.data).all(axis=0)
        if self.nodata is not None:
            ok = ok & (self.data != self.nodata).all(axis=0)
        return ok


@dataclass
class SpectralCube:
    """A hyperspectral cube: data (H, W, B) + wavelengths + grid."""

    data: Any  # (H, W, B) float32
    grid: Optional[Grid]
    wavelengths: np.ndarray  # (B,) nm
    fwhm: Optional[np.ndarray] = None  # (B,) nm
    good_bands: Optional[np.ndarray] = None  # (B,) bool
    nodata: float = NO_DATA_VALUE
    tags: Dict[str, str] = field(default_factory=dict)

    @property
    def n_bands(self) -> int:
        return int(self.data.shape[-1])

    @property
    def shape(self):
        return self.data.shape

    def band_nearest(self, target_nm: float) -> int:
        """0-based index of the band closest to ``target_nm``
        (reference: s2_emit/arosics_coreg.py:23-24)."""
        return int(np.argmin(np.abs(
            np.asarray(self.wavelengths, dtype=np.float64) - float(target_nm))))

    def valid_mask(self, xp: Any = np):
        d = self.data
        ok = xp.isfinite(d).all(axis=-1)
        if self.nodata is not None:
            ok = ok & (d != self.nodata).all(axis=-1)
        return ok

    def to_raster(self) -> Raster:
        return Raster(
            data=np.moveaxis(np.asarray(self.data), -1, 0),
            grid=self.grid,
            nodata=self.nodata,
            band_names=[f"{w:.2f} nm" for w in np.asarray(self.wavelengths)],
            tags=dict(self.tags),
        )

    def with_data(self, data) -> "SpectralCube":
        return replace(self, data=data)


def subsample_bands_evenly(num_bands_total: int, num_keep: int = 32) -> np.ndarray:
    """Evenly spaced band subset with midpoint fill-in on collisions,
    matching the reference (tiles_helpers/utils.py:444-458)."""
    idx = np.linspace(0, num_bands_total - 1, num_keep).round().astype(int)
    idx = np.unique(idx)
    while len(idx) < num_keep:
        missing = num_keep - len(idx)
        add = []
        for i in range(len(idx) - 1):
            if len(add) >= missing:
                break
            mid = (idx[i] + idx[i + 1]) // 2
            add.append(int(mid))
        new_idx = np.unique(np.concatenate([idx, np.array(add, dtype=int)]))
        if len(new_idx) == len(idx):
            break  # cannot refine further
        idx = new_idx
    return idx[:num_keep]

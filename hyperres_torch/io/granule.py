# Port-owned copy of hyperres/io/granule.py, verbatim apart from its imports.
"""EMIT granule access.

Replaces the reference's netCDF4/h5netcdf granule opening
(EMIT_data/emit_proj.py:607-720, EMIT_data/emit_tools.py:34-125,
s2_emit/emit_io.py:18-31) with the framework's own HDF5 codec.

Contracts preserved:
- product detection by variable name ('radiance' -> L1B_RDN,
  'reflectance' -> L2A_RFL), emit_proj.py:635-644;
- GLT from location/glt_x, glt_y: NaN -> 0, int32, 1-based, 0 = nodata,
  plus out-of-bounds validation with drop diagnostics, emit_proj.py:682-720;
- raw dimension-order sniffing (downtrack, crosstrack, bands) with
  transpose fallback, emit_proj.py:646-661;
- wavelengths/fwhm/good_wavelengths from sensor_band_parameters with
  micrometre -> nanometre normalisation, s2_emit/arosics_coreg.py:27-75;
- mask-file semantics: quality_mask forbids data bands 5/6 and clips the
  flag sum to 1; band_mask unpacks packed bits to 285 bands,
  EMIT_data/emit_tools.py:271-321.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..core.constants import EMIT_BANDS, GLT_NODATA_VALUE
from ..core.crs import CRS
from ..core.grid import Grid
from .hdf5 import HDF5File


@dataclass
class GltDiagnostics:
    raw_shape_yx: Tuple[int, int]
    valid_count: int
    in_bounds_count: int
    dropped_oob: int


class EmitGranule:
    """An open EMIT L1B_RDN / L2A_RFL granule."""

    DATA_VARS = ("radiance", "reflectance")

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._f = HDF5File(self.path)
        root = self._f.root

        self.product: Optional[str] = None
        self.data_var: Optional[str] = None
        self._data = None
        for var, product in (("radiance", "L1B_RDN"),
                             ("reflectance", "L2A_RFL"),
                             ("obs", "L1B_OBS")):
            if var in root.datasets:
                self.data_var = var
                self.product = product
                self._data = root.datasets[var]
                break
        if self._data is None:
            # reference fallback (emit_proj.py:52-61): the first 3-D
            # variable in root or a first-level group (real OBS/LOC
            # products name their cube after the product)
            for name, ds in root.datasets.items():
                if len(ds.shape) == 3:
                    self.data_var, self.product, self._data = (
                        name, name.upper(), ds)
                    break
            else:
                for grp in root.groups.values():
                    for name, ds in grp.datasets.items():
                        if len(ds.shape) == 3:
                            self.data_var, self.product, self._data = (
                                name, name.upper(), ds)
                            break
                    if self._data is not None:
                        break
        if self._data is None:
            raise ValueError(
                "Unrecognized EMIT granule (no 'radiance'/'reflectance'/"
                f"'obs' or other 3-D variable): {self.path}")
        dims = self._data.attrs.get("dimensions")
        if isinstance(dims, str):
            dims = dims.replace(",", " ").split()
        self.transpose_raw_yx = False
        if isinstance(dims, (list, tuple)) and len(dims) >= 2:
            d0, d1 = str(dims[0]).lower(), str(dims[1]).lower()
            if ("crosstrack" in d0 and "downtrack" in d1) or (
                    d0 == "x" and d1 == "y"):
                self.transpose_raw_yx = True

        shape = self._data.shape
        if self.transpose_raw_yx:
            self.raw_height, self.raw_width = int(shape[1]), int(shape[0])
        else:
            self.raw_height, self.raw_width = int(shape[0]), int(shape[1])
        self.n_bands = int(shape[2]) if len(shape) > 2 else 1

        # sensor_band_parameters: spectral products carry wavelengths;
        # OBS granules carry observation_bands (string names) instead
        sbp = root.groups.get("sensor_band_parameters")
        self.wavelengths: Optional[np.ndarray] = None
        self.fwhm = None
        self.good_wavelengths = None
        self.band_names = None
        if sbp is not None:
            if "wavelengths" in sbp.datasets:
                wl = np.asarray(sbp.datasets["wavelengths"].read(),
                                dtype=np.float64)
                units = str(sbp.datasets["wavelengths"].attrs.get(
                    "units", "")).lower()
                if units in ("micrometers", "um", "µm") or (
                        units == "" and wl.max() < 100.0):
                    # micrometre heuristic (EMIT_utils.py:145-146)
                    wl = wl * 1000.0
                self.wavelengths = wl
            if "fwhm" in sbp.datasets:
                self.fwhm = np.asarray(sbp.datasets["fwhm"].read(),
                                       dtype=np.float64)
            if "good_wavelengths" in sbp.datasets:
                self.good_wavelengths = (
                    np.asarray(sbp.datasets["good_wavelengths"].read()) > 0)
            if "observation_bands" in sbp.datasets:
                bn = sbp.datasets["observation_bands"].read()
                self.band_names = [
                    b.decode() if isinstance(b, bytes) else str(b)
                    for b in np.ravel(bn)]
        if self.wavelengths is None and self.product in (
                "L1B_RDN", "L2A_RFL"):
            raise ValueError(
                f"{self.product} granule without sensor_band_parameters/"
                f"wavelengths: {self.path}")

        # geotransform (root attribute, array of 6 doubles)
        gt = np.asarray(self.attr("geotransform"), dtype=np.float64)
        if gt.size != 6:
            raise ValueError(f"Expected 6-element geotransform, got {gt}")
        if abs(gt[2]) > 1e-12 or abs(gt[4]) > 1e-12:
            raise ValueError(
                "Rotated/sheared geotransform not supported "
                f"(gt={gt.tolist()})")
        self.geotransform = tuple(float(v) for v in gt)

        loc = root.groups["location"]
        glt_x = np.asarray(loc.datasets["glt_x"].read())
        glt_y = np.asarray(loc.datasets["glt_y"].read())
        glt = np.zeros(list(glt_x.shape) + [2], dtype=np.int32)
        glt[..., 0] = np.nan_to_num(glt_x.astype(np.float64),
                                    nan=GLT_NODATA_VALUE).astype(np.int32)
        glt[..., 1] = np.nan_to_num(glt_y.astype(np.float64),
                                    nan=GLT_NODATA_VALUE).astype(np.int32)
        self.glt = glt
        self.ortho_height, self.ortho_width = glt.shape[:2]
        self.ortho_grid = Grid.from_geotransform(
            CRS.geographic(), self.geotransform,
            self.ortho_width, self.ortho_height)
        self._loc = loc

    # ---- accessors ----

    def attr(self, name: str, default=None):
        return self._f.root.attrs.get(name, default)

    @property
    def time_coverage_start(self) -> Optional[str]:
        v = self.attr("time_coverage_start")
        return str(v) if v is not None else None

    @property
    def time_coverage_end(self) -> Optional[str]:
        v = self.attr("time_coverage_end")
        return str(v) if v is not None else None

    def location(self, name: str) -> Optional[np.ndarray]:
        if name in self._loc.datasets:
            return np.asarray(self._loc.datasets[name].read())
        return None

    # ---- GLT ----

    def glt_indices(self) -> Tuple[np.ndarray, np.ndarray, GltDiagnostics]:
        """0-based GLT (gx, gy arrays of shape (Ho, Wo)) and a validity mask
        folded in as -1 entries; plus drop diagnostics.

        Returns (glt0, valid, diag) where glt0 is int32 (Ho, Wo, 2) with
        0-based in-bounds indices at valid cells, and valid is the combined
        1-based-nonzero AND in-bounds mask (emit_proj.py:691-703)."""
        glt = self.glt
        valid = np.all(glt != GLT_NODATA_VALUE, axis=-1)
        glt0 = glt.copy()
        glt0[valid] -= 1
        in_bounds = (
            (glt0[..., 1] >= 0) & (glt0[..., 1] < self.raw_height)
            & (glt0[..., 0] >= 0) & (glt0[..., 0] < self.raw_width))
        valid2 = valid & in_bounds
        diag = GltDiagnostics(
            raw_shape_yx=(self.raw_height, self.raw_width),
            valid_count=int(np.count_nonzero(valid)),
            in_bounds_count=int(np.count_nonzero(valid2)),
            dropped_oob=int(np.count_nonzero(valid)
                            - np.count_nonzero(valid2)),
        )
        return glt0, valid2, diag

    # ---- raw data ----

    def read_bands(self, b0: int, b1: int) -> np.ndarray:
        """Raw band slab [b0, b1) as float32 (raw_y, raw_x, nb), transposed
        to (downtrack, crosstrack) order if the file stores (x, y). Only
        the intersecting HDF5 chunks are decoded."""
        blk = np.asarray(self._data.read_band_range(b0, b1),
                         dtype=np.float32)
        if self.transpose_raw_yx:
            blk = np.transpose(blk, (1, 0, 2))
        return blk

    def read_cube(self) -> np.ndarray:
        return self.read_bands(0, self.n_bands)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EmitMaskGranule:
    """EMIT L2A mask granule: quality flags + packed band mask."""

    DATA_BAND_INDICES = (5, 6)  # forbidden in quality masks (emit_tools.py:292)

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._f = HDF5File(self.path)

    def quality_mask(self, quality_bands) -> np.ndarray:
        """(H, W) uint8 mask: 1 where any selected flag band fires
        (emit_tools.py:271-298)."""
        if any(b in self.DATA_BAND_INDICES for b in quality_bands):
            raise ValueError(
                "Selected flags include a data band (5 or 6), not just "
                "flag bands")
        mask = np.asarray(self._f.root.datasets["mask"].read())
        q = mask[:, :, list(quality_bands)].sum(axis=-1)
        return (q > 0).astype(np.uint8)

    def band_mask(self) -> np.ndarray:
        """(H, W, 285) unpacked per-band mask (emit_tools.py:301-321)."""
        packed = np.asarray(
            self._f.root.datasets["band_mask"].read()).astype(np.uint8)
        unpacked = np.unpackbits(packed, axis=-1)
        return unpacked[:, :, :EMIT_BANDS]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def apply_glt(ds_array: np.ndarray, glt_array: np.ndarray,
              fill_value: float = -9999.0,
              glt_nodata_value: int = 0) -> np.ndarray:
    """NumPy reference-semantics GLT application (the oracle for the device
    kernel): 1-based GLT, 0 = nodata, gathers (y, x) from raw into the
    ortho grid (EMIT_data/emit_tools.py:153-181)."""
    if ds_array.ndim == 2:
        ds_array = ds_array[:, :, np.newaxis]
    out = np.full((glt_array.shape[0], glt_array.shape[1],
                   ds_array.shape[-1]), fill_value, dtype=np.float32)
    valid = np.all(glt_array != glt_nodata_value, axis=-1)
    glt0 = glt_array.copy()
    glt0[valid] -= 1
    # drop out-of-bounds entries (real granules contain them — the same
    # mask prepare_glt applies; emit_proj.py:691-703)
    h, w = ds_array.shape[:2]
    valid &= ((glt0[..., 1] >= 0) & (glt0[..., 1] < h)
              & (glt0[..., 0] >= 0) & (glt0[..., 0] < w))
    out[valid, :] = ds_array[glt0[valid, 1], glt0[valid, 0], :]
    return out


def open_reflectance(path):
    """Convenience: open an EMIT reflectance granule and return
    (cube (H, W, B) float32 with fill -> NaN, wavelengths_nm,
    good_band_mask) — the reference's open_reflectance +
    attach_wavelengths (EMIT_data/EMIT_utils.py:119-154, including the
    micrometre -> nanometre heuristic handled by EmitGranule)."""
    with EmitGranule(path) as g:
        cube = g.read_cube()
        cube = np.where(cube == -9999.0, np.nan, cube)
        return cube, g.wavelengths, g.good_wavelengths


def load_emit_wavelengths_from_nc(path):
    """(wavelengths_nm, good_mask) from a granule — API parity with
    s2_emit/emit_io.py:18-31."""
    with EmitGranule(path) as g:
        return g.wavelengths, g.good_wavelengths

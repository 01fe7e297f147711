# Port-owned copy of hyperres/io/envi.py, verbatim apart from its imports.
"""ENVI raster I/O (header + flat binary cube).

Self-contained replacement for the reference's use of ``spectral.io.envi``
and hytools' ``WriteENVI`` (reference: s2_emit/emit_io.py:7-16,
EMIT_data/emit_proj.py:954-987, EMIT_data/emit_tools.py:324-499).

Supports BSQ/BIL/BIP interleaves, the numeric ENVI data types the pipeline
uses, GDAL-style ``map info`` for geographic and UTM grids, and the EMIT
header enrichment fields (wavelengths, fwhm, bbox, acquisition times).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.crs import CRS
from ..core.grid import Grid

# ENVI data type codes
DTYPE_TO_ENVI = {
    np.dtype("uint8"): 1,
    np.dtype("int16"): 2,
    np.dtype("int32"): 3,
    np.dtype("float32"): 4,
    np.dtype("float64"): 5,
    np.dtype("uint16"): 12,
    np.dtype("uint32"): 13,
    np.dtype("int64"): 14,
    np.dtype("uint64"): 15,
}
ENVI_TO_DTYPE = {v: k for k, v in DTYPE_TO_ENVI.items()}


# ---------------------------------------------------------------------------
# Header parse / serialise
# ---------------------------------------------------------------------------

def parse_header(path: Union[str, Path]) -> Dict[str, Any]:
    """Parse an ENVI .hdr into a dict. List values ``{a, b, c}`` become
    Python lists of strings; scalars stay strings."""
    text = Path(path).read_text()
    if not text.lstrip().upper().startswith("ENVI"):
        raise ValueError(f"Not an ENVI header: {path}")
    header: Dict[str, Any] = {}
    # strip leading "ENVI"
    body = text.lstrip()[4:]
    i = 0
    n = len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            break
        key = body[i:eq].strip().lower()
        j = eq + 1
        while j < n and body[j] in " \t":
            j += 1
        if j < n and body[j] == "{":
            end = body.find("}", j)
            if end < 0:
                raise ValueError(f"Unterminated list for key '{key}'")
            raw = body[j + 1:end]
            header[key] = [s.strip() for s in raw.split(",")]
            i = end + 1
        else:
            end = body.find("\n", j)
            if end < 0:
                end = n
            header[key] = body[j:end].strip()
            i = end + 1
        # skip blank lines
        while i < n and body[i] in "\r\n":
            i += 1
    return header


def _fmt_value(v: Any) -> str:
    if isinstance(v, (list, tuple, np.ndarray)):
        items = []
        for x in np.asarray(v).ravel() if isinstance(v, np.ndarray) else v:
            if isinstance(x, (list, tuple)):
                items.append(", ".join(str(e) for e in x))
            else:
                items.append(str(x))
        return "{ " + ", ".join(items) + " }"
    return str(v)


def write_header(path: Union[str, Path], header: Dict[str, Any]) -> None:
    lines = ["ENVI"]
    for k, v in header.items():
        lines.append(f"{k} = {_fmt_value(v)}")
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# map info <-> Grid
# ---------------------------------------------------------------------------

def map_info_for_grid(grid: Grid) -> List[Any]:
    """Build ENVI 'map info' for a grid (geographic or UTM), using pixel
    (1,1) tie point at the grid origin — the reference's convention
    (EMIT_data/emit_proj.py:746-753)."""
    if grid.crs.is_geographic:
        return ["Geographic Lat/Lon", 1, 1, grid.x0, grid.y0,
                grid.dx, grid.dy, "WGS-84", "units=degrees"]
    if grid.crs.kind == "utm":
        zone, north = grid.crs.params
        return ["UTM", 1, 1, grid.x0, grid.y0, grid.dx, grid.dy,
                zone, "North" if north else "South", "WGS-84",
                "units=Meters"]
    raise ValueError(f"No map info mapping for CRS {grid.crs}")


def grid_from_header(header: Dict[str, Any]) -> Optional[Grid]:
    mi = header.get("map info")
    if not mi:
        return None
    mi = [str(s).strip() for s in mi]
    proj = mi[0].lower()
    px, py = float(mi[1]), float(mi[2])
    x, y = float(mi[3]), float(mi[4])
    dx, dy = float(mi[5]), float(mi[6])
    # tie point (px,py) is 1-based pixel whose outer corner is (x,y)
    x0 = x - (px - 1.0) * dx
    y0 = y + (py - 1.0) * dy
    width = int(header["samples"])
    height = int(header["lines"])
    if proj.startswith("geographic"):
        crs = CRS.geographic()
    elif proj == "utm":
        zone = int(float(mi[7]))
        north = mi[8].lower().startswith("n")
        crs = CRS.utm(zone, north)
    else:
        return None
    return Grid(crs, x0, y0, dx, dy, width, height)


# ---------------------------------------------------------------------------
# Cube read / write
# ---------------------------------------------------------------------------

def _data_path_for(hdr_path: Path) -> Path:
    for ext in (".bin", ".img", ".dat", ""):
        p = hdr_path.with_suffix(ext)
        if p.exists() and p != hdr_path:
            return p
    raise FileNotFoundError(f"No ENVI data file next to {hdr_path}")


class EnviReader:
    """Reads an ENVI cube; data is exposed bands-last ``(H, W, B)``."""

    def __init__(self, hdr_path: Union[str, Path],
                 data_path: Union[str, Path, None] = None):
        self.hdr_path = Path(hdr_path)
        self.header = parse_header(self.hdr_path)
        self.data_path = (Path(data_path) if data_path
                          else _data_path_for(self.hdr_path))
        self.lines = int(self.header["lines"])
        self.samples = int(self.header["samples"])
        self.bands = int(self.header.get("bands", 1))
        self.interleave = str(self.header.get("interleave", "bsq")).lower()
        code = int(self.header["data type"])
        self.dtype = ENVI_TO_DTYPE[code]
        byte_order = int(self.header.get("byte order", 0))
        if byte_order != 0:
            self.dtype = self.dtype.newbyteorder(">")
        self.offset = int(self.header.get("header offset", 0))
        self.grid = grid_from_header(self.header)
        nd = self.header.get("data ignore value")
        self.nodata = float(nd) if nd is not None else None

    def memmap(self) -> np.memmap:
        shape = {
            "bsq": (self.bands, self.lines, self.samples),
            "bil": (self.lines, self.bands, self.samples),
            "bip": (self.lines, self.samples, self.bands),
        }[self.interleave]
        return np.memmap(self.data_path, dtype=self.dtype, mode="r",
                         offset=self.offset, shape=shape)

    def read(self, bands: Optional[List[int]] = None) -> np.ndarray:
        """Full cube (or band subset) as (H, W, B) in file dtype."""
        mm = self.memmap()
        if self.interleave == "bsq":
            arr = mm[bands] if bands is not None else mm[:]
            return np.ascontiguousarray(np.moveaxis(arr, 0, -1))
        if self.interleave == "bil":
            arr = mm[:, bands, :] if bands is not None else mm[:]
            return np.ascontiguousarray(np.moveaxis(arr, 1, -1))
        arr = mm[..., bands] if bands is not None else mm[:]
        return np.ascontiguousarray(arr)

    def read_band(self, band: int) -> np.ndarray:
        mm = self.memmap()
        if self.interleave == "bsq":
            return np.asarray(mm[band])
        if self.interleave == "bil":
            return np.asarray(mm[:, band, :])
        return np.asarray(mm[:, :, band])

    @property
    def wavelengths(self) -> Optional[np.ndarray]:
        wl = self.header.get("wavelength")
        if wl is None:
            return None
        return np.asarray([float(w) for w in wl], dtype=np.float64)


def read_cube(hdr_path: Union[str, Path]) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Convenience: (H, W, B) float32 cube + header, the reference's
    ``load_emit_envi_rfl`` shape contract (s2_emit/emit_io.py:7-16)."""
    r = EnviReader(hdr_path)
    return r.read().astype(np.float32), r.header


class EnviWriter:
    """Band-sequential ENVI writer supporting incremental band writes,
    the streaming pattern of the reference's ortho export
    (EMIT_data/emit_proj.py:965-987)."""

    def __init__(self, base_path: Union[str, Path], header: Dict[str, Any],
                 data_ext: str = ".bin"):
        base = Path(base_path)
        self.data_path = base if base.suffix == data_ext else base.with_suffix(data_ext)
        self.hdr_path = self.data_path.with_suffix(".hdr")
        self.header = dict(header)
        self.lines = int(header["lines"])
        self.samples = int(header["samples"])
        self.bands = int(header.get("bands", 1))
        self.interleave = str(header.get("interleave", "bil")).lower()
        self.dtype = ENVI_TO_DTYPE[int(header["data type"])]
        self.header.setdefault("byte order", 0)
        self.header.setdefault("header offset", 0)
        self.header.setdefault("file type", "ENVI Standard")
        nbytes = self.lines * self.samples * self.bands * self.dtype.itemsize
        self.data_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.data_path, "wb") as f:
            f.truncate(nbytes)
        write_header(self.hdr_path, self.header)

    def _memmap(self, mode="r+") -> np.memmap:
        shape = {
            "bsq": (self.bands, self.lines, self.samples),
            "bil": (self.lines, self.bands, self.samples),
            "bip": (self.lines, self.samples, self.bands),
        }[self.interleave]
        return np.memmap(self.data_path, dtype=self.dtype, mode=mode, shape=shape)

    def write_band(self, band_data: np.ndarray, band_index: int) -> None:
        mm = self._memmap()
        if self.interleave == "bsq":
            mm[band_index] = band_data
        elif self.interleave == "bil":
            mm[:, band_index, :] = band_data
        else:
            mm[:, :, band_index] = band_data
        mm.flush()

    def write_cube(self, cube_hwb: np.ndarray) -> None:
        mm = self._memmap()
        if self.interleave == "bsq":
            mm[:] = np.moveaxis(cube_hwb, -1, 0)
        elif self.interleave == "bil":
            mm[:] = np.moveaxis(cube_hwb, -1, 1)
        else:
            mm[:] = cube_hwb
        mm.flush()


def write_cube(
    base_path: Union[str, Path],
    cube_hwb: np.ndarray,
    grid: Optional[Grid] = None,
    *,
    interleave: str = "bil",
    nodata: Optional[float] = None,
    wavelengths: Optional[np.ndarray] = None,
    fwhm: Optional[np.ndarray] = None,
    extra_header: Optional[Dict[str, Any]] = None,
) -> Tuple[Path, Path]:
    """Write a (H, W, B) cube to ENVI; returns (data_path, hdr_path)."""
    cube_hwb = np.asarray(cube_hwb)
    if cube_hwb.ndim == 2:
        cube_hwb = cube_hwb[..., None]
    h, w, b = cube_hwb.shape
    header: Dict[str, Any] = {
        "description": "hyperres ENVI export",
        "samples": w,
        "lines": h,
        "bands": b,
        "header offset": 0,
        "file type": "ENVI Standard",
        "data type": DTYPE_TO_ENVI[cube_hwb.dtype],
        "interleave": interleave,
        "byte order": 0,
    }
    if nodata is not None:
        header["data ignore value"] = nodata
    if grid is not None:
        header["map info"] = map_info_for_grid(grid)
        header["coordinate system string"] = [grid.crs.to_wkt()]
    if wavelengths is not None:
        header["wavelength"] = [float(x) for x in np.asarray(wavelengths)]
        header["wavelength units"] = "nanometers"
    if fwhm is not None:
        header["fwhm"] = [float(x) for x in np.asarray(fwhm)]
    if extra_header:
        header.update(extra_header)
    writer = EnviWriter(base_path, header)
    writer.write_cube(cube_hwb)
    return writer.data_path, writer.hdr_path

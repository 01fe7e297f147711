# Port-owned copy of hyperres/io/tiff.py, verbatim apart from its imports,
# the deflate of the blocks (stdlib zlib, the native codec's own fallback,
# on a thread pool as the native codec threads it, instead of the
# g++-built codec) and the HTTP range reader (HttpRangeSource,
# TiffReader.open_url), which the port does not use.
"""GeoTIFF read/write, self-contained (numpy + zlib).

Replaces the reference's rasterio/GDAL GeoTIFF boundary (used throughout:
s2_emit/synth.py:118-137, tiles_helpers/utils.py:308-440,
EMIT_data/emit_proj.py:248-276, s2_data/s2_utils.py:505-614).

Capabilities:
- classic TIFF and BigTIFF (auto-promoted when the payload nears 4 GB,
  the reference's ``BIGTIFF=IF_SAFER``),
- striped and tiled layout, chunky (pixel-interleaved) planar config,
- DEFLATE (zlib) or no compression, horizontal-differencing predictor 2,
- dtypes: uint8/16/32, int16/32, float32/64,
- GeoTIFF georeferencing via ModelPixelScale + ModelTiepoint + GeoKeys
  (geographic WGS84 and UTM EPSG codes),
- GDAL conventions: nodata (tag 42113), dataset/band metadata and band
  descriptions (GDAL_METADATA tag 42112),
- windowed reads that only decode the intersecting blocks (the streaming
  access pattern behind paired tiling, tiles_helpers/utils.py:266-301).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union
from xml.etree import ElementTree

import numpy as np

from ..core.crs import CRS
from ..core.grid import Grid, Window

# --- TIFF tag ids ---
T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_IMAGE_DESCRIPTION = 270
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_PREDICTOR = 317
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_EXTRA_SAMPLES = 338
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_GEO_KEY_DIRECTORY = 34735
T_GEO_DOUBLE_PARAMS = 34736
T_GEO_ASCII_PARAMS = 34737
T_GDAL_METADATA = 42112
T_GDAL_NODATA = 42113

# TIFF field types
FT_BYTE, FT_ASCII, FT_SHORT, FT_LONG, FT_RATIONAL = 1, 2, 3, 4, 5
FT_SBYTE, FT_UNDEF, FT_SSHORT, FT_SLONG = 6, 7, 8, 9
FT_FLOAT, FT_DOUBLE = 11, 12
FT_LONG8, FT_SLONG8, FT_IFD8 = 16, 17, 18

_FT_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
            11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_FT_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
           12: "d", 16: "Q", 17: "q", 18: "Q"}

_DTYPE_SF = {  # numpy dtype -> (bits, sample_format)
    np.dtype("uint8"): (8, 1),
    np.dtype("uint16"): (16, 1),
    np.dtype("uint32"): (32, 1),
    np.dtype("int16"): (16, 2),
    np.dtype("int32"): (32, 2),
    np.dtype("float32"): (32, 3),
    np.dtype("float64"): (64, 3),
}

COMPRESSION_NONE = 1
COMPRESSION_DEFLATE = 8
COMPRESSION_DEFLATE_OLD = 32946


def _dtype_from(bits: int, sample_format: int) -> np.dtype:
    table = {
        (8, 1): "uint8", (16, 1): "uint16", (32, 1): "uint32",
        (8, 2): "int8", (16, 2): "int16", (32, 2): "int32",
        (32, 3): "float32", (64, 3): "float64",
    }
    key = (bits, sample_format)
    if key not in table:
        raise ValueError(f"Unsupported TIFF sample: {bits} bits, format {sample_format}")
    return np.dtype(table[key])


# ---------------------------------------------------------------------------
# GDAL_METADATA XML helpers
# ---------------------------------------------------------------------------

def build_gdal_metadata(tags: Optional[Dict[str, str]] = None,
                        descriptions: Optional[Sequence[Optional[str]]] = None,
                        band_tags: Optional[Sequence[Dict[str, str]]] = None
                        ) -> Optional[str]:
    root = ElementTree.Element("GDALMetadata")
    if tags:
        for k, v in tags.items():
            item = ElementTree.SubElement(root, "Item", name=str(k))
            item.text = str(v)
    if descriptions:
        for i, d in enumerate(descriptions):
            if d:
                item = ElementTree.SubElement(
                    root, "Item", name="DESCRIPTION", sample=str(i),
                    role="description")
                item.text = str(d)
    if band_tags:
        for i, bt in enumerate(band_tags):
            for k, v in (bt or {}).items():
                item = ElementTree.SubElement(root, "Item", name=str(k),
                                              sample=str(i))
                item.text = str(v)
    if len(root) == 0:
        return None
    return ElementTree.tostring(root, encoding="unicode")


def parse_gdal_metadata(xml: str, n_bands: int):
    tags: Dict[str, str] = {}
    descriptions: List[Optional[str]] = [None] * n_bands
    band_tags: List[Dict[str, str]] = [dict() for _ in range(n_bands)]
    try:
        root = ElementTree.fromstring(xml)
    except ElementTree.ParseError:
        return tags, descriptions, band_tags
    for item in root.findall("Item"):
        name = item.get("name", "")
        sample = item.get("sample")
        text = item.text or ""
        if sample is not None:
            i = int(sample)
            if i < n_bands:
                if item.get("role") == "description" or name == "DESCRIPTION":
                    descriptions[i] = text
                else:
                    band_tags[i][name] = text
        else:
            tags[name] = text
    return tags, descriptions, band_tags


# ---------------------------------------------------------------------------
# GeoKeys
# ---------------------------------------------------------------------------

def _geokeys_for_crs(crs: CRS) -> List[int]:
    # header: KeyDirectoryVersion, KeyRevision, MinorRevision, NumberOfKeys
    keys: List[Tuple[int, int, int, int]] = []
    if crs.is_geographic:
        keys.append((1024, 0, 1, 2))      # GTModelType = geographic
        keys.append((1025, 0, 1, 1))      # GTRasterType = PixelIsArea
        keys.append((2048, 0, 1, 4326))   # GeographicType = WGS84
    else:
        keys.append((1024, 0, 1, 1))      # GTModelType = projected
        keys.append((1025, 0, 1, 1))
        keys.append((3072, 0, 1, crs.epsg))  # ProjectedCSType
        keys.append((3076, 0, 1, 9001))   # metre
    out = [1, 1, 0, len(keys)]
    for k in keys:
        out.extend(k)
    return out


def _crs_from_geokeys(shorts: Sequence[int]) -> Optional[CRS]:
    if len(shorts) < 4:
        return None
    nkeys = shorts[3]
    kv = {}
    for i in range(nkeys):
        base = 4 + i * 4
        key, loc, cnt, val = shorts[base:base + 4]
        if loc == 0:
            kv[key] = val
    if kv.get(1024) == 2:
        return CRS.geographic()
    if kv.get(1024) == 1 and 3072 in kv:
        try:
            return CRS.from_epsg(kv[3072])
        except ValueError:
            return None
    if 2048 in kv and kv[2048] == 4326:
        return CRS.geographic()
    return None


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

def _predictor2_encode(block: np.ndarray) -> np.ndarray:
    # block: (rows, cols, samples); horizontal differencing along cols
    out = block.copy()
    out[:, 1:, :] = block[:, 1:, :].astype(out.dtype) - block[:, :-1, :]
    return out


def _predictor2_decode(block: np.ndarray) -> np.ndarray:
    return np.cumsum(block, axis=1, dtype=block.dtype)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _TagSet:
    def __init__(self):
        self.tags: List[Tuple[int, int, int, Any]] = []

    def add(self, tag: int, ftype: int, values) -> None:
        if ftype == FT_ASCII:
            data = values.encode() + b"\x00" if isinstance(values, str) else values
            self.tags.append((tag, ftype, len(data), data))
        else:
            if np.isscalar(values):
                values = [values]
            self.tags.append((tag, ftype, len(values), list(values)))

    def sorted(self):
        return sorted(self.tags, key=lambda t: t[0])


def write_geotiff(
    path: Union[str, Path],
    data: np.ndarray,
    grid: Optional[Grid] = None,
    *,
    nodata: Optional[float] = None,
    descriptions: Optional[Sequence[Optional[str]]] = None,
    tags: Optional[Dict[str, str]] = None,
    band_tags: Optional[Sequence[Dict[str, str]]] = None,
    compress: Optional[str] = "deflate",
    zlevel: int = 1,
    predictor: Optional[int] = None,
    tiled: bool = False,
    blockxsize: int = 256,
    blockysize: int = 256,
    rows_per_strip: Optional[int] = None,
    bigtiff: Union[bool, str] = "if_safer",
) -> Path:
    """Write (B, H, W) or (H, W) array as GeoTIFF. Returns the path."""
    path = Path(path)
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    nb, h, w = data.shape
    dt = data.dtype
    if dt == np.dtype("int8"):
        data = data.astype(np.int16)
        dt = data.dtype
    if dt not in _DTYPE_SF:
        raise ValueError(f"Unsupported dtype {dt}")
    bits, sf = _DTYPE_SF[dt]

    comp = {None: COMPRESSION_NONE, "none": COMPRESSION_NONE,
            "deflate": COMPRESSION_DEFLATE}[
        compress.lower() if isinstance(compress, str) else compress]
    if predictor is None:
        predictor = 2 if (sf in (1, 2) and comp != COMPRESSION_NONE) else 1
    if predictor == 2 and sf == 3:
        predictor = 1  # horizontal differencing is for integer data

    # pixel-interleaved view (rows, cols, samples)
    pix = np.ascontiguousarray(np.moveaxis(data, 0, -1))

    # block geometry
    if tiled:
        bw = min(int(blockxsize), max(16, w))
        bh = min(int(blockysize), max(16, h))
        # TIFF tiles must be multiples of 16
        bw = max(16, (bw // 16) * 16)
        bh = max(16, (bh // 16) * 16)
        tiles_x = (w + bw - 1) // bw
        tiles_y = (h + bh - 1) // bh
        nblocks = tiles_x * tiles_y
    else:
        if rows_per_strip is None:
            target = 1 << 20  # ~1 MiB strips
            rows_per_strip = max(1, min(h, target // max(1, w * nb * dt.itemsize)))
        bh = int(rows_per_strip)
        bw = w
        tiles_x = 1
        tiles_y = (h + bh - 1) // bh
        nblocks = tiles_y

    # collect raw blocks, then compress them all at once (threaded in the
    # native codec when available)
    raws: List[bytes] = []
    for by in range(tiles_y):
        r0 = by * bh
        r1 = min(r0 + bh, h)
        for bx in range(tiles_x):
            c0 = bx * bw
            c1 = min(c0 + bw, w)
            block = pix[r0:r1, c0:c1, :]
            if tiled and (block.shape[0] != bh or block.shape[1] != bw):
                pad = np.zeros((bh, bw, nb), dtype=dt)
                pad[:block.shape[0], :block.shape[1], :] = block
                block = pad
            if predictor == 2:
                block = _predictor2_encode(block)
            raws.append(block.tobytes())
    if comp == COMPRESSION_DEFLATE:
        # zlib releases the GIL, so the blocks compress in parallel
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            chunks = list(ex.map(lambda b: zlib.compress(b, zlevel), raws))
    else:
        chunks = raws

    payload = sum(len(c) for c in chunks)
    use_big = (bigtiff is True) or (
        isinstance(bigtiff, str) and bigtiff.lower() in ("yes", "always")
    ) or (
        isinstance(bigtiff, str) and bigtiff.lower() == "if_safer"
        and payload + 65536 + 32 * nb > 0xFFFF0000
    )

    # assemble tags
    ts = _TagSet()
    ts.add(T_IMAGE_WIDTH, FT_LONG, w)
    ts.add(T_IMAGE_LENGTH, FT_LONG, h)
    ts.add(T_BITS_PER_SAMPLE, FT_SHORT, [bits] * nb)
    ts.add(T_COMPRESSION, FT_SHORT, comp)
    ts.add(T_PHOTOMETRIC, FT_SHORT, 1)  # min-is-black
    ts.add(T_SAMPLES_PER_PIXEL, FT_SHORT, nb)
    ts.add(T_PLANAR_CONFIG, FT_SHORT, 1)
    ts.add(T_SAMPLE_FORMAT, FT_SHORT, [sf] * nb)
    if nb > 1:
        ts.add(T_EXTRA_SAMPLES, FT_SHORT, [0] * (nb - 1))
    if predictor != 1:
        ts.add(T_PREDICTOR, FT_SHORT, predictor)
    off_type = FT_LONG8 if use_big else FT_LONG
    if tiled:
        ts.add(T_TILE_WIDTH, FT_LONG, bw)
        ts.add(T_TILE_LENGTH, FT_LONG, bh)
        ts.add(T_TILE_OFFSETS, off_type, [0] * nblocks)  # patched below
        ts.add(T_TILE_BYTE_COUNTS, FT_LONG, [len(c) for c in chunks])
    else:
        ts.add(T_ROWS_PER_STRIP, FT_LONG, bh)
        ts.add(T_STRIP_OFFSETS, off_type, [0] * nblocks)
        ts.add(T_STRIP_BYTE_COUNTS, FT_LONG, [len(c) for c in chunks])
    if grid is not None:
        ts.add(T_MODEL_PIXEL_SCALE, FT_DOUBLE, [grid.dx, grid.dy, 0.0])
        ts.add(T_MODEL_TIEPOINT, FT_DOUBLE,
               [0.0, 0.0, 0.0, grid.x0, grid.y0, 0.0])
        ts.add(T_GEO_KEY_DIRECTORY, FT_SHORT, _geokeys_for_crs(grid.crs))
    md = build_gdal_metadata(tags, descriptions, band_tags)
    if md:
        ts.add(T_GDAL_METADATA, FT_ASCII, md)
    if nodata is not None:
        nd = (f"{int(nodata)}" if float(nodata).is_integer()
              else f"{float(nodata):.18g}")
        ts.add(T_GDAL_NODATA, FT_ASCII, nd)

    _write_tiff_file(path, ts, chunks, use_big,
                     offsets_tag=T_TILE_OFFSETS if tiled else T_STRIP_OFFSETS)
    return path


def _write_tiff_file(path: Path, ts: _TagSet, chunks: List[bytes],
                     big: bool, offsets_tag: int) -> None:
    tags = ts.sorted()
    if big:
        header_size = 16
        entry_size = 20
        ifd_count_size = 8
        next_off_size = 8
        inline_max = 8
        off_fmt = "<Q"
    else:
        header_size = 8
        entry_size = 12
        ifd_count_size = 2
        next_off_size = 4
        inline_max = 4
        off_fmt = "<I"

    # layout: header | chunk data | external tag data | IFD
    pos = header_size
    chunk_offsets = []
    for c in chunks:
        chunk_offsets.append(pos)
        pos += len(c)
        if pos % 2:
            pos += 1

    # patch the offsets tag values
    patched = []
    for tag, ftype, count, values in tags:
        if tag == offsets_tag:
            values = chunk_offsets
        patched.append((tag, ftype, count, values))
    tags = patched

    # serialise tag payloads, deciding inline vs external
    external: List[bytes] = []
    ext_offsets: List[Optional[int]] = []
    payloads: List[bytes] = []
    for tag, ftype, count, values in tags:
        if ftype == FT_ASCII:
            data = values if isinstance(values, bytes) else values.encode() + b"\x00"
        else:
            fmt = _FT_FMT[ftype]
            data = struct.pack(f"<{count}{fmt}", *values)
        payloads.append(data)

    ext_pos = pos
    for data in payloads:
        if len(data) <= inline_max:
            ext_offsets.append(None)
        else:
            ext_offsets.append(ext_pos)
            external.append(data)
            ext_pos += len(data)
            if ext_pos % 2:
                ext_pos += 1

    ifd_offset = ext_pos

    with open(path, "wb") as f:
        if big:
            f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, ifd_offset))
        else:
            f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        # chunks
        for c in chunks:
            f.write(c)
            if f.tell() % 2:
                f.write(b"\x00")
        # external data
        for data in external:
            f.write(data)
            if f.tell() % 2:
                f.write(b"\x00")
        assert f.tell() == ifd_offset, (f.tell(), ifd_offset)
        # IFD
        if big:
            f.write(struct.pack("<Q", len(tags)))
        else:
            f.write(struct.pack("<H", len(tags)))
        for (tag, ftype, count, values), data, eoff in zip(
                tags, payloads, ext_offsets):
            if big:
                f.write(struct.pack("<HHQ", tag, ftype, count))
            else:
                f.write(struct.pack("<HHI", tag, ftype, count))
            if eoff is None:
                f.write(data + b"\x00" * (inline_max - len(data)))
            else:
                f.write(struct.pack(off_fmt, eoff))
        f.write(b"\x00" * next_off_size)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _FileSource:
    """Local-file byte source."""

    def __init__(self, path):
        self._fh = open(path, "rb")

    def pread(self, offset: int, size: int) -> bytes:
        self._fh.seek(offset)
        return self._fh.read(size)

    def close(self):
        self._fh.close()


class _SourceFile:
    """File-like adapter over a byte source (seek/read)."""

    def __init__(self, source):
        self._src = source
        self._pos = 0

    def seek(self, pos: int):
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int) -> bytes:
        data = self._src.pread(self._pos, size)
        self._pos += len(data)
        return data

    def close(self):
        self._src.close()


class TiffReader:
    """Reads (the first IFD of) a classic or Big GeoTIFF, from a local
    path or any byte source (see ``from_source``)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._f = _SourceFile(_FileSource(self.path))
        self._parse()

    @classmethod
    def from_source(cls, source, name: str = "<source>") -> "TiffReader":
        self = cls.__new__(cls)
        self.path = name
        self._f = _SourceFile(source)
        self._parse()
        return self

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _parse(self):
        f = self._f
        hdr = f.read(4)
        if hdr[:2] == b"II":
            self._end = "<"
        elif hdr[:2] == b"MM":
            self._end = ">"
        else:
            raise ValueError(f"Not a TIFF: {self.path}")
        version = struct.unpack(self._end + "H", hdr[2:4])[0]
        if version == 42:
            self.big = False
            ifd_off = struct.unpack(self._end + "I", f.read(4))[0]
        elif version == 43:
            self.big = True
            off_size, _ = struct.unpack(self._end + "HH", f.read(4))
            if off_size != 8:
                raise ValueError("Unsupported BigTIFF offset size")
            ifd_off = struct.unpack(self._end + "Q", f.read(8))[0]
        else:
            raise ValueError(f"Bad TIFF version {version}")
        self.tags = self._read_ifd(ifd_off)

        t = self.tags
        self.width = int(t[T_IMAGE_WIDTH][0])
        self.height = int(t[T_IMAGE_LENGTH][0])
        self.count = int(t.get(T_SAMPLES_PER_PIXEL, [1])[0])
        bits = t.get(T_BITS_PER_SAMPLE, [8])
        sf = t.get(T_SAMPLE_FORMAT, [1] * self.count)
        self.dtype = _dtype_from(int(bits[0]), int(sf[0]))
        self.compression = int(t.get(T_COMPRESSION, [1])[0])
        self.predictor = int(t.get(T_PREDICTOR, [1])[0])
        self.planar = int(t.get(T_PLANAR_CONFIG, [1])[0])
        self.tiled = T_TILE_OFFSETS in t
        if self.tiled:
            self.block_w = int(t[T_TILE_WIDTH][0])
            self.block_h = int(t[T_TILE_LENGTH][0])
            self.offsets = [int(v) for v in t[T_TILE_OFFSETS]]
            self.counts = [int(v) for v in t[T_TILE_BYTE_COUNTS]]
        else:
            self.block_w = self.width
            self.block_h = int(t.get(T_ROWS_PER_STRIP, [self.height])[0])
            self.offsets = [int(v) for v in t[T_STRIP_OFFSETS]]
            self.counts = [int(v) for v in t[T_STRIP_BYTE_COUNTS]]
        self.blocks_x = (self.width + self.block_w - 1) // self.block_w
        self.blocks_y = (self.height + self.block_h - 1) // self.block_h

        # georeferencing
        self.grid: Optional[Grid] = None
        if T_MODEL_PIXEL_SCALE in t and T_MODEL_TIEPOINT in t:
            sx, sy = float(t[T_MODEL_PIXEL_SCALE][0]), float(t[T_MODEL_PIXEL_SCALE][1])
            tp = t[T_MODEL_TIEPOINT]
            px, py, _, gx, gy, _ = [float(v) for v in tp[:6]]
            x0 = gx - px * sx
            y0 = gy + py * sy
            crs = None
            if T_GEO_KEY_DIRECTORY in t:
                crs = _crs_from_geokeys([int(v) for v in t[T_GEO_KEY_DIRECTORY]])
            if crs is not None:
                self.grid = Grid(crs, x0, y0, sx, sy, self.width, self.height)

        # GDAL conventions
        self.nodata: Optional[float] = None
        if T_GDAL_NODATA in t:
            try:
                self.nodata = float(str(t[T_GDAL_NODATA]).strip("\x00 "))
            except ValueError:
                pass
        self.dataset_tags: Dict[str, str] = {}
        self.descriptions: List[Optional[str]] = [None] * self.count
        self.band_tags: List[Dict[str, str]] = [dict() for _ in range(self.count)]
        if T_GDAL_METADATA in t:
            self.dataset_tags, self.descriptions, self.band_tags = \
                parse_gdal_metadata(str(t[T_GDAL_METADATA]), self.count)

    def _read_ifd(self, off: int) -> Dict[int, Any]:
        f = self._f
        f.seek(off)
        if self.big:
            n = struct.unpack(self._end + "Q", f.read(8))[0]
            entry_size = 20
            inline_max = 8
        else:
            n = struct.unpack(self._end + "H", f.read(2))[0]
            entry_size = 12
            inline_max = 4
        raw = f.read(n * entry_size)
        tags: Dict[int, Any] = {}
        for i in range(n):
            e = raw[i * entry_size:(i + 1) * entry_size]
            if self.big:
                tag, ftype, count = struct.unpack(self._end + "HHQ", e[:12])
                inline = e[12:20]
            else:
                tag, ftype, count = struct.unpack(self._end + "HHI", e[:8])
                inline = e[8:12]
            size = _FT_SIZE.get(ftype, 1) * count
            if size <= inline_max:
                data = inline[:size]
            else:
                off_v = struct.unpack(
                    self._end + ("Q" if self.big else "I"), inline)[0]
                pos = f.tell()
                f.seek(off_v)
                data = f.read(size)
                f.seek(pos)
            if ftype == FT_ASCII:
                tags[tag] = data.rstrip(b"\x00").decode("latin-1")
            elif ftype in _FT_FMT:
                fmt = _FT_FMT[ftype]
                tags[tag] = list(struct.unpack(
                    self._end + f"{count}{fmt}", data))
            elif ftype == FT_RATIONAL:
                vals = struct.unpack(self._end + f"{2 * count}I", data)
                tags[tag] = [vals[2 * i] / max(1, vals[2 * i + 1])
                             for i in range(count)]
            else:
                tags[tag] = data
        return tags

    # ---- decoding ----

    def _decode_block(self, idx: int) -> np.ndarray:
        """Decode block ``idx`` -> (block_h, block_w, count)."""
        f = self._f
        f.seek(self.offsets[idx])
        raw = f.read(self.counts[idx])
        if self.compression in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_OLD):
            raw = zlib.decompress(raw)
        elif self.compression != COMPRESSION_NONE:
            raise ValueError(f"Unsupported compression {self.compression}")
        return self._assemble_block(idx, raw)

    def _decode_blocks(self, indices):
        """{idx: block array} for many blocks; deflate blocks inflate
        across a thread pool (zlib releases the GIL, so this scales with
        host cores — same strategy as the HDF5 chunk decoder)."""
        import os
        nt = min(8, os.cpu_count() or 1, len(indices))
        if (nt > 1 and self.compression in (COMPRESSION_DEFLATE,
                                            COMPRESSION_DEFLATE_OLD)):
            f = self._f
            raws = []
            for idx in indices:
                f.seek(self.offsets[idx])
                raws.append(f.read(self.counts[idx]))
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(nt) as ex:
                blobs = list(ex.map(zlib.decompress, raws))
            return {idx: self._assemble_block(idx, blob)
                    for idx, blob in zip(indices, blobs)}
        return {idx: self._decode_block(idx) for idx in indices}

    def _assemble_block(self, idx: int, raw: bytes) -> np.ndarray:
        by, bx = divmod(idx, self.blocks_x)
        if self.tiled:
            rows, cols = self.block_h, self.block_w
        else:
            rows = min(self.block_h, self.height - by * self.block_h)
            cols = self.block_w
        dt = self.dtype.newbyteorder(self._end)
        arr = np.frombuffer(raw, dtype=dt).reshape(rows, cols, self.count)
        arr = arr.astype(self.dtype, copy=False)
        if self.predictor == 2:
            arr = _predictor2_decode(arr)
        return arr

    def read(self, window: Optional[Window] = None,
             bands: Optional[Sequence[int]] = None) -> np.ndarray:
        """Read (B, H, W); ``bands`` are 0-based; decodes only the blocks
        intersecting ``window``."""
        if self.planar != 1:
            raise ValueError("Only chunky planar configuration supported")
        if window is None:
            window = Window(0, 0, self.width, self.height)
        band_idx = list(bands) if bands is not None else list(range(self.count))
        out = np.zeros((len(band_idx), window.height, window.width),
                       dtype=self.dtype)
        by0 = window.row_off // self.block_h
        by1 = (window.row_off + window.height - 1) // self.block_h
        bx0 = window.col_off // self.block_w
        bx1 = (window.col_off + window.width - 1) // self.block_w
        indices = [by * self.blocks_x + bx
                   for by in range(by0, min(by1, self.blocks_y - 1) + 1)
                   for bx in range(bx0, min(bx1, self.blocks_x - 1) + 1)]
        blocks = self._decode_blocks(indices)
        for by in range(by0, min(by1, self.blocks_y - 1) + 1):
            for bx in range(bx0, min(bx1, self.blocks_x - 1) + 1):
                block = blocks[by * self.blocks_x + bx]
                r0 = by * self.block_h
                c0 = bx * self.block_w
                # intersection in image coords
                ir0 = max(r0, window.row_off)
                ir1 = min(r0 + block.shape[0], window.row_off + window.height)
                ic0 = max(c0, window.col_off)
                ic1 = min(c0 + block.shape[1], window.col_off + window.width)
                if ir0 >= ir1 or ic0 >= ic1:
                    continue
                sub = block[ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0, :]
                out[:, ir0 - window.row_off:ir1 - window.row_off,
                    ic0 - window.col_off:ic1 - window.col_off] = \
                    np.moveaxis(sub[:, :, band_idx], -1, 0)
        return out

    def read_band(self, band: int, window: Optional[Window] = None) -> np.ndarray:
        return self.read(window=window, bands=[band])[0]


def read_geotiff(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[Grid], Optional[float]]:
    with TiffReader(path) as r:
        return r.read(), r.grid, r.nodata

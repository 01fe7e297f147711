# Port-owned copy of hyperres/io/hdf5.py, verbatim apart from its imports.
"""Minimal self-contained HDF5 codec for EMIT netCDF4 granules.

The environment has no h5py/netCDF4, so the framework carries its own
reader for the HDF5 subset that EMIT L1B/L2A granules use (they are
netCDF-4 files, i.e. HDF5 written by netcdf-c *without* the
"latest format" flag):

- superblock v0/v2/v3,
- object headers v1 (with continuations) and v2 ("OHDR"),
- groups via v1 symbol tables (B-tree v1 type 0 + SNOD + local heap),
- datasets: contiguous and chunked layout (v3 message, chunk B-tree v1
  type 1), filters: deflate (1) and shuffle (2),
- "latest"-format (layout v4) chunk indexes: single chunk, implicit,
  fixed array, extensible array (1 unlimited dim, incl. super blocks
  and paged data blocks) and v2 B-tree (>1 unlimited dim, any depth) —
  the layouts netcdf-c emits for record/unlimited dimensions,
- dense link and attribute storage (fractal heap + name-index v2
  B-trees — "latest" groups with >8 links / objects with many attrs),
- datatypes: fixed-point / IEEE float (little-endian), fixed strings,
- attributes (message 0x000C, v1-v3), including scalar string attrs,
- variable-length string attributes AND datasets via the global heap
  (netcdf-c writes NC_STRING that way).

A matching writer produces valid files of the same subset — verified
against stock libhdf5 (h5py opens and reads them) — so synthetic
granules used in tests round-trip through the real reader path
(reference entry points replaced: EMIT_data/emit_proj.py:607-614,
EMIT_data/emit_tools.py:34-125, s2_emit/emit_io.py:18-31).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

MAGIC = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


# ===========================================================================
# Reader
# ===========================================================================

@dataclass
class _Dataspace:
    shape: Tuple[int, ...]
    maxshape: Optional[Tuple[int, ...]] = None  # UNDEF entry = unlimited


@dataclass
class _Datatype:
    cls: int
    size: int
    byte_order: str = "<"
    signed: bool = True
    is_string: bool = False
    is_vlen_string: bool = False

    def numpy_dtype(self) -> np.dtype:
        if self.is_vlen_string:
            # raw global-heap descriptors {len u32, heap addr u64, idx
            # u32}; kept as opaque bytes (void) so trailing NULs survive
            # until the reader resolves them against the global heap
            return np.dtype(f"V{self.size}")
        if self.is_string:
            return np.dtype(f"S{self.size}")
        if self.cls == 0:  # fixed-point
            kind = "i" if self.signed else "u"
            return np.dtype(f"{self.byte_order}{kind}{self.size}")
        if self.cls == 1:  # float
            return np.dtype(f"{self.byte_order}f{self.size}")
        raise ValueError(f"Unsupported datatype class {self.cls}")


@dataclass
class Dataset:
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    layout: str  # "contiguous" | "chunked" | "compact"
    data_addr: int = UNDEF
    data_size: int = 0
    chunk_shape: Optional[Tuple[int, ...]] = None
    btree_addr: int = UNDEF
    filters: List[Tuple[int, Tuple[int, ...]]] = field(default_factory=list)
    fillvalue: Optional[bytes] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    compact_data: Optional[bytes] = None
    # v4-layout chunk index descriptor: ("single",addr,size,mask) |
    # ("implicit",addr,nbytes) | ("fixed",fahd_addr) |
    # ("extensible",eahd_addr) | ("btree2",bthd_addr); None => v1 B-tree
    chunk_index: Optional[tuple] = None
    # maxshape entry None = unlimited dimension (netcdf-c record dims)
    maxshape: Optional[Tuple[Optional[int], ...]] = None
    vlen_string: bool = False
    _file: Optional["HDF5File"] = None

    # ---- data access ----

    def __getitem__(self, key) -> np.ndarray:
        return self.read()[key]

    def read_band_range(self, b0: int, b1: int) -> np.ndarray:
        """Hyperslab read of [..., b0:b1) along the last axis. For
        chunked datasets only the intersecting chunks are decoded — the
        access pattern of the 32-band streaming loop
        (emit_proj.py:969-987) without decoding the full cube per slab."""
        b0 = max(0, int(b0))
        b1 = min(int(self.shape[-1]), int(b1))
        if self.layout != "chunked":
            return self.read()[..., b0:b1]
        f = self._file
        out_shape = self.shape[:-1] + (b1 - b0,)
        out = np.zeros(out_shape, dtype=self.dtype)
        if self.fillvalue:
            out[...] = np.frombuffer(self.fillvalue, dtype=self.dtype)[0]
        cb = self.chunk_shape[-1]
        metas = [m for m in f._iter_dataset_chunks(self)
                 if m[0][-1] + cb > b0 and m[0][-1] < b1]
        for offsets, chunk in self._decode_chunks(metas):
            c0 = offsets[-1]
            # intersection along the band axis
            s0 = max(b0, c0)
            s1 = min(b1, c0 + cb, self.shape[-1])
            sl = tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(offsets[:-1], self.chunk_shape[:-1],
                                   self.shape[:-1]))
            csl = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl + (slice(s0 - b0, s1 - b0),)] = \
                chunk[csl + (slice(s0 - c0, s1 - c0),)]
        if self.vlen_string:
            return self._resolve_vlen_strings(out)
        return out

    def _decode_chunks(self, metas):
        """Decode a list of chunk descriptors [(offsets, addr, size,
        mask)] into [(offsets, chunk_array)].

        Fast path: when the filter pipeline is the netcdf-standard
        [deflate] or [shuffle, deflate] with no per-chunk filter-mask
        exceptions, chunks are inflated with zlib across a thread pool
        (zlib.decompress releases the GIL, so this scales with host
        cores — measured faster than the native block codec's
        per-call ``uncompress`` on this image's CPython zlib) and
        unshuffled as ONE vectorized transpose over all chunks."""
        if not metas:
            return
        f = self._file
        fids = [fid for fid, _ in self.filters]
        chunk_nbytes = (int(np.prod(self.chunk_shape))
                        * self.dtype.itemsize)
        batched = (len(metas) > 1 and fids in ([1], [2, 1])
                   and all(m == 0 for *_x, m in metas))
        if not batched:
            for offsets, addr, size, mask in metas:
                raw = self._defilter(f._pread(addr, size), mask)
                yield offsets, np.frombuffer(raw, dtype=self.dtype).reshape(
                    self.chunk_shape)
            return
        import os
        raws = [f._pread(addr, size) for _, addr, size, _ in metas]
        nthreads = min(8, os.cpu_count() or 1, len(raws))
        if nthreads > 1:
            blocks = list(f.decode_pool(nthreads).map(zlib.decompress,
                                                      raws))
        else:
            blocks = [zlib.decompress(r) for r in raws]
        n = len(blocks)
        stack = np.frombuffer(b"".join(blocks), dtype=np.uint8)
        if fids == [2, 1]:  # unshuffle, vectorized across chunks
            cd = dict(self.filters)[2]
            elem = cd[0] if cd else self.dtype.itemsize
            stack = np.ascontiguousarray(
                stack.reshape(n, elem, chunk_nbytes // elem)
                .transpose(0, 2, 1))
        arr = stack.reshape(n, chunk_nbytes).view(self.dtype).reshape(
            (n,) + tuple(self.chunk_shape))
        for i, (offsets, *_rest) in enumerate(metas):
            yield offsets, arr[i]

    def _resolve_vlen_strings(self, raw_arr: np.ndarray) -> np.ndarray:
        """Raw 16-byte VL descriptors -> object array of decoded strings
        (resolved through the file's global heap collections)."""
        f = self._file
        flat = raw_arr.reshape(-1)
        out = np.empty(flat.shape[0], dtype=object)
        for i in range(flat.shape[0]):
            rec = bytes(flat[i])
            length, gaddr, gidx = struct.unpack("<IQI", rec)
            if length == 0 or gaddr in (0, UNDEF):
                out[i] = ""
                continue
            out[i] = f._read_global_heap(gaddr, gidx)[:length].decode(
                "utf-8", "replace")
        return out.reshape(raw_arr.shape)

    def read(self) -> np.ndarray:
        if self.vlen_string:
            return self._resolve_vlen_strings(self._read_raw())
        return self._read_raw()

    def _read_raw(self) -> np.ndarray:
        f = self._file
        if self.layout == "compact":
            arr = np.frombuffer(self.compact_data, dtype=self.dtype)
            return arr.reshape(self.shape).copy()
        if self.layout == "contiguous":
            if self.data_addr == UNDEF:
                fill = self.fillvalue or b"\x00" * self.dtype.itemsize
                arr = np.frombuffer(
                    fill * int(np.prod(self.shape, dtype=np.int64)),
                    dtype=self.dtype)
                return arr.reshape(self.shape).copy()
            raw = f._pread(self.data_addr, self.data_size)
            arr = np.frombuffer(raw, dtype=self.dtype)
            return arr.reshape(self.shape).copy()
        # chunked
        out = np.zeros(self.shape, dtype=self.dtype)
        if self.fillvalue:
            fv = np.frombuffer(self.fillvalue, dtype=self.dtype)[0]
            out[...] = fv
        metas = list(f._iter_dataset_chunks(self))
        for offsets, chunk in self._decode_chunks(metas):
            sl = tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(offsets, self.chunk_shape, self.shape))
            csl = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl] = chunk[csl]
        return out

    def _defilter(self, raw: bytes, filter_mask: int) -> bytes:
        # filters apply in reverse on read; skip those disabled in the mask
        for i in range(len(self.filters) - 1, -1, -1):
            fid, cd = self.filters[i]
            if filter_mask & (1 << i):
                continue
            if fid == 1:  # deflate
                raw = zlib.decompress(raw)
            elif fid == 2:  # shuffle
                elem = cd[0] if cd else self.dtype.itemsize
                n = len(raw) // elem
                arr = np.frombuffer(raw, dtype=np.uint8).reshape(elem, n)
                raw = arr.T.tobytes()
            elif fid == 3:  # fletcher32: strip trailing checksum
                raw = raw[:-4]
            else:
                raise ValueError(f"Unsupported HDF5 filter id {fid}")
        return raw


@dataclass
class Group:
    name: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    groups: Dict[str, "Group"] = field(default_factory=dict)
    datasets: Dict[str, Dataset] = field(default_factory=dict)

    @property
    def variables(self) -> Dict[str, Dataset]:
        return self.datasets

    def __getitem__(self, name: str):
        if name in self.datasets:
            return self.datasets[name]
        if name in self.groups:
            return self.groups[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self.datasets or name in self.groups


class HDF5File:
    """Read-only HDF5 file over the EMIT granule subset."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        self._parse_superblock()
        self.root = self._read_group(self._root_header_addr, "/")

    # ---- python niceties ----

    def close(self):
        pool = getattr(self, "_decode_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._decode_pool = None
        self._fh.close()

    def decode_pool(self, n_threads: int):
        """Lazily created shared inflate thread pool (one per file —
        the 32-band streaming loop decodes a slab per call and should
        not pay pool setup/teardown each time)."""
        pool = getattr(self, "_decode_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = self._decode_pool = ThreadPoolExecutor(n_threads)
        return pool

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def attrs(self):
        return self.root.attrs

    @property
    def groups(self):
        return self.root.groups

    @property
    def variables(self):
        return self.root.datasets

    # ---- low-level ----

    def _pread(self, addr: int, size: int) -> bytes:
        self._fh.seek(addr)
        return self._fh.read(size)

    def _parse_superblock(self):
        head = self._pread(0, 8)
        if head != MAGIC:
            raise ValueError(f"Not an HDF5 file: {self.path}")
        version = self._pread(8, 1)[0]
        if version == 0:
            blk = self._pread(8, 56)
            size_offsets = blk[5]
            size_lengths = blk[6]
            if size_offsets != 8 or size_lengths != 8:
                raise ValueError("Only 8-byte offsets/lengths supported")
            # root group symbol table entry at offset 8+24 = byte 24 of blk
            # superblock v0: after 24 bytes of fields come base addr etc (4*8),
            # then the root group symbol table entry
            # layout: ver(1) fsver(1) rgver(1) res(1) shver(1) so(1) sl(1)
            #         res(1) gln(2) gin(2) flags(4)  -> 16 bytes
            # base(8) fsaddr(8) eof(8) driver(8) -> 48... then STE
            ste = self._pread(8 + 16 + 32, 40)
            # symbol table entry: link name offset(8) header addr(8) ...
            self._root_header_addr = struct.unpack("<Q", ste[8:16])[0]
        elif version in (2, 3):
            blk = self._pread(8, 40)
            size_offsets = blk[1]
            size_lengths = blk[2]
            if size_offsets != 8 or size_lengths != 8:
                raise ValueError("Only 8-byte offsets/lengths supported")
            self._root_header_addr = struct.unpack("<Q", blk[28:36])[0]
        else:
            raise ValueError(f"Unsupported superblock version {version}")

    # ---- object headers ----

    def _read_messages(self, addr: int) -> List[Tuple[int, bytes, int]]:
        """Returns [(msg_type, body, flags)] for object header at addr."""
        sig = self._pread(addr, 4)
        if sig == b"OHDR":
            return self._read_messages_v2(addr)
        return self._read_messages_v1(addr)

    def _read_messages_v1(self, addr: int) -> List[Tuple[int, bytes, int]]:
        hdr = self._pread(addr, 16)
        version = hdr[0]
        if version != 1:
            raise ValueError(f"Unsupported object header version {version}")
        nmsgs = struct.unpack("<H", hdr[2:4])[0]
        header_size = struct.unpack("<I", hdr[8:12])[0]
        msgs: List[Tuple[int, bytes, int]] = []
        # message data begins after 16-byte prefix (12 + 4 pad)
        blocks = [(addr + 16, header_size)]
        count = 0
        bi = 0
        while bi < len(blocks) and count < nmsgs:
            baddr, bsize = blocks[bi]
            bi += 1
            pos = baddr
            end = baddr + bsize
            while pos + 8 <= end and count < nmsgs:
                mh = self._pread(pos, 8)
                mtype, msize, mflags = struct.unpack("<HHB", mh[:5])
                body = self._pread(pos + 8, msize)
                if mtype == 0x0010:  # continuation
                    caddr, csize = struct.unpack("<QQ", body[:16])
                    blocks.append((caddr, csize))
                else:
                    msgs.append((mtype, body, mflags))
                count += 1
                pos += 8 + msize
        return msgs

    def _read_messages_v2(self, addr: int) -> List[Tuple[int, bytes, int]]:
        hdr = self._pread(addr, 6)
        assert hdr[:4] == b"OHDR"
        flags = hdr[5]
        pos = addr + 6
        if flags & 0x20:
            pos += 16  # access/mod/change/birth times, 4 x u32
        if flags & 0x10:
            pos += 4  # max compact/dense attrs
        size_bytes = 1 << (flags & 0x3)
        size_of_chunk0 = int.from_bytes(self._pread(pos, size_bytes), "little")
        pos += size_bytes
        track_order = bool(flags & 0x04)
        msgs: List[Tuple[int, bytes, int]] = []
        # chunk-0 size covers message data only (checksum follows it);
        # an OCHK continuation's size includes its signature AND checksum.
        blocks = [(pos, size_of_chunk0)]
        bi = 0
        while bi < len(blocks):
            baddr, bsize = blocks[bi]
            bi += 1
            p = baddr
            end = baddr + bsize
            while p + 4 <= end:
                mh = self._pread(p, 4)
                mtype = mh[0]
                msize = struct.unpack("<H", mh[1:3])[0]
                mflags = mh[3]
                p += 4
                if track_order:
                    p += 2
                body = self._pread(p, msize)
                if mtype == 0x10:
                    caddr, csize = struct.unpack("<QQ", body[:16])
                    blocks.append((caddr + 4, csize - 8))
                else:
                    msgs.append((mtype, body, mflags))
                p += msize
        return msgs

    # ---- message parsing ----

    @staticmethod
    def _parse_dataspace(body: bytes) -> _Dataspace:
        version = body[0]
        rank = body[1]
        flags = body[2]
        if version == 1:
            off = 8
        elif version == 2:
            off = 4
        else:
            raise ValueError(f"Dataspace version {version}")
        dims = struct.unpack(f"<{rank}Q", body[off:off + 8 * rank])
        maxdims = None
        if flags & 0x01:
            off += 8 * rank
            maxdims = tuple(int(d) for d in struct.unpack(
                f"<{rank}Q", body[off:off + 8 * rank]))
        return _Dataspace(tuple(int(d) for d in dims), maxdims)

    @staticmethod
    def _parse_datatype(body: bytes) -> _Datatype:
        cls_ver = body[0]
        cls = cls_ver & 0x0F
        bits0, bits8, bits16 = body[1], body[2], body[3]
        size = struct.unpack("<I", body[4:8])[0]
        if cls == 0:  # fixed point
            byte_order = ">" if (bits0 & 1) else "<"
            signed = bool(bits0 & 0x08)
            return _Datatype(cls, size, byte_order, signed)
        if cls == 1:  # float
            byte_order = ">" if (bits0 & 1) else "<"
            return _Datatype(cls, size, byte_order)
        if cls == 3:  # string
            return _Datatype(cls, size, is_string=True)
        if cls == 9:  # variable length
            vtype = bits0 & 0x0F
            if vtype == 1:  # vlen string
                return _Datatype(cls, size, is_string=True, is_vlen_string=True)
        raise ValueError(f"Unsupported datatype class {cls}")

    def _parse_attribute(self, body: bytes) -> Tuple[str, Any]:
        version = body[0]
        if version == 1:
            name_size, dt_size, ds_size = struct.unpack("<HHH", body[2:8])
            off = 8
            pad = lambda n: (n + 7) & ~7
            name = body[off:off + name_size].split(b"\x00")[0].decode()
            off += pad(name_size)
            dt = self._parse_datatype(body[off:off + dt_size])
            off += pad(dt_size)
            ds = self._parse_dataspace(body[off:off + ds_size])
            off += pad(ds_size)
        elif version in (2, 3):
            name_size, dt_size, ds_size = struct.unpack("<HHH", body[2:8])
            off = 8
            if version == 3:
                off += 1  # name character-set encoding
            name = body[off:off + name_size].split(b"\x00")[0].decode()
            off += name_size
            dt = self._parse_datatype(body[off:off + dt_size])
            off += dt_size
            ds = self._parse_dataspace(body[off:off + ds_size])
            off += ds_size
        else:
            raise ValueError(f"Attribute version {version}")
        value = self._decode_attr_value(body[off:], dt, ds)
        return name, value

    def _decode_attr_value(self, raw: bytes, dt: _Datatype, ds: _Dataspace):
        n = int(np.prod(ds.shape)) if ds.shape else 1
        if dt.is_vlen_string:
            vals = []
            for i in range(n):
                rec = raw[i * 16:(i + 1) * 16]
                length, gaddr, gidx = struct.unpack("<IQI", rec)
                vals.append(self._read_global_heap(gaddr, gidx)[:length].decode(
                    "utf-8", "replace"))
            return vals[0] if not ds.shape else vals
        if dt.is_string:
            vals = [raw[i * dt.size:(i + 1) * dt.size].split(b"\x00")[0]
                    .decode("utf-8", "replace") for i in range(n)]
            return vals[0] if not ds.shape else vals
        arr = np.frombuffer(raw[:n * dt.size], dtype=dt.numpy_dtype())
        if arr.size < n:
            # NULL dataspace (h5py.Empty) or truncated value: nothing
            # to decode — treat as unsupported, caller skips the attr
            raise ValueError("attribute value shorter than its dataspace")
        if not ds.shape:
            v = arr[0]
            return v.item() if arr.dtype.kind in "iuf" else v
        return arr.reshape(ds.shape).copy()

    def _read_global_heap(self, collection_addr: int, index: int) -> bytes:
        """Object ``index`` of the global-heap collection at
        ``collection_addr``. Each collection is parsed once into an
        {index: bytes} dict cached on the file — VL-string datasets
        resolve thousands of objects against the same collection."""
        cache = getattr(self, "_gcol_cache", None)
        if cache is None:
            cache = self._gcol_cache = {}
        objs = cache.get(collection_addr)
        if objs is None:
            raw = self._pread(collection_addr, 16)
            if raw[:4] != b"GCOL":
                raise ValueError("Bad global heap collection")
            size = struct.unpack("<Q", raw[8:16])[0]
            blob = self._pread(collection_addr, size)
            objs = {}
            pos = 16
            while pos + 16 <= size:
                idx, _refcount, _res, osize = struct.unpack(
                    "<HHIQ", blob[pos:pos + 16])
                if idx == 0:
                    break
                objs[idx] = blob[pos + 16:pos + 16 + osize]
                pos += 16 + ((osize + 7) & ~7)
            cache[collection_addr] = objs
        try:
            return objs[index]
        except KeyError:
            raise KeyError(f"Global heap object {index} not found") from None

    # ---- groups ----

    def _read_group(self, header_addr: int, name: str) -> Group:
        msgs = self._read_messages(header_addr)
        grp = Group(name)
        links: List[Tuple[str, int]] = []
        for mtype, body, _ in msgs:
            if mtype == 0x000C:
                try:
                    k, v = self._parse_attribute(body)
                except (ValueError, KeyError, struct.error):
                    continue  # e.g. object-reference attrs (REFERENCE_LIST)
                grp.attrs[k] = v
            elif mtype == 0x0011:  # symbol table
                btree_addr, heap_addr = struct.unpack("<QQ", body[:16])
                links.extend(self._read_symbol_table(btree_addr, heap_addr))
            elif mtype == 0x0006:  # link message (v2 compact groups)
                lk = self._parse_link_message(body)
                if lk is not None:
                    links.append(lk)
            elif mtype == 0x0002:  # link info (v2 dense groups)
                for msg in self._dense_link_messages(body):
                    lk = self._parse_link_message(msg)
                    if lk is not None:
                        links.append(lk)
            elif mtype == 0x0015:  # attribute info (dense attributes)
                for k, v in self._dense_attributes(body):
                    grp.attrs[k] = v
        for child_name, child_addr in links:
            child_msgs = self._read_messages(child_addr)
            types = {m[0] for m in child_msgs}
            if 0x0008 in types or 0x0003 in types:  # layout/datatype => dataset
                ds = self._read_dataset(child_msgs, child_name)
                grp.datasets[child_name] = ds
            else:
                grp.groups[child_name] = self._read_group(child_addr, child_name)
        return grp

    def _parse_link_message(self, body: bytes) -> Optional[Tuple[str, int]]:
        version = body[0]
        flags = body[1]
        pos = 2
        ltype = 0
        if flags & 0x08:
            ltype = body[pos]
            pos += 1
        if flags & 0x04:
            pos += 8  # creation order
        if flags & 0x10:
            pos += 1  # charset
        len_size = 1 << (flags & 0x3)
        name_len = int.from_bytes(body[pos:pos + len_size], "little")
        pos += len_size
        name = body[pos:pos + name_len].decode()
        pos += name_len
        if ltype == 0:  # hard link
            addr = struct.unpack("<Q", body[pos:pos + 8])[0]
            return name, addr
        return None

    def _read_symbol_table(self, btree_addr: int, heap_addr: int):
        # local heap data segment address
        lh = self._pread(heap_addr, 32)
        if lh[:4] != b"HEAP":
            raise ValueError("Bad local heap")
        data_addr = struct.unpack("<Q", lh[24:32])[0]

        entries: List[Tuple[str, int]] = []

        def walk(node_addr: int):
            head = self._pread(node_addr, 24)
            if head[:4] != b"TREE":
                raise ValueError("Bad group B-tree node")
            node_type, node_level = head[4], head[5]
            nchildren = struct.unpack("<H", head[6:8])[0]
            # keys/children: (2*nchildren+1) keys of 8 bytes, children 8 bytes
            body = self._pread(node_addr + 24,
                               (2 * nchildren + 1) * 8)
            vals = struct.unpack(f"<{2 * nchildren + 1}Q", body)
            children = [vals[2 * i + 1] for i in range(nchildren)]
            for c in children:
                if node_level > 0:
                    walk(c)
                else:
                    snod = self._pread(c, 8)
                    if snod[:4] != b"SNOD":
                        raise ValueError("Bad symbol table node")
                    nsyms = struct.unpack("<H", snod[6:8])[0]
                    raw = self._pread(c + 8, nsyms * 40)
                    for i in range(nsyms):
                        e = raw[i * 40:(i + 1) * 40]
                        name_off, obj_addr = struct.unpack("<QQ", e[:16])
                        nm = self._read_heap_string(data_addr + name_off)
                        entries.append((nm, obj_addr))

        walk(btree_addr)
        return entries

    def _read_heap_string(self, addr: int) -> str:
        out = b""
        while True:
            chunk = self._pread(addr + len(out), 64)
            if b"\x00" in chunk:
                out += chunk.split(b"\x00")[0]
                break
            if not chunk:
                # EOF before a NUL terminator (truncated/corrupt file):
                # error out instead of spinning forever
                raise ValueError(
                    "Unterminated heap string (truncated file?)")
            out += chunk
        return out.decode()

    # ---- datasets ----

    def _read_dataset(self, msgs, name: str) -> Dataset:
        shape: Tuple[int, ...] = ()
        dtype = None
        layout = "contiguous"
        data_addr, data_size = UNDEF, 0
        chunk_shape = None
        btree_addr = UNDEF
        filters: List[Tuple[int, Tuple[int, ...]]] = []
        fill = None
        attrs: Dict[str, Any] = {}
        compact = None
        chunk_index = None
        maxshape = None
        for mtype, body, _ in msgs:
            if mtype == 0x0001:
                space = self._parse_dataspace(body)
                shape = space.shape
                if space.maxshape is not None:
                    maxshape = tuple(None if d == UNDEF else d
                                     for d in space.maxshape)
            elif mtype == 0x0003:
                dtype = self._parse_datatype(body)
            elif mtype == 0x0005:
                fill = self._parse_fill(body)
            elif mtype == 0x0008:
                (layout, data_addr, data_size, chunk_shape, btree_addr,
                 compact, chunk_index) = self._parse_layout(body)
            elif mtype == 0x000B:
                filters = self._parse_filters(body)
            elif mtype == 0x000C:
                try:
                    k, v = self._parse_attribute(body)
                except (ValueError, KeyError, struct.error):
                    continue  # unsupported attr datatype: skip, don't fail
                attrs[k] = v
            elif mtype == 0x0015:  # attribute info (dense attributes)
                for k, v in self._dense_attributes(body):
                    attrs[k] = v
        np_dtype = dtype.numpy_dtype() if dtype else np.dtype("f4")
        ds = Dataset(name=name, shape=shape, dtype=np_dtype, layout=layout,
                     data_addr=data_addr, data_size=data_size,
                     chunk_shape=chunk_shape, btree_addr=btree_addr,
                     filters=filters, fillvalue=fill, attrs=attrs,
                     compact_data=compact, chunk_index=chunk_index,
                     maxshape=maxshape,
                     vlen_string=bool(dtype and dtype.is_vlen_string))
        ds._file = self
        return ds

    @staticmethod
    def _parse_fill(body: bytes) -> Optional[bytes]:
        version = body[0]
        if version in (1, 2):
            # space alloc time, fill write time, defined flag
            defined = body[3]
            if version == 2 and not defined:
                return None
            size = struct.unpack("<I", body[4:8])[0]
            return body[8:8 + size] if size else None
        if version == 3:
            flags = body[1]
            if flags & 0x20:
                size = struct.unpack("<I", body[2:6])[0]
                return body[6:6 + size]
            return None
        return None

    @staticmethod
    def _parse_layout(body: bytes):
        version = body[0]
        layout = "contiguous"
        data_addr, data_size = UNDEF, 0
        chunk_shape = None
        btree_addr = UNDEF
        compact = None
        if version == 3:
            cls = body[1]
            if cls == 0:  # compact
                layout = "compact"
                size = struct.unpack("<H", body[2:4])[0]
                compact = body[4:4 + size]
            elif cls == 1:
                layout = "contiguous"
                data_addr, data_size = struct.unpack("<QQ", body[2:18])
            elif cls == 2:
                layout = "chunked"
                rank = body[2]
                btree_addr = struct.unpack("<Q", body[3:11])[0]
                dims = struct.unpack(f"<{rank}I", body[11:11 + 4 * rank])
                chunk_shape = tuple(int(d) for d in dims[:-1])  # last is elem size
            else:
                raise ValueError(f"Layout class {cls}")
        elif version == 4:
            # "latest"-format layout (h5py libver="latest"); chunked class
            # carries one of the new chunk-index types instead of a v1 B-tree
            cls = body[1]
            if cls == 0:
                layout = "compact"
                size = struct.unpack("<H", body[2:4])[0]
                compact = body[4:4 + size]
            elif cls == 1:
                layout = "contiguous"
                data_addr, data_size = struct.unpack("<QQ", body[2:18])
            elif cls == 2:
                layout = "chunked"
                flags = body[2]
                ndims = body[3]
                enc = body[4]
                pos = 5
                dims = [int.from_bytes(body[pos + i * enc:pos + (i + 1) * enc],
                                       "little") for i in range(ndims)]
                pos += ndims * enc
                chunk_shape = tuple(dims[:-1])  # last dim is element size
                chunk_nbytes = 1
                for d in dims:
                    chunk_nbytes *= d
                itype = body[pos]
                pos += 1
                if itype == 1:  # single chunk
                    fsize, fmask = chunk_nbytes, 0
                    if flags & 0x02:
                        fsize = struct.unpack("<Q", body[pos:pos + 8])[0]
                        fmask = struct.unpack("<I", body[pos + 8:pos + 12])[0]
                        pos += 12
                    addr = struct.unpack("<Q", body[pos:pos + 8])[0]
                    chunk_index = ("single", addr, fsize, fmask)
                elif itype == 2:  # implicit (unfiltered, fixed, contiguous)
                    addr = struct.unpack("<Q", body[pos:pos + 8])[0]
                    chunk_index = ("implicit", addr, chunk_nbytes)
                elif itype == 3:  # fixed array
                    pos += 1  # page bits (re-read from the FAHD header)
                    addr = struct.unpack("<Q", body[pos:pos + 8])[0]
                    chunk_index = ("fixed", addr)
                elif itype == 4:  # extensible array (1 unlimited dim)
                    pos += 5  # creation params (re-read from EAHD header)
                    addr = struct.unpack("<Q", body[pos:pos + 8])[0]
                    chunk_index = ("extensible", addr)
                elif itype == 5:  # v2 B-tree (>1 unlimited dim)
                    pos += 6  # node size(4)+split(1)+merge(1) (in BTHD)
                    addr = struct.unpack("<Q", body[pos:pos + 8])[0]
                    chunk_index = ("btree2", addr)
                else:
                    raise ValueError(f"Unsupported v4 chunk index type {itype}")
                return (layout, data_addr, data_size, chunk_shape,
                        btree_addr, compact, chunk_index)
            else:
                raise ValueError(f"Layout class {cls}")
        else:
            raise ValueError(f"Layout message version {version}")
        return layout, data_addr, data_size, chunk_shape, btree_addr, compact, None

    @staticmethod
    def _parse_filters(body: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
        version = body[0]
        nfilters = body[1]
        filters = []
        if version == 1:
            pos = 8
        else:
            pos = 2
        for _ in range(nfilters):
            fid = struct.unpack("<H", body[pos:pos + 2])[0]
            pos += 2
            # v2 omits the name-length field for built-in filters (id < 256)
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = struct.unpack("<H", body[pos:pos + 2])[0]
                pos += 2
            flags, ncd = struct.unpack("<HH", body[pos:pos + 4])
            pos += 4
            pos += (name_len + 7) & ~7 if version == 1 else name_len
            cd = struct.unpack(f"<{ncd}I", body[pos:pos + 4 * ncd])
            pos += 4 * ncd
            if version == 1 and ncd % 2 == 1:
                pos += 4
            filters.append((fid, tuple(int(c) for c in cd)))
        return filters

    def _iter_dataset_chunks(self, ds: Dataset):
        """Yield (offsets, addr, size, filter_mask) for every stored chunk of
        a chunked dataset, dispatching on its index type (v1 B-tree for
        classic files; Single Chunk / Implicit / Fixed Array for v4
        "latest"-format layouts)."""
        if ds.chunk_index is None:
            yield from self._iter_chunks(ds.btree_addr, len(ds.shape) + 1)
            return
        kind = ds.chunk_index[0]
        rank = len(ds.shape)
        grid = tuple(-(-s // c) for s, c in zip(ds.shape, ds.chunk_shape))
        if kind == "single":
            _, addr, size, mask = ds.chunk_index
            if addr != UNDEF:
                yield (0,) * rank, addr, size, mask
        elif kind == "implicit":
            _, base, nbytes = ds.chunk_index
            if base == UNDEF:
                return
            # chunk i sits at base + i*nbytes with i linearized over the
            # MAXSHAPE chunk grid (same stride contract as the fixed /
            # extensible indexes; current-shape strides silently
            # misplace rows when maxshape > shape on a fixed dim)
            max_grid = list(grid)
            if ds.maxshape is not None:
                for d, m in enumerate(ds.maxshape):
                    if m is not None:
                        max_grid[d] = -(-int(m) // ds.chunk_shape[d])
            for i, coord in enumerate(np.ndindex(*max_grid)):
                if any(coord[d] >= grid[d] for d in range(rank)):
                    continue  # beyond the current shape
                yield (tuple(o * c for o, c in zip(coord, ds.chunk_shape)),
                       base + i * nbytes, nbytes, 0)
        elif kind == "fixed":
            _, fahd_addr = ds.chunk_index
            if fahd_addr == UNDEF:
                return
            # element order is row-major over the MAXSHAPE chunk grid
            # (a fixed-but-resizable maxshape > shape changes the
            # strides even though no dim is unlimited)
            max_grid = list(grid)
            if ds.maxshape is not None:
                for d, m in enumerate(ds.maxshape):
                    if m is not None:
                        max_grid[d] = -(-int(m) // ds.chunk_shape[d])
            coords = list(np.ndindex(*max_grid))
            for i, (addr, size, mask) in enumerate(
                    self._read_fixed_array(fahd_addr,
                                           ds.chunk_shape, ds.dtype)):
                if addr == UNDEF or i >= len(coords):
                    continue
                coord = coords[i]
                if any(coord[d] >= grid[d] for d in range(rank)):
                    continue  # beyond the current shape
                yield (tuple(o * c for o, c in zip(coord, ds.chunk_shape)),
                       addr, size, mask)
        elif kind == "extensible":
            # element order is row-major over the chunk grid with the
            # (single) unlimited dimension swizzled to the front. The
            # grid strides use MAXSHAPE on the fixed dims — HDF5 derives
            # the element index from max dims so it stays stable when
            # the dataset is resized; the current shape only bounds how
            # far along the unlimited dim chunks exist.
            _, eahd_addr = ds.chunk_index
            if eahd_addr == UNDEF:
                return
            unlim = 0
            if ds.maxshape is not None:
                for d, m in enumerate(ds.maxshape):
                    if m is None:
                        unlim = d
                        break
            max_grid = list(grid)
            if ds.maxshape is not None:
                for d, m in enumerate(ds.maxshape):
                    if m is not None:
                        max_grid[d] = -(-int(m) // ds.chunk_shape[d])
            order = [unlim] + [d for d in range(rank) if d != unlim]
            sw_grid = [max_grid[d] for d in order]
            n_needed = int(grid[unlim]) * int(
                np.prod([max_grid[d] for d in order[1:]], dtype=np.int64))
            for i, (addr, size, mask) in enumerate(
                    self._read_extensible_array(eahd_addr, n_needed,
                                                ds.chunk_shape, ds.dtype)):
                if addr == UNDEF:
                    continue
                sw = np.unravel_index(i, sw_grid)
                coord = [0] * rank
                for d, v in zip(order, sw):
                    coord[d] = int(v)
                if any(coord[d] >= grid[d] for d in range(rank)):
                    continue  # beyond the current shape
                yield (tuple(o * c for o, c in zip(coord, ds.chunk_shape)),
                       addr, size, mask)
        elif kind == "btree2":
            _, bthd_addr = ds.chunk_index
            if bthd_addr == UNDEF:
                return
            for scaled, addr, size, mask in self._read_btree2_chunks(
                    bthd_addr, rank, ds.chunk_shape, ds.dtype):
                yield (tuple(o * c for o, c in zip(scaled, ds.chunk_shape)),
                       addr, size, mask)
        else:
            raise ValueError(f"Unknown chunk index kind {kind}")

    def _read_fixed_array(self, fahd_addr: int, chunk_shape, dtype):
        """Decode a Fixed Array chunk index (FAHD header + FADB data block,
        optionally paged). Yields (chunk_addr, stored_size, filter_mask)
        in element order."""
        hdr = self._pread(fahd_addr, 32)
        if hdr[:4] != b"FAHD":
            raise ValueError("Bad fixed-array header")
        client_id = hdr[5]  # 0 = unfiltered chunks, 1 = filtered chunks
        entry_size = hdr[6]
        page_bits = hdr[7]
        nelmts = struct.unpack("<Q", hdr[8:16])[0]
        db_addr = struct.unpack("<Q", hdr[16:24])[0]
        if db_addr == UNDEF or nelmts == 0:
            return
        raw_chunk_bytes = int(np.prod(chunk_shape)) * dtype.itemsize

        def parse(blob: bytes):
            pos = 0
            while pos + entry_size <= len(blob):
                addr = struct.unpack("<Q", blob[pos:pos + 8])[0]
                if client_id == 1:
                    szlen = entry_size - 12
                    size = int.from_bytes(blob[pos + 8:pos + 8 + szlen],
                                          "little")
                    mask = struct.unpack(
                        "<I", blob[pos + 8 + szlen:pos + entry_size])[0]
                else:
                    size, mask = raw_chunk_bytes, 0
                yield addr, size, mask
                pos += entry_size

        page_size = 1 << page_bits
        prefix = 6 + 8  # FADB signature/version/client-id + header address
        if nelmts <= page_size:
            blob = self._pread(db_addr, prefix + nelmts * entry_size + 4)
            if blob[:4] != b"FADB":
                raise ValueError("Bad fixed-array data block")
            yield from parse(blob[prefix:prefix + nelmts * entry_size])
        else:
            npages = -(-nelmts // page_size)
            bitmap_bytes = -(-npages // 8)
            db_size = prefix + bitmap_bytes + 4
            head = self._pread(db_addr, db_size)
            if head[:4] != b"FADB":
                raise ValueError("Bad fixed-array data block")
            # pages follow the data block back to back, each checksummed
            pos = db_addr + db_size
            remaining = nelmts
            for _ in range(npages):
                n = min(page_size, remaining)
                blob = self._pread(pos, n * entry_size)
                yield from parse(blob)
                pos += n * entry_size + 4  # + page checksum
                remaining -= n

    def _read_extensible_array(self, eahd_addr: int, n_needed: int,
                               chunk_shape, dtype):
        """Decode an Extensible Array chunk index (EAHD header, EAIB
        index block, EASB super blocks, EADB data blocks — optionally
        paged). Yields (chunk_addr, stored_size, filter_mask) for element
        indices 0..n_needed-1 (UNDEF address for unallocated). Structure
        follows the HDF5 spec's doubling scheme: the index block holds
        ``idx_blk_elmts`` inline elements plus direct pointers to the
        data blocks of the first ``2*log2(sup_blk_min_data_ptrs)`` super
        blocks; super block s has 2^(s//2) data blocks of
        ``data_blk_min_elmts * 2^((s+1)//2)`` elements each."""
        hdr = self._pread(eahd_addr, 72)
        if hdr[:4] != b"EAHD":
            raise ValueError("Bad extensible-array header")
        client_id = hdr[5]
        elem_size = hdr[6]
        max_nelmts_bits = hdr[7]
        idx_blk_elmts = hdr[8]
        data_blk_min_elmts = hdr[9]
        sup_blk_min_data_ptrs = hdr[10]
        max_dblk_page_nelmts_bits = hdr[11]
        iblk_addr = struct.unpack("<Q", hdr[12 + 6 * 8:12 + 6 * 8 + 8])[0]
        if iblk_addr == UNDEF:
            for _ in range(n_needed):
                yield UNDEF, 0, 0
            return
        raw_chunk_bytes = int(np.prod(chunk_shape)) * dtype.itemsize
        arr_off_size = (max_nelmts_bits + 7) // 8
        page_nelmts = 1 << max_dblk_page_nelmts_bits

        def parse_elems(blob: bytes, n: int):
            out = []
            for i in range(n):
                rec = blob[i * elem_size:(i + 1) * elem_size]
                addr = struct.unpack("<Q", rec[:8])[0]
                if client_id == 1:
                    szlen = elem_size - 12
                    size = int.from_bytes(rec[8:8 + szlen], "little")
                    mask = struct.unpack("<I", rec[8 + szlen:])[0]
                else:
                    size, mask = raw_chunk_bytes, 0
                out.append((addr, size, mask))
            return out

        def sblk_ndblks(s):
            return 1 << (s // 2)

        def sblk_dblk_nelmts(s):
            return data_blk_min_elmts * (1 << ((s + 1) // 2))

        def read_dblock(addr, nelmts):
            """Elements of one data block (handles paged blocks)."""
            if addr == UNDEF:
                return [(UNDEF, 0, 0)] * nelmts
            prefix = 6 + 8 + arr_off_size  # sig/ver/client + hdr + offset
            if nelmts <= page_nelmts:
                blob = self._pread(addr, prefix + nelmts * elem_size)
                if blob[:4] != b"EADB":
                    raise ValueError("Bad extensible-array data block")
                return parse_elems(blob[prefix:], nelmts)
            # paged: pages (elements + checksum each) follow the prefix
            head = self._pread(addr, prefix)
            if head[:4] != b"EADB":
                raise ValueError("Bad extensible-array data block")
            out = []
            pos = addr + prefix + 4  # + data-block checksum
            remaining = nelmts
            while remaining > 0:
                n = min(page_nelmts, remaining)
                blob = self._pread(pos, n * elem_size)
                out.extend(parse_elems(blob, n))
                pos += n * elem_size + 4  # + page checksum
                remaining -= n
            return out

        # ---- index block ----
        nsblks_total = 1 + (max_nelmts_bits
                            - (data_blk_min_elmts.bit_length() - 1))
        iblk_nsblks = 2 * (sup_blk_min_data_ptrs.bit_length() - 1)
        ndblk_addrs = 2 * (sup_blk_min_data_ptrs - 1)
        nsblk_addrs = max(0, nsblks_total - iblk_nsblks)
        prefix = 6 + 8
        iblk_size = (prefix + idx_blk_elmts * elem_size
                     + (ndblk_addrs + nsblk_addrs) * 8 + 4)
        blob = self._pread(iblk_addr, iblk_size)
        if blob[:4] != b"EAIB":
            raise ValueError("Bad extensible-array index block")
        pos = prefix
        inline = parse_elems(blob[pos:], idx_blk_elmts)
        pos += idx_blk_elmts * elem_size
        dblk_addrs = list(struct.unpack(f"<{ndblk_addrs}Q",
                                        blob[pos:pos + ndblk_addrs * 8]))
        pos += ndblk_addrs * 8
        sblk_addrs = list(struct.unpack(f"<{nsblk_addrs}Q",
                                        blob[pos:pos + nsblk_addrs * 8]))

        dblock_cache: Dict[Tuple[int, int], list] = {}
        sblock_cache: Dict[int, list] = {}

        def read_sblock(s):
            """Data-block addresses of super block s (>= iblk_nsblks)."""
            if s in sblock_cache:
                return sblock_cache[s]
            addr = sblk_addrs[s - iblk_nsblks]
            nd = sblk_ndblks(s)
            if addr == UNDEF:
                sblock_cache[s] = [UNDEF] * nd
                return sblock_cache[s]
            dblk_nelmts = sblk_dblk_nelmts(s)
            npages = (dblk_nelmts + page_nelmts - 1) // page_nelmts \
                if dblk_nelmts > page_nelmts else 0
            bitmap_bytes = (nd * npages + 7) // 8 if npages else 0
            pre = 6 + 8 + arr_off_size + bitmap_bytes
            blob = self._pread(addr, pre + nd * 8)
            if blob[:4] != b"EASB":
                raise ValueError("Bad extensible-array super block")
            sblock_cache[s] = list(struct.unpack(f"<{nd}Q",
                                                 blob[pre:pre + nd * 8]))
            return sblock_cache[s]

        for idx in range(n_needed):
            if idx < idx_blk_elmts:
                yield inline[idx]
                continue
            u = idx - idx_blk_elmts
            s = (u // data_blk_min_elmts + 1).bit_length() - 1
            start = ((1 << s) - 1) * data_blk_min_elmts
            rel = u - start
            dblk_nelmts = sblk_dblk_nelmts(s)
            di = rel // dblk_nelmts
            ei = rel % dblk_nelmts
            if s < iblk_nsblks:
                gdi = sum(sblk_ndblks(t) for t in range(s)) + di
                daddr = dblk_addrs[gdi] if gdi < len(dblk_addrs) else UNDEF
            else:
                addrs = read_sblock(s)
                daddr = addrs[di] if di < len(addrs) else UNDEF
            key = (s, di)
            if key not in dblock_cache:
                dblock_cache[key] = read_dblock(daddr, dblk_nelmts)
            yield dblock_cache[key][ei]

    def _walk_btree2(self, bthd_addr: int):
        """Generic version-2 B-tree traversal (BTHD header, BTIN
        internal / BTLF leaf nodes). Yields (btree_type, raw_record
        bytes) for every record; callers parse per record type."""
        if bthd_addr == UNDEF:
            return
        hdr = self._pread(bthd_addr, 42)
        if hdr[:4] != b"BTHD":
            raise ValueError("Bad v2 B-tree header")
        btype = hdr[5]
        node_size, record_size, depth = struct.unpack("<IHH", hdr[6:14])
        root_addr, root_nrec = struct.unpack("<QH", hdr[16:26])
        if root_addr == UNDEF or root_nrec == 0:
            return

        def enc_size(v: int) -> int:
            return (max(v, 1).bit_length() - 1) // 8 + 1

        # per-level max-record math: pointer/record field sizes
        leaf_max = (node_size - 10) // record_size
        max_nrec_size = enc_size(leaf_max)
        cum_max = [leaf_max]
        cum_max_size = [0]
        for u in range(1, depth + 1):
            ptr = 8 + max_nrec_size + cum_max_size[u - 1]
            mx = (node_size - (10 + ptr)) // (record_size + ptr)
            cm = (mx + 1) * cum_max[u - 1] + mx
            cum_max.append(cm)
            cum_max_size.append(enc_size(cm))

        def walk(addr: int, nrec: int, level: int):
            blob = self._pread(addr, node_size)
            sig = blob[:4]
            pos = 6
            records = []
            for _ in range(nrec):
                records.append((btype, blob[pos:pos + record_size]))
                pos += record_size
            if level == 0:
                if sig != b"BTLF":
                    raise ValueError("Bad v2 B-tree leaf node")
                yield from records
                return
            if sig != b"BTIN":
                raise ValueError("Bad v2 B-tree internal node")
            ptr_extra = max_nrec_size + (cum_max_size[level - 1]
                                         if level > 1 else 0)
            children = []
            for _ in range(nrec + 1):
                caddr = struct.unpack("<Q", blob[pos:pos + 8])[0]
                cnrec = int.from_bytes(
                    blob[pos + 8:pos + 8 + max_nrec_size], "little")
                pos += 8 + ptr_extra
                children.append((caddr, cnrec))
            for i, (caddr, cnrec) in enumerate(children):
                yield from walk(caddr, cnrec, level - 1)
                if i < nrec:
                    yield records[i]

        yield from walk(root_addr, root_nrec, depth)

    def _read_btree2_chunks(self, bthd_addr: int, rank: int,
                            chunk_shape, dtype):
        """Decode a version-2 B-tree chunk index (record types 10 =
        unfiltered and 11 = filtered dataset chunks). Yields
        (scaled_coords, chunk_addr, stored_size, filter_mask)."""
        raw_chunk_bytes = int(np.prod(chunk_shape)) * dtype.itemsize
        for btype, rec in self._walk_btree2(bthd_addr):
            if btype not in (10, 11):
                raise ValueError(
                    f"v2 B-tree type {btype} is not a chunk index")
            addr = struct.unpack("<Q", rec[:8])[0]
            if btype == 11:
                szlen = len(rec) - 8 - 4 - 8 * rank
                if szlen < 1:
                    raise ValueError("Bad filtered-chunk record size")
                size = int.from_bytes(rec[8:8 + szlen], "little")
                mask = struct.unpack("<I", rec[8 + szlen:8 + szlen + 4])[0]
                off = 8 + szlen + 4
            else:
                size, mask = raw_chunk_bytes, 0
                off = 8
            scaled = struct.unpack(f"<{rank}Q", rec[off:off + 8 * rank])
            yield tuple(int(s) for s in scaled), addr, size, mask

    # ---- fractal heap (dense link / attribute storage) ----

    def _fractal_heap(self, frhp_addr: int) -> "_FractalHeap":
        cache = getattr(self, "_fheap_cache", None)
        if cache is None:
            cache = self._fheap_cache = {}
        if frhp_addr not in cache:
            cache[frhp_addr] = _FractalHeap(self, frhp_addr)
        return cache[frhp_addr]

    def _dense_link_messages(self, body: bytes):
        """Link Info message (0x0002) -> the dense-storage link message
        bodies (fractal heap objects reached through the name-index v2
        B-tree, record type 5 = {hash u32, heap ID})."""
        flags = body[1]
        pos = 2 + (8 if flags & 0x01 else 0)  # max creation index
        fheap_addr, name_bt_addr = struct.unpack("<QQ",
                                                 body[pos:pos + 16])
        if fheap_addr == UNDEF or name_bt_addr == UNDEF:
            return
        heap = self._fractal_heap(fheap_addr)
        for btype, rec in self._walk_btree2(name_bt_addr):
            if btype != 5:
                raise ValueError(f"Unexpected link-name B-tree type {btype}")
            yield heap.get(rec[4:])  # skip the 4-byte name hash

    def _dense_attributes(self, body: bytes):
        """Attribute Info message (0x0015) -> decoded (name, value)
        pairs from dense attribute storage (fractal heap + name-index
        v2 B-tree, record type 8 = {heap ID 8B, flags, corder, hash})."""
        flags = body[1]
        pos = 2 + (2 if flags & 0x01 else 0)  # max creation index
        fheap_addr, name_bt_addr = struct.unpack("<QQ",
                                                 body[pos:pos + 16])
        if fheap_addr == UNDEF or name_bt_addr == UNDEF:
            return
        heap = self._fractal_heap(fheap_addr)
        for btype, rec in self._walk_btree2(name_bt_addr):
            if btype != 8:
                raise ValueError(f"Unexpected attr-name B-tree type {btype}")
            msg = heap.get(rec[:8])
            try:
                yield self._parse_attribute(msg)
            except (ValueError, KeyError, struct.error):
                continue  # unsupported attr datatype: skip, don't fail

    def _iter_chunks(self, btree_addr: int, rank_plus1: int):
        """Yield (offsets, addr, size, filter_mask) from a v1 chunk B-tree."""
        if btree_addr == UNDEF:
            return
        key_size = 8 + 8 * rank_plus1

        def walk(addr: int):
            head = self._pread(addr, 24)
            if head[:4] != b"TREE":
                raise ValueError("Bad chunk B-tree node")
            node_level = head[5]
            nused = struct.unpack("<H", head[6:8])[0]
            body = self._pread(addr + 24,
                               nused * (key_size + 8) + key_size)
            pos = 0
            for i in range(nused):
                key = body[pos:pos + key_size]
                pos += key_size
                child = struct.unpack("<Q", body[pos:pos + 8])[0]
                pos += 8
                size, mask = struct.unpack("<II", key[:8])
                offs = struct.unpack(f"<{rank_plus1}Q", key[8:])
                if node_level > 0:
                    yield from walk(child)
                else:
                    yield tuple(int(o) for o in offs[:-1]), child, size, mask

        yield from walk(btree_addr)


class _FractalHeap:
    """Managed-object fractal heap reader (FRHP header + FHDB direct
    blocks via the doubling table; dense link/attribute storage uses
    managed objects only). Heap IDs address the managed space in which
    each direct block's own header occupies the leading bytes, so an
    object read is block_addr + (heap_offset - block_start)."""

    def __init__(self, f: "HDF5File", frhp_addr: int):
        self.f = f
        hdr = f._pread(frhp_addr, 142)
        if hdr[:4] != b"FRHP":
            raise ValueError("Bad fractal heap header")
        self.heap_id_len = struct.unpack("<H", hdr[5:7])[0]
        io_filter_len = struct.unpack("<H", hdr[7:9])[0]
        if io_filter_len:
            raise ValueError("Filtered fractal heaps not supported")
        self.flags = hdr[9]
        (self.table_width,) = struct.unpack("<H", hdr[110:112])
        (self.start_size, self.max_dblk_size) = struct.unpack(
            "<QQ", hdr[112:128])
        (self.max_heap_bits, _start_rows) = struct.unpack(
            "<HH", hdr[128:132])
        (self.root_addr,) = struct.unpack("<Q", hdr[132:140])
        (self.cur_root_rows,) = struct.unpack("<H", hdr[140:142])
        self.off_size = (self.max_heap_bits + 7) // 8
        self.len_size = self.heap_id_len - 1 - self.off_size
        if self.len_size < 1:
            raise ValueError("Bad fractal heap ID geometry")
        self.max_direct_rows = (
            (self.max_dblk_size.bit_length()
             - self.start_size.bit_length()) + 2)
        # row -> list of direct block addresses (lazy, via indirects)
        self._rows: Dict[int, List[int]] = {}

    def _row_geometry(self, row: int) -> Tuple[int, int]:
        """(start_offset, block_size) of a doubling-table row."""
        W, S = self.table_width, self.start_size
        if row == 0:
            return 0, S
        return W * S * (1 << (row - 1)), S * (1 << max(0, row - 1))

    def _load_root(self):
        if self._rows:
            return
        if self.cur_root_rows == 0:
            # root IS a single direct block (row 0, col 0)
            self._rows[0] = [self.root_addr]
            return
        nrows = self.cur_root_rows
        if nrows > self.max_direct_rows:
            raise ValueError("Nested indirect fractal heap blocks "
                             "not supported")
        prefix = 4 + 1 + 8 + self.off_size
        blob = self.f._pread(self.root_addr,
                             prefix + nrows * self.table_width * 8 + 4)
        if blob[:4] != b"FHIB":
            raise ValueError("Bad fractal heap indirect block")
        pos = prefix
        for row in range(nrows):
            addrs = []
            for _ in range(self.table_width):
                addrs.append(struct.unpack("<Q", blob[pos:pos + 8])[0])
                pos += 8
            self._rows[row] = addrs

    def get(self, heap_id: bytes) -> bytes:
        """Object bytes for a managed heap ID."""
        idtype = (heap_id[0] >> 4) & 0x03
        if idtype != 0:
            raise ValueError(f"Non-managed fractal heap ID type {idtype}")
        off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
        length = int.from_bytes(
            heap_id[1 + self.off_size:1 + self.off_size + self.len_size],
            "little")
        self._load_root()
        W, S = self.table_width, self.start_size
        if off < W * S:
            row, bsize, rstart = 0, S, 0
            col = off // S
        else:
            row = (off // (W * S)).bit_length()  # floor(log2)+1
            rstart, bsize = self._row_geometry(row)
            col = (off - rstart) // bsize
        addrs = self._rows.get(row)
        if addrs is None or col >= len(addrs) or addrs[col] == UNDEF:
            raise ValueError("Fractal heap object block missing")
        within = off - (rstart + col * bsize)
        blob = self.f._pread(addrs[col] + within, length)
        return blob


# ===========================================================================
# Writer (subset: superblock v0, v1 object headers, v1 symbol-table groups,
# contiguous or chunked+deflate datasets, inline attributes)
# ===========================================================================

def _pad8(b: bytes) -> bytes:
    return b + b"\x00" * ((8 - len(b) % 8) % 8)


class _Buf:
    def __init__(self):
        self.data = bytearray()

    def tell(self) -> int:
        return len(self.data)

    def write(self, b: bytes) -> int:
        off = len(self.data)
        self.data += b
        return off

    def patch(self, off: int, b: bytes):
        self.data[off:off + len(b)] = b

    def align(self, n: int = 8):
        while len(self.data) % n:
            self.data += b"\x00"


def _dt_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype.kind == "S":
        # string class 3, null-terminated ascii
        return struct.pack("<BBBBI", 0x13, 0x00, 0, 0, dtype.itemsize)
    if dtype.kind in ("i", "u"):
        bits0 = 0x08 if dtype.kind == "i" else 0x00
        body = struct.pack("<BBBBI", 0x10, bits0, 0, 0, dtype.itemsize)
        body += struct.pack("<HH", 0, dtype.itemsize * 8)
        return body
    if dtype.kind == "f":
        if dtype.itemsize == 4:
            props = struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
            bits = (0x20, 0x1F, 0x00)
        else:
            props = struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
            bits = (0x20, 0x3F, 0x00)
        body = struct.pack("<BBBBI", 0x11, bits[0], bits[1], bits[2],
                           dtype.itemsize) + props
        return body
    raise ValueError(f"Unsupported dtype for writer: {dtype}")


def _ds_message(shape: Tuple[int, ...]) -> bytes:
    rank = len(shape)
    body = struct.pack("<BBBB4x", 1, rank, 0, 0)
    body += struct.pack(f"<{rank}Q", *shape)
    return body


def _attr_message(name: str, value) -> bytes:
    if isinstance(value, str):
        data = value.encode() + b"\x00"
        dtype = np.dtype(f"S{len(data)}")
        arr = None
        shape = ()
        raw = data
    elif (isinstance(value, (list, tuple))
          and value and all(isinstance(v, str) for v in value)):
        # list-of-strings attribute: fixed-size string array (the form
        # netcdf-c uses for dimension-name attrs)
        size = max(len(v.encode()) for v in value) + 1
        dtype = np.dtype(f"S{size}")
        shape = (len(value),)
        raw = b"".join(v.encode().ljust(size, b"\x00") for v in value)
        arr = None
    else:
        arr = np.asarray(value)
        if arr.dtype.kind == "U":
            data = str(value).encode() + b"\x00"
            dtype = np.dtype(f"S{len(data)}")
            shape = ()
            raw = data
        else:
            dtype = arr.dtype
            if dtype == np.dtype("int64"):
                arr = arr.astype(np.int64)
            shape = arr.shape
            raw = arr.tobytes()
    name_b = name.encode() + b"\x00"
    dt_b = _dt_message(dtype)
    ds_b = _ds_message(shape) if shape else struct.pack("<BBBB4x", 1, 0, 0, 0)
    body = struct.pack("<BxHHH", 1, len(name_b), len(dt_b), len(ds_b))
    body += _pad8(name_b) + _pad8(dt_b) + _pad8(ds_b) + raw
    return body


def _messages_block(msgs: List[Tuple[int, bytes]]) -> bytes:
    out = b""
    for mtype, body in msgs:
        body = _pad8(body)
        out += struct.pack("<HHB3x", mtype, len(body), 0) + body
    return out


def _object_header(msgs: List[Tuple[int, bytes]]) -> bytes:
    blk = _messages_block(msgs)
    return struct.pack("<BxHII4x", 1, len(msgs), 1, len(blk)) + blk


class HDF5Writer:
    """Writes an HDF5 file of the reader subset. Build the tree with
    ``create_group`` / ``create_dataset`` / ``set_attrs``, then ``save``."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.tree: Dict[str, Any] = {"__attrs__": {}, "__children__": {}}

    def _node(self, group_path: str) -> Dict[str, Any]:
        node = self.tree
        for part in [p for p in group_path.strip("/").split("/") if p]:
            node = node["__children__"].setdefault(
                part, {"__attrs__": {}, "__children__": {}})
        return node

    def create_group(self, path: str) -> None:
        self._node(path)

    def set_attrs(self, path: str, **attrs) -> None:
        self._node(path)["__attrs__"].update(attrs)

    def create_dataset(self, path: str, data: np.ndarray, *,
                       chunks: Optional[Tuple[int, ...]] = None,
                       compression: Optional[str] = None,
                       shuffle: bool = False,
                       attrs: Optional[Dict[str, Any]] = None) -> None:
        parts = path.strip("/").split("/")
        parent = self._node("/".join(parts[:-1]))
        parent["__children__"][parts[-1]] = {
            "__dataset__": np.ascontiguousarray(data),
            "__chunks__": chunks,
            "__compression__": compression,
            "__shuffle__": shuffle,
            "__attrs__": dict(attrs or {}),
        }

    # ---- serialisation ----

    def save(self) -> Path:
        buf = _Buf()
        # superblock v0 placeholder (96 bytes incl. root STE)
        sb_fields = struct.pack(
            "<8sBBBBBBBBHHI", MAGIC, 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0)
        sb_addrs = struct.pack("<QQQQ", 0, UNDEF, 0, UNDEF)  # eof patched
        buf.write(sb_fields + sb_addrs)
        root_ste_off = buf.tell()
        buf.write(b"\x00" * 40)

        root_addr = self._write_group(buf, self.tree)
        # root symbol table entry: name offset 0, header addr, no cache
        buf.patch(root_ste_off, struct.pack("<QQI4x16x", 0, root_addr, 0))
        # patch EOF address (offset of eof field: 8+16+16 = 40)
        buf.patch(40, struct.pack("<Q", len(buf.data)))
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_bytes(bytes(buf.data))
        return self.path

    def _write_group(self, buf: _Buf, node: Dict[str, Any]) -> int:
        # write children first
        entries: List[Tuple[str, int]] = []
        for name in sorted(node["__children__"]):
            child = node["__children__"][name]
            if "__dataset__" in child:
                addr = self._write_dataset(buf, child)
            else:
                addr = self._write_group(buf, child)
            entries.append((name, addr))

        # local heap with names
        heap_data = _Buf()
        heap_data.write(b"\x00" * 8)  # free-list head sentinel region
        name_offsets = {}
        for name, _ in entries:
            name_offsets[name] = heap_data.tell()
            heap_data.write(name.encode() + b"\x00")
            heap_data.align(8)
        heap_data.align(8)
        buf.align(8)
        heap_data_addr = buf.tell() + 32
        # free-list head 1 == H5HL_FREE_NULL (no free block); libhdf5
        # validates the offset against the heap size and rejects UNDEF
        heap_hdr = (b"HEAP" + struct.pack("<B3x", 0)
                    + struct.pack("<QQQ", len(heap_data.data), 1,
                                  heap_data_addr))
        buf.write(heap_hdr)
        buf.write(bytes(heap_data.data))

        # SNOD with all entries (sorted by name, as required)
        buf.align(8)
        snod_addr = buf.tell()
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(entries))
        for name, addr in entries:
            snod += struct.pack("<QQI4x16x", name_offsets[name], addr, 0)
        buf.write(snod)

        # B-tree v1 (single leaf), padded to the node size libhdf5
        # derives from the superblock's group internal K=16
        # (24 + (2K+1)*8 keys + 2K*8 children = 544 bytes) — a stock
        # reader loads the whole node, so short files fail its
        # addr-overflow check
        buf.align(8)
        btree_addr = buf.tell()
        bt = (b"TREE" + struct.pack("<BBH", 0, 0, 1)
              + struct.pack("<QQ", UNDEF, UNDEF))
        # key0, child0, key1
        key0 = 0
        key1 = name_offsets[entries[-1][0]] if entries else 0
        bt += struct.pack("<QQQ", key0, snod_addr, key1)
        bt += b"\x00" * (544 - len(bt))
        buf.write(bt)

        # group object header
        heap_hdr_addr = heap_data_addr - 32
        msgs: List[Tuple[int, bytes]] = []
        msgs.append((0x0011, struct.pack("<QQ", btree_addr,
                                         heap_hdr_addr)))
        for k, v in node["__attrs__"].items():
            msgs.append((0x000C, _attr_message(k, v)))
        buf.align(8)
        addr = buf.tell()
        buf.write(_object_header(msgs))
        return addr

    def _write_dataset(self, buf: _Buf, node: Dict[str, Any]) -> int:
        data: np.ndarray = node["__dataset__"]
        chunks = node["__chunks__"]
        compression = node["__compression__"]
        shuffle = node["__shuffle__"]
        msgs: List[Tuple[int, bytes]] = []
        msgs.append((0x0001, _ds_message(data.shape)))
        msgs.append((0x0003, _dt_message(data.dtype)))
        # fill value v2: undefined
        msgs.append((0x0005, struct.pack("<BBBBI", 1, 2, 2, 1, 0)))

        if chunks is None:
            buf.align(8)
            addr = buf.write(data.tobytes())
            layout = struct.pack("<BBQQ", 3, 1, addr, data.nbytes)
            msgs.append((0x0008, layout))
        else:
            chunks = tuple(int(c) for c in chunks)
            filters: List[Tuple[int, Tuple[int, ...]]] = []
            if shuffle:
                filters.append((2, (data.dtype.itemsize,)))
            if compression in ("gzip", "deflate", "zlib"):
                filters.append((1, (4,)))
            # write chunks + collect btree entries
            entries = []
            grid = [range(0, s, c) for s, c in zip(data.shape, chunks)]
            import itertools
            for offs in itertools.product(*grid):
                sl = tuple(slice(o, min(o + c, s))
                           for o, c, s in zip(offs, chunks, data.shape))
                chunk = np.zeros(chunks, dtype=data.dtype)
                chunk[tuple(slice(0, s.stop - s.start) for s in sl)] = data[sl]
                raw = chunk.tobytes()
                for fid, cd in filters:
                    if fid == 2:
                        elem = cd[0]
                        n = len(raw) // elem
                        raw = (np.frombuffer(raw, dtype=np.uint8)
                               .reshape(n, elem).T.tobytes())
                    elif fid == 1:
                        raw = zlib.compress(raw, cd[0])
                buf.align(8)
                addr = buf.write(raw)
                entries.append((offs, addr, len(raw)))
            # chunk B-tree (single leaf; fine for test-scale data)
            rank_plus1 = data.ndim + 1
            key_size = 8 + 8 * rank_plus1
            buf.align(8)
            btree_addr = buf.tell()
            bt = (b"TREE" + struct.pack("<BBH", 1, 0, len(entries))
                  + struct.pack("<QQ", UNDEF, UNDEF))
            for offs, addr, size in entries:
                bt += struct.pack("<II", size, 0)
                bt += struct.pack(f"<{rank_plus1}Q", *offs, 0)
                bt += struct.pack("<Q", addr)
            # final key: one past the last chunk — offsets must be
            # chunk multiples (libhdf5 rejects 'bad coordinate offset')
            limit = [-(-s // c) * c for s, c in zip(data.shape, chunks)]
            bt += struct.pack("<II", 0, 0)
            bt += struct.pack(f"<{rank_plus1}Q", *limit, 0)
            # pad to the stock node size (istore K=32 default for v0
            # superblocks): 24 + (2K+1)*key + 2K*child
            node_size = 24 + (2 * 32 + 1) * key_size + 2 * 32 * 8
            if len(bt) < node_size:
                bt += b"\x00" * (node_size - len(bt))
            buf.write(bt)
            layout = struct.pack("<BBB", 3, 2, rank_plus1)
            layout += struct.pack("<Q", btree_addr)
            layout += struct.pack(f"<{rank_plus1}I", *chunks,
                                  data.dtype.itemsize)
            msgs.append((0x0008, layout))
            if filters:
                fbody = struct.pack("<BB6x", 1, len(filters))
                for fid, cd in filters:
                    name = {1: b"deflate\x00", 2: b"shuffle\x00"}[fid]
                    fbody += struct.pack("<HHHH", fid, len(name), 1, len(cd))
                    fbody += _pad8(name)
                    fbody += struct.pack(f"<{len(cd)}I", *cd)
                    if len(cd) % 2 == 1:
                        fbody += b"\x00" * 4
                msgs.append((0x000B, fbody))

        for k, v in node["__attrs__"].items():
            msgs.append((0x000C, _attr_message(k, v)))
        buf.align(8)
        addr = buf.tell()
        buf.write(_object_header(msgs))
        return addr


def open_hdf5(path: Union[str, Path]) -> HDF5File:
    return HDF5File(path)

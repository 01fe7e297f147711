"""EMIT granule -> analysis-ready S2-anchored cube
(``hyperres/ortho/pipeline.py``, the ``nc_to_envi`` equivalent of
EMIT_data/emit_proj.py:563-1356).

Flow per product (DATA / LOC / OBS):

1. host: open the granule (the framework's HDF5 codec), GLT -> flat
   indices, the destination's source-index fields;
2. device: the DATA cube streams in band chunks (:mod:`..io.ingest`:
   read, optionally quantize to u16 / u12, pinned copy on a side stream,
   dequantize on the card), and each chunk is GLT-gathered and warped
   onto the S2-anchored UTM grid by the two-pass scanline warp
   (``kernels.warp.orthowarp_two_pass``, the scanline CUDA kernel) and
   written into its band slice of the UTM cube in place;
3. device: the u16 GeoTIFF products are quantized on the card (the
   quantize CUDA kernel, validity tested in the kernel) and only the
   u16 arrays come back;
4. host: ENVI + GeoTIFF + XML sidecar writes, with an ``info`` ledger
   recording every stage, timing and raster geometry.

The entry point runs on the card unless the caller passes
``device="cpu"``; there is no silent CPU path. Stage times synchronise
the device before they are taken.

Differences from the reference, all deliberate:

- ``warp_kernel="taploop"`` and ``fused_orthowarp=False`` (or a
  resampling other than cubic / bilinear) raise ``NotImplementedError``:
  ``orthowarp_taploop`` and ``resample_to_grid`` are not ported yet.
- ``warp_backend`` ``"auto"``, ``"xla"`` and ``"pallas_banded"`` take
  the banded kernel passes, ``"pallas"`` the dense route; the CUDA
  kernel has no 384-sample window, so there is no banded-feasibility
  fallback. ``info["out"]["warp_backend"]`` records the route taken
  (``"pallas_banded"`` or ``"pallas"``).
- The UTM cube is allocated at the granule's band count, so the tail
  chunk needs no padding bands and no slicing afterwards.
- The ledger gains a ``data_xml`` stage and, on the streamed fold's
  stage, ``read_seconds`` (host time in the granule reads, which the
  fold overlaps).
- Record-and-continue (the OBS product, ``convert_granules``) covers
  the file's own faults (``OSError``, ``ValueError``, ``KeyError``); a
  fault of a kernel or the device propagates.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import OrthoConfig
from ..core.constants import NO_DATA_VALUE
from ..core.grid import Grid, s2_anchored_target_grid
from ..device import resolve_device
from ..io import envi
from ..io.granule import EmitGranule, EmitMaskGranule
from ..io.ingest import dequant_slab, stream_cube_fold
from ..io.tiff import TiffReader
from ..io.xml_sidecar import write_xml_sidecar
from ..kernels.host import prepare_glt, scanline_cstar, source_index_field
from ..kernels.warp import orthowarp_two_pass
from . import products

# EMIT L1B OBS band names (the 11 geometry bands,
# reference: EMIT_data/emit_proj.py:29-115)
OBS_BAND_NAMES = [
    "Path length (sensor-to-ground in meters)",
    "To-sensor azimuth (0 to 360 degrees CW from N)",
    "To-sensor zenith (0 to 90 degrees from zenith)",
    "To-sun azimuth (0 to 360 degrees CW from N)",
    "To-sun zenith (0 to 90 degrees from zenith)",
    "Solar phase (degrees between to-sensor and to-sun vectors)",
    "Slope (local surface slope as derived from DEM in degrees)",
    "Aspect (local surface aspect 0 to 360 degrees clockwise from N)",
    "Cosine(i) (apparent local illumination factor)",
    "UTC Time (decimal hours for mid-line pixels)",
    "Earth-sun distance (AU)",
]

#: the faults of a granule file that the OBS branch and
#: ``convert_granules`` record and continue past
FILE_FAULTS = (OSError, ValueError, KeyError)


def raster_meta(grid: Grid, shape, dtype: str, nodata=None) -> Dict:
    """Compact raster geometry record (emit_proj.py:281-306 analogue)."""
    return {
        "crs": str(grid.crs),
        "transform": list(grid.geotransform),
        "width": grid.width,
        "height": grid.height,
        "bounds": list(grid.bounds),
        "shape": list(shape),
        "dtype": str(dtype),
        "nodata": nodata,
    }


@dataclass
class OrthoResult:
    data_envi_bin: Path
    utm_grid: Grid
    info: Dict = field(default_factory=dict)
    # device-resident UTM DATA cube (populated when keep_device_cube is
    # requested and the DATA product was computed this run) — lets the
    # fusion stage run without a disk/host round-trip
    device_cube: object = None
    wavelengths: Optional[np.ndarray] = None
    good_mask: Optional[np.ndarray] = None


def _grid_from_s2_tif(s2_tif_path: Union[str, Path]) -> Grid:
    with TiffReader(s2_tif_path) as r:
        if r.grid is None:
            raise ValueError(f"S2 template has no georeferencing: {s2_tif_path}")
        return r.grid


def _warp_chunk_update(utm: torch.Tensor, payload, b0: int, flat_idx,
                       valid, wr, wc, cstar, method: str, transfer: str,
                       backend: str) -> torch.Tensor:
    """Dequant + orthowarp one band chunk and write it into its band
    slice of the UTM cube, in place — the fold step of the streamed
    ingest (``pipeline.py:100``): each chunk's warp runs while the next
    chunk is read / quantized / shipped, and the full raw cube never
    sits on the card."""
    chunk = dequant_slab(payload, transfer, NO_DATA_VALUE)
    w = orthowarp_two_pass(chunk, flat_idx, valid, wr, wc, cstar,
                           method=method, fill=NO_DATA_VALUE,
                           backend=backend)
    utm[..., b0:b0 + w.shape[-1]] = w
    return utm


def _warp_chunk_update_bandmask(utm: torch.Tensor, payload, b0: int,
                                flat_idx, valid, wr, wc, cstar, method: str,
                                transfer: str, backend: str
                                ) -> torch.Tensor:
    """Band-masked fold step (``pipeline.py:128``): the dequantized
    chunk is [data * vb | vb] (2 nb channels, vb the per-band 0/1
    validity from the L2A band mask, ``b0`` in that doubled band space).
    Both halves ride the same warp, so dividing the warped premultiplied
    data by the warped validity renormalises each band's interpolation
    around its masked sources; ``den <= 1e-3`` (every contributing
    source masked, or cubic-lobe cancellation noise) is nodata."""
    chunk2 = dequant_slab(payload, transfer, NO_DATA_VALUE)
    nb = chunk2.shape[-1] // 2
    w = orthowarp_two_pass(chunk2, flat_idx, valid, wr, wc, cstar,
                           method=method, fill=NO_DATA_VALUE,
                           backend=backend)
    num = w[..., :nb]
    den = w[..., nb:]
    good = den > 1e-3
    band = torch.where(good, num / torch.where(good, den, 1.0),
                       NO_DATA_VALUE)
    utm[..., b0 // 2:b0 // 2 + nb] = band
    return utm


class _StageTimer:
    """Stage times into ``info["stages"]``; on a CUDA device it
    synchronises before it reads the clock, so a stage's seconds cover
    its device work."""

    def __init__(self, info: Dict, device: torch.device):
        self.info = info.setdefault("stages", {})
        self.device = device

    def record(self, name: str, t0: float, **extra):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec = {"seconds": round(time.perf_counter() - t0, 6)}
        rec.update(extra)
        self.info[name] = rec


def orthorectify_granule(
    img_file: Union[str, Path],
    out_dir: Union[str, Path],
    s2_grid: Union[Grid, str, Path],
    *,
    obs_file: Union[str, Path, None] = None,
    mask_file: Union[str, Path, None] = None,
    export_loc: bool = False,
    config: OrthoConfig = OrthoConfig(),
    tag: Optional[str] = None,
    save_info_path: Union[str, Path, None] = None,
    keep_device_cube: bool = False,
    device: Union[str, torch.device, None] = None,
) -> OrthoResult:
    """Full DATA (+ optional LOC / OBS) ortho export onto the S2-anchored
    UTM 60 m grid (``pipeline.py:178``). Returns the main projected ENVI
    path + info ledger.

    ``mask_file``: optional EMIT L2A mask granule. Its quality mask
    (``config.quality_bands`` flag bands, emit_tools.py:271-298) is
    folded into the GLT validity channel, so masked raw pixels are
    excluded from the warp's interpolation (nodata-aware gdalwarp
    semantics) and end up nodata in the DATA product. Set
    ``config.apply_band_mask`` to additionally apply the packed
    per-pixel-per-band mask (emit_tools.py:301-321) through the warp.

    ``device``: where the warp and the quantization run (default the
    card; ``"cpu"`` runs the kernels' plain versions)."""
    cfg = config
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not isinstance(s2_grid, Grid):
        s2_grid = _grid_from_s2_tif(s2_grid)

    img_path = Path(img_file)
    if tag is None:
        tag = img_path.stem.replace("EMIT_", "")

    data_utm = out_dir / f"{tag}.bin"
    data_hdr = data_utm.with_suffix(".hdr")
    loc_utm = out_dir / f"{tag}_LOC.bin"
    loc_hdr = loc_utm.with_suffix(".hdr")
    obs_utm = out_dir / f"{tag}_OBS.bin"
    obs_hdr = obs_utm.with_suffix(".hdr")

    export_loc = export_loc or cfg.export_loc
    need_data = cfg.overwrite or not (data_utm.exists() and data_hdr.exists())
    need_loc = export_loc and (cfg.overwrite
                               or not (loc_utm.exists() and loc_hdr.exists()))
    need_obs = (obs_file is not None) and (
        cfg.overwrite or not (obs_utm.exists() and obs_hdr.exists()))

    g = EmitGranule(img_path)
    description = ("Radiance micro-watts/cm^2/nm/sr"
                   if g.product == "L1B_RDN" else "Reflectance (unitless)")

    info: Dict = {
        "img_file": str(img_path),
        "obs_file": str(obs_file) if obs_file else None,
        "mask_file": str(mask_file) if mask_file else None,
        "tag": tag,
        "backend": "hyperres-hdf5",
        "product": g.product,
        "description": description,
        "time": {"start": g.time_coverage_start, "end": g.time_coverage_end},
        "out": {
            "out_crs": str(s2_grid.crs),
            "out_epsg": s2_grid.crs.epsg,
            "pixel_size_m": [cfg.target_res_m, cfg.target_res_m],
            "nodata": NO_DATA_VALUE,
            "resampling": cfg.resampling,
            # ingest traceability: the streamed u16/u12 transfer is a
            # (documented, sub-sensor-noise) lossy step versus f32, so
            # the product ledger records which path produced the cube
            "streaming_ingest": cfg.streaming_ingest,
            "ingest_transfer": (cfg.ingest_transfer
                                if cfg.streaming_ingest else "f32"),
        },
        "s2_align": {
            "s2_grid_extent": list(s2_grid.bounds),
            "s2_origin": [s2_grid.x0, s2_grid.y0],
            "s2_transform": list(s2_grid.geotransform),
            "emit_target_ps": [cfg.target_res_m, cfg.target_res_m],
            "emit_anchor_mode": "s2_origin",
        },
        "outputs": {},
        "rasters": {},
    }
    timer = _StageTimer(info, dev)

    if not (need_data or need_loc or need_obs):
        info["outputs"]["data_envi_bin"] = str(data_utm)
        info["outputs"]["data_envi_hdr"] = str(data_hdr)
        # register every product that already exists so resumed runs see
        # the same outputs record as the run that produced them
        # (the reference's skip path, emit_proj.py:816-872)
        geotiff_dir = out_dir / "geotiff"
        for key, path in {
            "data_utm_tif": geotiff_dir / f"{tag}_DATA_warp_utm.tif",
            "loc_utm_tif": geotiff_dir / f"{tag}_LOC_warp_utm.tif",
            "obs_utm_tif": geotiff_dir / f"{tag}_OBS_warp_utm.tif",
            "data_xml": data_utm.with_suffix(".xml"),
        }.items():
            if path.exists():
                info["outputs"][key] = str(path)
        if export_loc:
            info["outputs"]["loc_envi_bin"] = str(loc_utm)
        if obs_file is not None:
            info["outputs"]["obs_envi_bin"] = str(obs_utm)
        info["skipped"] = True
        _save_info(info, save_info_path)
        wavelengths = (np.asarray(g.wavelengths)
                       if g.wavelengths is not None else None)
        good_mask = g.good_wavelengths
        grid = s2_anchored_target_grid(g.ortho_grid, s2_grid,
                                       cfg.target_res_m, cfg.target_res_m)
        g.close()
        return OrthoResult(data_utm, grid, info,
                           wavelengths=wavelengths, good_mask=good_mask)

    if not (cfg.fused_orthowarp and cfg.resampling in ("cubic", "bilinear")):
        g.close()
        raise NotImplementedError(
            "the two-step gather + resample_to_grid path (fused_orthowarp="
            f"{cfg.fused_orthowarp}, resampling={cfg.resampling!r}; "
            "hyperres/kernels/warp.py:1094) is not ported")
    if cfg.warp_kernel != "two_pass":
        g.close()
        raise NotImplementedError(
            f"warp_kernel={cfg.warp_kernel!r}: orthowarp_taploop "
            "(hyperres/kernels/warp.py:708) is not ported")

    # --- GLT preparation (host) ---
    t0 = time.perf_counter()
    flat_idx, valid = prepare_glt(g.glt, (g.raw_height, g.raw_width))
    # diag counts straight from prepare_glt's masks
    n_nonzero = int(np.count_nonzero(np.all(g.glt != 0, axis=-1)))
    n_inbounds = int(np.count_nonzero(valid))
    info["glt_diag"] = {
        "raw_shape_yx": [g.raw_height, g.raw_width],
        "valid_glt_count": n_nonzero,
        "valid_glt_inbounds_count": n_inbounds,
        "valid_glt_dropped_oob": n_nonzero - n_inbounds,
    }
    flat_j = torch.from_numpy(flat_idx).to(dev)
    valid_j = torch.from_numpy(valid).to(dev)
    timer.record("glt_prep", t0)

    # --- target UTM grid (the _compute_te contract) ---
    utm_grid = s2_anchored_target_grid(g.ortho_grid, s2_grid,
                                       cfg.target_res_m, cfg.target_res_m)

    # geographic corner ring of the ortho grid (emit_proj.py:731-744)
    og = g.ortho_grid
    corners = [[og.x0, og.y0],
               [og.x0 + og.width * og.dx, og.y0],
               [og.x0 + og.width * og.dx, og.y0 - og.height * og.dy],
               [og.x0, og.y0 - og.height * og.dy]]

    wr_field, wc_field = source_index_field(g.ortho_grid, utm_grid)
    wr_j = torch.from_numpy(wr_field).to(dev)
    wc_j = torch.from_numpy(wc_field).to(dev)
    cstar_j = torch.from_numpy(
        scanline_cstar(wr_field, wc_field, g.ortho_grid.height)).to(dev)
    warp_backend = cfg.warp_backend
    info["out"]["warp_backend"] = ("pallas" if warp_backend == "pallas"
                                   else "pallas_banded")

    device_holder: Dict = {}

    def _export_product(cube_raw, kind: str, envi_path: Path,
                        hdr_extra: Dict, utm_precomputed=None,
                        valid_arg=None) -> Tuple[np.ndarray, torch.Tensor]:
        """gather + warp -> ENVI write; returns the UTM cube on the host
        and on the device. ``utm_precomputed`` skips straight to the
        write (the streamed fold already made the device cube);
        ``valid_arg`` overrides the GLT validity (quality-masked DATA)."""
        va = valid_arg if valid_arg is not None else valid_j
        if utm_precomputed is not None:
            utm_dev = utm_precomputed
        else:
            t = time.perf_counter()
            raw_t = torch.as_tensor(cube_raw, dtype=torch.float32).to(dev)
            utm_dev = orthowarp_two_pass(
                raw_t, flat_j, va, wr_j, wc_j, cstar_j,
                method=cfg.resampling, fill=NO_DATA_VALUE,
                backend=warp_backend)
            del raw_t
            timer.record(f"{kind}_two_pass_orthowarp", t,
                         shape=list(utm_dev.shape),
                         resampling=cfg.resampling)
        if keep_device_cube and kind == "data":
            device_holder["data"] = utm_dev
        utm = utm_dev.cpu().numpy()
        t = time.perf_counter()
        envi.write_cube(
            envi_path, utm, utm_grid,
            interleave="bil", nodata=NO_DATA_VALUE,
            extra_header=hdr_extra)
        timer.record(f"{kind}_envi_write", t)
        return utm, utm_dev

    geotiff_dir = out_dir / "geotiff"
    result_grid = utm_grid

    # ===== DATA =====
    if need_data:
        # L2A quality / band masks (emit_tools.py:271-321). The quality
        # mask (spatial, all bands) folds into the GLT validity channel:
        # masked raw pixels stop being valid warp sources. The
        # per-(pixel, band) band mask rides the warp as premultiplied
        # validity planes (see _warp_chunk_update_bandmask).
        data_valid_j = valid_j
        vb = None
        if mask_file is not None:
            t0 = time.perf_counter()
            with EmitMaskGranule(mask_file) as mg:
                qmask = mg.quality_mask(cfg.quality_bands).astype(bool)
                bmask = (mg.band_mask().astype(bool)
                         if cfg.apply_band_mask else None)
            if qmask.shape != (g.raw_height, g.raw_width):
                raise ValueError(
                    f"mask granule shape {qmask.shape} does not match "
                    f"raw cube ({g.raw_height}, {g.raw_width})")
            data_valid = valid & ~qmask.reshape(-1)[flat_idx]
            data_valid_j = torch.from_numpy(data_valid).to(dev)
            info["mask"] = {
                "quality_bands": list(cfg.quality_bands),
                "quality_masked_px": int(qmask.sum()),
                "ortho_cells_quality_masked":
                    int(valid.sum() - data_valid.sum()),
                "band_mask_applied": bmask is not None,
                "band_masked_px": 0,
            }
            if bmask is not None:
                if bmask.shape[-1] < g.n_bands:
                    raise ValueError(
                        f"band mask has {bmask.shape[-1]} bands for a "
                        f"{g.n_bands}-band cube")
                bmask = bmask[:, :, :g.n_bands]
                info["mask"]["band_masked_px"] = int(bmask.sum())
                vb = (~bmask).astype(np.float32)
            timer.record("mask_read", t0)

        read_seconds = [0.0]

        def read_bands(b0: int, b1: int) -> np.ndarray:
            t = time.perf_counter()
            slab = g.read_bands(b0, b1)
            read_seconds[0] += time.perf_counter() - t
            return slab

        raw = None
        utm_pre = None
        streaming = cfg.streaming_ingest and g.n_bands > cfg.band_chunk
        fold_args = (flat_j, data_valid_j, wr_j, wc_j, cstar_j,
                     cfg.resampling, cfg.ingest_transfer, warp_backend)
        if vb is not None or streaming:
            t0 = time.perf_counter()
            utm0 = torch.full((utm_grid.height, utm_grid.width, g.n_bands),
                              NO_DATA_VALUE, dtype=torch.float32,
                              device=dev)
            cb = cfg.band_chunk
            if vb is not None:
                # band-masked streamed fold: each chunk ships
                # [data * vb | vb] and the fold renormalises per band;
                # b0 runs in doubled band space (2 cb per chunk)
                n_chunks = -(-g.n_bands // cb)

                def read2(b0, b1):
                    a0 = (b0 // (2 * cb)) * cb
                    a1 = min(a0 + cb, g.n_bands)
                    slab = np.asarray(read_bands(a0, a1), dtype=np.float32)
                    v = vb[:, :, a0:a1]
                    return np.concatenate([slab * v, v], axis=-1)

                utm_pre = stream_cube_fold(
                    read2, (g.raw_height, g.raw_width, n_chunks * 2 * cb),
                    lambda utm, p, b0: _warp_chunk_update_bandmask(
                        utm, p, b0, *fold_args),
                    utm0, transfer=cfg.ingest_transfer, chunk_bands=2 * cb,
                    depth=cfg.ingest_depth, payload_mode=True, device=dev)
                stage = "data_bandmasked_streamed_orthowarp"
            else:
                # compute-overlapped ingest: each chunk's orthowarp runs
                # while the next chunk is read/quantized/shipped; the
                # full raw cube never sits on the card (peak = UTM cube
                # + one chunk). Replaces the reference's sequential
                # 32-band loop (emit_proj.py:969-987).
                utm_pre = stream_cube_fold(
                    read_bands, (g.raw_height, g.raw_width, g.n_bands),
                    lambda utm, p, b0: _warp_chunk_update(
                        utm, p, b0, *fold_args),
                    utm0, transfer=cfg.ingest_transfer, chunk_bands=cb,
                    depth=cfg.ingest_depth, payload_mode=True, device=dev)
                stage = "data_streamed_orthowarp"
            timer.record(stage, t0, transfer=cfg.ingest_transfer,
                         chunk_bands=cb, kernel="two_pass",
                         resampling=cfg.resampling,
                         shape=[utm_grid.height, utm_grid.width,
                                g.n_bands],
                         read_seconds=round(read_seconds[0], 6))
        else:
            raw = read_bands(0, g.n_bands)
        hdr_extra = {
            "description": description,
            "sensor type": "EMIT",
            "start acquisition time": g.time_coverage_start,
            "end acquisition time": g.time_coverage_end,
            "bounding box": [f"{c[0]:.8f} {c[1]:.8f}" for c in corners],
        }
        # wavelength-less granules (OBS/generic 3-D cubes run as the
        # main product) simply omit the spectral header entries
        if g.wavelengths is not None:
            hdr_extra["wavelength"] = [float(x) for x in g.wavelengths]
            hdr_extra["wavelength units"] = "nanometers"
        if g.fwhm is not None:
            hdr_extra["fwhm"] = [float(x) for x in g.fwhm]
        utm_cube, utm_dev = _export_product(
            raw, "data", data_utm, hdr_extra, utm_precomputed=utm_pre,
            valid_arg=data_valid_j)
        del raw, utm_pre
        info["outputs"]["data_envi_bin"] = str(data_utm)
        info["outputs"]["data_envi_hdr"] = str(data_hdr)
        info["rasters"]["data_envi"] = raster_meta(
            utm_grid, utm_cube.shape, "float32", NO_DATA_VALUE)

        if cfg.save_geotiffs:
            geotiff_dir.mkdir(parents=True, exist_ok=True)
            t = time.perf_counter()
            utm_tif = geotiff_dir / f"{tag}_DATA_warp_utm.tif"
            rec = products.export_reflectance_u16(
                utm_dev, utm_grid, utm_tif,
                scale_range=cfg.reflectance_scale)
            timer.record("data_utm_tif", t, **rec)
            info["outputs"]["data_utm_tif"] = str(utm_tif)
            info["rasters"]["data_utm_tif"] = raster_meta(
                utm_grid, utm_cube.shape, "uint16", 65535)
            # diagnostic single-band quicklook (emit_proj.py:989-1012)
            t = time.perf_counter()
            diag_dir = out_dir / "diag"
            diag_dir.mkdir(parents=True, exist_ok=True)
            diag_band = utm_cube.shape[-1] // 2
            diag_tif = diag_dir / (
                f"{tag}_DATA_diag_band{diag_band:03d}_warp_utm.tif")
            products.export_reflectance_u16(
                utm_dev[..., diag_band:diag_band + 1], utm_grid, diag_tif,
                scale_range=cfg.reflectance_scale)
            timer.record("data_diag_tif", t)
            info["outputs"]["data_diag_utm_tif"] = str(diag_tif)
        del utm_cube, utm_dev

        if cfg.write_xml:
            t = time.perf_counter()
            write_xml_sidecar(
                str(data_utm), product=g.product,
                epsg_str=f"EPSG:{s2_grid.crs.epsg}",
                crs_wkt=s2_grid.crs.to_wkt(),
                pixel_size=(cfg.target_res_m, cfg.target_res_m),
                shape=(utm_grid.height, utm_grid.width, g.n_bands),
                start_time_utc=g.time_coverage_start or "",
                end_time_utc=g.time_coverage_end or "",
                bbox_lonlat=corners,
                wavelengths=([float(x) for x in g.wavelengths]
                             if g.wavelengths is not None else None),
                fwhm=[float(x) for x in g.fwhm] if g.fwhm is not None else None,
                description=description)
            timer.record("data_xml", t)
            info["outputs"]["data_xml"] = str(data_utm.with_suffix(".xml"))

    # ===== LOC =====
    if need_loc:
        lon = g.location("lon")
        lat = g.location("lat")
        elev = g.location("elev")
        if lon is None or lat is None:
            info["loc_skipped_reason"] = "granule has no location lon/lat"
        else:
            loc_raw = np.stack(
                [lon, lat, elev if elev is not None else np.zeros_like(lon)],
                axis=-1).astype(np.float32)
            loc_cube, loc_dev = _export_product(loc_raw, "loc", loc_utm, {
                "description": "EMIT LOC (lon, lat, elev)",
                "band names": ["longitude", "latitude", "elevation"],
            })
            info["outputs"]["loc_envi_bin"] = str(loc_utm)
            info["rasters"]["loc_envi"] = raster_meta(
                utm_grid, loc_cube.shape, "float32", NO_DATA_VALUE)
            if cfg.save_geotiffs:
                geotiff_dir.mkdir(parents=True, exist_ok=True)
                loc_tif = geotiff_dir / f"{tag}_LOC_warp_utm.tif"
                rec = products.export_loc_u16(
                    loc_dev, utm_grid, loc_tif,
                    lon_range=cfg.lon_range, lat_range=cfg.lat_range,
                    elev_range=cfg.elev_range)
                info["outputs"]["loc_utm_tif"] = str(loc_tif)
                info["stages"]["loc_utm_tif"] = rec

    # ===== OBS =====
    if need_obs:
        try:
            with EmitGranule(obs_file) as obs_g:
                obs_raw = obs_g.read_cube()
                obs_names = obs_g.band_names
        except FILE_FAULTS as e:  # record-and-continue (emit_proj.py:1196-1201)
            info["obs_error"] = str(e)
        else:
            nb = obs_raw.shape[-1]
            # band names from the granule's observation_bands when
            # present (the real L1B_OBS metadata), canonical fallback
            names = (list(obs_names)[:nb] if obs_names
                     else OBS_BAND_NAMES[:nb])
            obs_cube, obs_dev = _export_product(obs_raw, "obs", obs_utm, {
                "description": "EMIT OBS geometry bands",
                "band names": names,
            })
            info["outputs"]["obs_envi_bin"] = str(obs_utm)
            info["rasters"]["obs_envi"] = raster_meta(
                utm_grid, obs_cube.shape, "float32", NO_DATA_VALUE)
            if cfg.save_geotiffs:
                geotiff_dir.mkdir(parents=True, exist_ok=True)
                obs_tif = geotiff_dir / f"{tag}_OBS_warp_utm.tif"
                rec = products.export_obs_u16(
                    obs_dev, utm_grid, obs_tif, band_names=names,
                    sample_stride=cfg.obs_sample_stride,
                    percentiles=cfg.obs_percentiles)
                info["outputs"]["obs_utm_tif"] = str(obs_tif)
                info["stages"]["obs_utm_tif"] = rec

    wavelengths = (np.asarray(g.wavelengths)
                   if g.wavelengths is not None else None)
    good_mask = g.good_wavelengths
    g.close()
    _save_info(info, save_info_path)
    return OrthoResult(data_utm, result_grid, info,
                       device_cube=device_holder.get("data"),
                       wavelengths=wavelengths, good_mask=good_mask)


def _save_info(info: Dict, save_info_path) -> None:
    if save_info_path is not None:
        p = Path(save_info_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(info, indent=2, default=str))
        info["saved_info_path"] = str(p)


def convert_granules(
    img_files,
    out_dir,
    s2_grid,
    *,
    obs_files=None,
    mask_files=None,
    config: OrthoConfig = OrthoConfig(),
    export_loc: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """Batch ortho conversion — the ``convert_emit_nc_to_envi`` wrapper
    (emit_proj.py:1303-1356, ``pipeline.py:722``): run every granule,
    record a granule file's fault (:data:`FILE_FAULTS`) and continue;
    return [(path_or_None, info_dict), ...]. A fault of a kernel or the
    device propagates."""
    results = []
    obs_files = obs_files or [None] * len(img_files)
    mask_files = mask_files or [None] * len(img_files)
    if len(obs_files) != len(img_files):
        raise ValueError(
            f"obs_files has {len(obs_files)} entries for "
            f"{len(img_files)} granules (pad with None for granules "
            "without an OBS file)")
    if len(mask_files) != len(img_files):
        raise ValueError(
            f"mask_files has {len(mask_files)} entries for "
            f"{len(img_files)} granules (pad with None)")
    for img, obs, msk in zip(img_files, obs_files, mask_files):
        try:
            res = orthorectify_granule(
                img, out_dir, s2_grid, obs_file=obs, mask_file=msk,
                export_loc=export_loc, config=config, device=device)
            results.append((res.data_envi_bin, res.info))
        except FILE_FAULTS as e:  # record-and-continue
            results.append((None, {"img_file": str(img), "error": str(e)}))
    return results

"""The card's inputs, shared by ``chip_smoke.py``'s kernel table and the
full-scale path checks: the granule's constants, and each input built
once a process (``functools.cache``), so that the table reuses what the
suite built when both run in one process: the bench scene and its plan
(``bench``), the full-width granule (``granule``) with its OBS and L2A
mask granules (``granule_products``) and its ortho runs (``ortho_run``,
``ortho_products_run``), and a small coregistration scene
(``coreg_scene``)."""

import atexit
import importlib
import shutil
import sys
import tempfile
from functools import cache
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

MAIN_SCALE = 1.0
#: the ortho export path: an EMIT granule at its real raw size, every band
ORTHO_RAW = (1242, 1280)
ORTHO_BANDS = 285
#: make_scene's S2 stack beside the granule, read by verify_granule:
#: VERIFY_S2_SIZE px of 10 m (96 km; the swath spans 91.6 x 89.9 km); the
#: ortho runs write onto a full S2 tile's grid (S2_TILE_PX of 10 m on the
#: stack's 60 m lattice) centred on the swath
VERIFY_S2_SIZE = 9600
S2_TILE_PX = 10980
#: make_scene's seed: verify_granule's fused gate compares two draws of OT
#: samples and reads 35.52, 41.38 and 45.67 dB on an H100 on seeds 0, 1, 2
#: (scripts/torch_verify_gate_spread.py); this one has the widest margin
VERIFY_SCENE_SEED = 2
#: the fold's chunks: ceil(285 / OrthoConfig().band_chunk)
ORTHO_CHUNKS = 9
#: the shift of the pairs check's S2 stack in 10 m px (rows, columns; two
#: and three 60 m px)
PAIRS_SHIFT = (12, -18)
S2_NODATA = 65535.0
#: kernel vs plain, max abs error: both evaluate the same <= 4 taps in
#: f32, in the same order; they differ only by FMA contraction in the
#: weights and the accumulation (a few ulp of values <= ~1)
KERNEL_TOL = 1e-5
#: Sinkhorn kernel vs plain at a fixed sweep count, both summing f32 exps
#: in orders of their own: max |dP| / max P, P = exp(Mr + f + g) (~10 ulp
#: of log P; 1.6e-6 on an H100)
SINKHORN_P_RTOL = 1e-5
#: the long-rows samples' seed: near convergence err falls ~10x per 10 sweeps
#: down to its rounding floor (~6e-7 at 128 x 100,000), so a check whose err
#: lies within that noise of stop_thr = 1e-6 can go either way in any two
#: versions of the arithmetic (seed 11: 0.99e-6 at sweep 50). With this seed
#: the plain version's err is 2.6e-6 at sweep 50 and 5.7e-7 at 60 (128 x
#: 100,000), 3.1e-6 at 40 and 4.8e-7 at 50 (1024 x 20,000), so the
#: equal-sweep-count check tests the kernels, not the coincidence.
SINKHORN_LONG_ROWS_SEED = 14
#: the SR product: a degree-3 ridge model from 10 S2 bands to 32 EMIT
#: bands over a 9140 x 9309 px 10 m granule (scripts/bench_sr_granule.py)
SR_BX, SR_BY, SR_DEGREE = 10, 32, 3
SR_SHAPE = (SR_BX, 9140, 9309)
SR_CHECK_HW = (1024, 1024)
SR_NODATA = -9999.0
#: SR kernel vs plain: the same f32 terms summed in another order move a
#: value on a rounding edge by one u16 step
SR_STEPS_TOL = 1
#: the streamed SR route: 12 bands at degree 4 (F = 1819, 2080 K columns)
SR_STREAM_BX, SR_STREAM_DEGREE = 12, 4
#: SRF kernel vs plain: the same f32 products summed in another order
SRF_TOL = 1e-5
#: export_reflectance_u16's hi for (0, 1) -> 0..10000
REFL_HI_EFF = 6.5535
#: the coregistration cell's resample: the EMIT band at 60 m onto the S2
#: grid at 10 m anchored on its corner, cubic, with the EMIT nodata value;
#: (rows, columns, m) and (rows, columns, m, offset in m)
EMIT_NODATA = -9999.0
RESAMPLE_SRC = (1523, 1550, 60.0)
RESAMPLE_DST = (9140, 9309, 10.0, (0.0, 0.0))


def resample_grids(src, dst):
    """Same-CRS UTM grids of ``src`` (rows, columns, m) and ``dst`` (rows,
    columns, m, (x, y) offset in m)."""
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid

    crs = CRS.utm(33, True)
    (hs, ws, ds), (hd, wd, dd, (ox, oy)) = src, dst
    x0, y0 = 450000.0, 5800000.0
    return (Grid(crs, x0, y0, ds, ds, ws, hs),
            Grid(crs, x0 + ox, y0 + oy, dd, dd, wd, hd))


def resample_source(rng, hs, ws, b, nodata, dev):
    """(hs, ws, b) seeded values in [0, 1); with a nodata value, nodata
    over two off-swath corners and 2 % scattered, and 0.1 % NaN."""
    x = rng.random((hs, ws, b), dtype=np.float32)
    if nodata is not None:
        r = np.arange(hs)[:, None] / hs
        c = np.arange(ws)[None, :] / ws
        x[(r + c < 0.3) | (r + c > 1.7)] = nodata
        x[rng.random(x.shape) < 0.02] = nodata
        x[rng.random(x.shape) < 0.001] = np.nan
    return torch.from_numpy(x).to(dev)


def counted(fn):
    """(fn()'s result, the launch counts of the call, synchronised)."""
    from hyperres_torch.device import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(launch_counts)


def script(name):
    """The module of ``scripts/<name>.py``, one of the port's programs."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    return importlib.import_module(name)


@cache
def bench(dev):
    """``bench_torch.build_workload`` at MAIN_SCALE (cached under
    ``.scenecache/``): scene, plan, raw cube and S2 on ``dev``."""
    import bench_torch

    scene = bench_torch.build_workload(MAIN_SCALE, scene_cache=True,
                                       device=dev)
    plan = scene.pop("plan")
    raw = torch.from_numpy(scene["raw"]).to(dev)
    return SimpleNamespace(scene=scene, plan=plan, raw=raw,
                           s2=plan.prepare_s2(scene["s2_dn"]))


@cache
def granule():
    """The full-width granule and its S2 stack (uncompressed) in a
    temporary directory removed at exit; the S2 tile's grid the ortho
    runs write onto."""
    from hyperres_torch.core.grid import Grid
    from hyperres_torch.testing.scenes import make_scene

    d = Path(tempfile.mkdtemp(prefix="granule"))
    atexit.register(shutil.rmtree, d, True)
    scene = make_scene(d / "scene", raw_shape=ORTHO_RAW, n_bands=ORTHO_BANDS,
                       compress_granule=False, s2_size=VERIFY_S2_SIZE,
                       seed=VERIFY_SCENE_SEED)
    s2, (cx, cy) = scene.s2_grid, scene.swath_center_utm
    half = S2_TILE_PX * 10.0 / 2.0
    tile = Grid(s2.crs, s2.x0 + 60.0 * round((cx - half - s2.x0) / 60.0),
                s2.y0 + 60.0 * round((cy + half - s2.y0) / 60.0), 10.0,
                10.0, S2_TILE_PX, S2_TILE_PX)
    return SimpleNamespace(scene=scene, tile=tile, dir=d)


@cache
def ortho_run(transfer):
    """``orthorectify_granule`` of the granule into ``ortho/`` with
    ``OrthoConfig(ingest_transfer=transfer)`` (the u16 run with LOC, the
    f32 run ``overwrite=True``), keeping its UTM cube on the card:
    (``res``, ``counts``, the u16 run's decoded DATA GeoTIFF ``data``)."""
    from hyperres_torch.core.config import OrthoConfig
    from hyperres_torch.io.tiff import TiffReader
    from hyperres_torch.ortho.pipeline import orthorectify_granule

    g = granule()
    cfg = OrthoConfig(ingest_transfer=transfer, overwrite=transfer == "f32")
    res, counts = counted(lambda: orthorectify_granule(
        g.scene.emit_nc_path, g.dir / "ortho", g.tile, config=cfg,
        export_loc=transfer == "u16", keep_device_cube=True))
    run = SimpleNamespace(res=res, counts=counts, data=None)
    if transfer == "u16":
        with TiffReader(res.info["outputs"]["data_utm_tif"]) as r:
            run.data = r.read()
    return run


@cache
def granule_products():
    """The granule's OBS and L2A mask granules, beside it: 11 smooth
    geometry bands, and the mask's 8 bands with cloud and cirrus blocks,
    two spacecraft scan lines and a water block (a flag the quality mask
    leaves out); no band mask. ``obs``, ``mask`` (paths), ``mask_bands``
    (raw_h, raw_w, 8) float32."""
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.io.hdf5 import HDF5Writer

    g = granule()
    h, w = ORTHO_RAW
    with EmitGranule(g.scene.emit_nc_path) as eg:
        glt, gt = eg.glt.astype(np.float64), np.array(eg.geotransform)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    obs = np.stack([10.0 * (i + 1) + 100.0 * xx + 50.0 * (i % 3) * yy
                    for i in range(11)], axis=-1).astype(np.float32)
    wgr = HDF5Writer(g.dir / "obs.nc")
    wgr.create_dataset("/obs", obs)
    wgr.create_group("/location")
    wgr.create_dataset("/location/glt_x", glt[..., 0])
    wgr.create_dataset("/location/glt_y", glt[..., 1])
    wgr.set_attrs("/", geotransform=gt)
    wgr.save()
    mask = np.zeros((h, w, 8), np.float32)
    mask[h // 4:h // 3, w // 6:w * 2 // 5, 0] = 1.0
    mask[h * 4 // 7:h * 3 // 5, w * 5 // 8:w * 3 // 4, 1] = 1.0
    mask[[h // 8, h * 5 // 7], :, 3] = 1.0
    mask[h // 25:h // 6, w // 2:w * 2 // 3, 2] = 1.0
    bands = ORTHO_BANDS + (-ORTHO_BANDS) % 8
    wgr = HDF5Writer(g.dir / "mask.nc")
    wgr.create_dataset("/mask", mask)
    wgr.create_dataset("/band_mask", np.packbits(
        np.zeros((h, w, bands), np.uint8), axis=-1))
    wgr.save()
    return SimpleNamespace(obs=g.dir / "obs.nc", mask=g.dir / "mask.nc",
                           mask_bands=mask)


@cache
def ortho_products_run():
    """``orthorectify_granule`` of the granule with f32 ingest (the
    streamed fold), LOC, its OBS and L2A mask granules into
    ``ortho_products/`` (removed after), keeping its UTM cube on the
    card: ``res``, the LOC and OBS ENVI cubes (``loc``, ``obs``) and the
    decoded GeoTIFFs (``tifs``: output key -> (H, W, bands) codes)."""
    from hyperres_torch.core.config import OrthoConfig
    from hyperres_torch.io import envi
    from hyperres_torch.io.tiff import TiffReader
    from hyperres_torch.ortho.pipeline import orthorectify_granule

    g, p = granule(), granule_products()
    out = g.dir / "ortho_products"
    res = orthorectify_granule(
        g.scene.emit_nc_path, out, g.tile, obs_file=p.obs, mask_file=p.mask,
        export_loc=True, config=OrthoConfig(ingest_transfer="f32"),
        keep_device_cube=True)
    run = SimpleNamespace(res=res, tifs={})
    for key in ("data_utm_tif", "data_diag_utm_tif", "loc_utm_tif",
                "obs_utm_tif"):
        with TiffReader(res.info["outputs"][key]) as r:
            run.tifs[key] = np.moveaxis(r.read(), 0, -1)
    for kind in ("loc", "obs"):
        hdr = Path(res.info["outputs"][f"{kind}_envi_bin"]).with_suffix(
            ".hdr")
        setattr(run, kind, envi.EnviReader(hdr).read())
    shutil.rmtree(out, ignore_errors=True)
    return run


def coreg_scene(dev, shift=(2.6, -3.3)):
    """An EMIT band at 60 m and a 3-band u16 S2 stack at 10 m on the same
    UTM extent: one world of 2000 plane waves (0.15-2 km), the stack
    showing it displaced by ``shift`` px (tgt(r, c) = world(r - dy,
    c - dx)), a nodata stripe over its first 20 rows. Each wave is a
    product of a row and a column term, so a grid's field is two matrix
    products."""
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid

    rng = np.random.default_rng(11)
    n = 2000
    k = 2 * np.pi / rng.uniform(150.0, 2000.0, n)
    th = rng.uniform(0, 2 * np.pi, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    ky, kx = k * np.sin(th), k * np.cos(th)

    def world(y, x):
        """The field at northings-from-top ``y`` (rows) x eastings ``x``
        (columns), metres."""
        ay = y[:, None] * ky + ph
        ax = x[:, None] * kx
        return (np.sin(ay) @ np.cos(ax).T + np.cos(ay) @ np.sin(ax).T) \
            / np.sqrt(n / 2.0)

    crs = CRS.utm(33, True)
    x0, y0 = 500_000.0, 5_000_000.0
    emit_grid = Grid(crs, x0, y0, 60.0, 60.0, 120, 110)
    s2_grid = Grid(crs, x0, y0, 10.0, 10.0, 660, 600)
    emit = world((np.arange(110) + 0.5) * 60.0,
                 (np.arange(120) + 0.5) * 60.0).astype(np.float32)
    dy, dx = shift
    sw = world((np.arange(600) - dy + 0.5) * 10.0,
               (np.arange(660) - dx + 0.5) * 10.0)
    stack = np.stack([np.clip(3000 + g * sw, 0, 65534)
                      for g in (600.0, 700.0, 800.0)]).astype(np.uint16)
    stack[:, :20] = int(S2_NODATA)
    return (torch.from_numpy(emit).to(dev), emit_grid,
            torch.from_numpy(stack).to(dev), s2_grid)

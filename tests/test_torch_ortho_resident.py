"""The port's resident ortho export core (``hyperres_torch.ortho.pipeline``
``OrthoGeometry`` and ``orthorectify_cube``) on the CPU, at a small size:

- against the benchmark's plain reference (``benchmark/reference/ortho.py``)
  on the ortho cell's granule (``benchmark/harness/ortho_scene.py``) over a
  96 x 100 raw swath of 24 bands with LOC, OBS and the L2A mask, each
  reading within the limit the cell's configuration writes for it
  (``benchmark/configs/emit_ortho_utm60.json``: the DATA cube to 1e-4 x
  min(1, |mass|), LOC and OBS to 1e-3 of each band's range, the OBS ranges
  to 1e-3 of theirs, the u16 codes within one step and the masks exact
  where the reference holds them sure);
- ``orthorectify_granule`` with ``ingest_transfer="f32"`` on a small
  granule file, through the streamed fold and through the whole raw cube,
  equal to the core's products bit for bit: the ENVI cubes and the
  decoded GeoTIFF codes;
- a quality-flagged raw pixel is no warp source;
- the spans and counters of one call."""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness.manifest import load_json  # noqa: E402
from benchmark.harness.ortho_scene import ortho_scene  # noqa: E402
from benchmark.reference import granule as gref  # noqa: E402
from benchmark.systems import ortho_export  # noqa: E402
from hyperres_torch.core.config import OrthoConfig  # noqa: E402
from hyperres_torch.io import envi  # noqa: E402
from hyperres_torch.io.granule import EmitGranule  # noqa: E402
from hyperres_torch.io.hdf5 import HDF5Writer  # noqa: E402
from hyperres_torch.io.tiff import TiffReader  # noqa: E402
from hyperres_torch.ortho import pipeline  # noqa: E402
from hyperres_torch.testing.scenes import make_scene  # noqa: E402
from hyperres_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
CONFIG = load_json(ROOT / "benchmark" / "configs" / "emit_ortho_utm60.json")
RAW = (96, 100, 24)
#: at 96 x 100 the UTM grid holds ~4 samples at the stride of 64
STRIDE = 8
STAGES = ("ortho.data", "ortho.loc", "ortho.obs", "ortho.u16")


def _cfg(**kw):
    o = dict(CONFIG["ortho"], obs_sample_stride=STRIDE)
    return ortho_export.ortho_config({"ortho": o}), dict(o, **kw)


@pytest.fixture(scope="module")
def cell():
    """The cell's granule at the CPU's size, its geometry and one core
    call's products."""
    sc = ortho_scene(*RAW, 2**33 + 9, CPU)
    geom = pipeline.OrthoGeometry.build(
        sc["glt"], RAW[:2], ortho_export._grid(sc["ortho_grid"]),
        ortho_export._grid(sc["utm60"]), "cpu")
    cfg, ortho = _cfg()
    qmask = pipeline.quality_flags(sc["mask"], cfg.quality_bands)
    out = pipeline.orthorectify_cube(geom, sc["raw"], loc=sc["loc"],
                                     obs=sc["obs"], quality_mask=qmask,
                                     config=cfg)
    return {"scene": sc, "geometry": geom, "config": cfg, "ortho": ortho,
            "qmask": qmask, "out": out}


def test_core_matches_the_plain_reference(cell):
    sc = cell["scene"]
    fields = gref.warp_fields(sc["glt"], RAW[:2], sc["ortho_grid"],
                              sc["utm60"])
    want = ortho_export.ref.export(sc["raw"], sc["loc"], sc["obs"],
                                   sc["mask"], fields, cell["ortho"])
    got = ortho_export.program_products(cell["out"])
    readings = ortho_export.compare(got, want, cell["ortho"])
    limits = CONFIG["correct"]["limits"]
    assert set(readings) == set(limits)
    for k, v in readings.items():
        assert v <= limits[k], (k, v)
    out = cell["out"]
    assert out.data.shape == (*sc["utm60"].shape, RAW[2])
    assert out.diag_band == RAW[2] // 2
    assert (out.diag_u16.shape, out.loc_u16.shape, out.obs_u16.shape) == (
        (*sc["utm60"].shape, 1), (*sc["utm60"].shape, 3),
        (*sc["utm60"].shape, 11))
    assert out.decode["data"] == {"scale": [0.0, 1.0, 0, 10000],
                                  "nodata_uint16": 65535}


def test_flagged_pixel_is_no_warp_source(cell):
    """A raw pixel set to 100 in every band changes nothing once the
    quality mask flags it (and its ortho cells leave the validity);
    unflagged, it does."""
    sc, geom, cfg = cell["scene"], cell["geometry"], cell["config"]
    flat, valid = geom.flat_idx, geom.valid
    r, c = RAW[0] // 2, RAW[1] // 2
    assert bool((valid & (flat == r * RAW[1] + c)).any())
    qmask = cell["qmask"]
    assert torch.equal(qmask, sc["mask"][..., [0, 1, 3]].sum(-1) > 0)
    assert not bool(qmask[r, c])
    flagged = qmask.clone()
    flagged[r, c] = True
    hot = sc["raw"].clone()
    hot[r, c] = 100.0

    def data(raw, mask):
        return pipeline.orthorectify_cube(geom, raw, quality_mask=mask,
                                          config=cfg, u16=False).data

    assert torch.equal(data(hot, flagged), data(sc["raw"], flagged))
    assert not torch.equal(data(hot, qmask), data(sc["raw"], qmask))
    assert torch.equal(data(sc["raw"], qmask), cell["out"].data)
    cells = valid & (flat == r * RAW[1] + c)
    assert not bool((geom.masked_valid(flagged) & cells).any())


def test_core_refuses_bad_inputs(cell):
    geom, cfg = cell["geometry"], cell["config"]
    raw = cell["scene"]["raw"]
    with pytest.raises(ValueError, match="not both"):
        pipeline.orthorectify_cube(geom, raw, data_utm=cell["out"].data)
    with pytest.raises(ValueError, match="does not match"):
        geom.masked_valid(torch.zeros(RAW[0] + 1, RAW[1], dtype=torch.bool))
    with pytest.raises(ValueError, match="data band"):
        pipeline.quality_flags(cell["scene"]["mask"], (0, 5))
    plain = pipeline.OrthoGeometry.build(
        cell["scene"]["glt"], RAW[:2], geom.ortho_grid, geom.utm_grid,
        "cpu", cstar=False)
    assert plain.cstar is None
    with pytest.raises(ValueError, match="cstar"):
        pipeline.orthorectify_cube(plain, raw, config=cfg)


@contextlib.contextmanager
def _spans(mode):
    profiling.clear()
    if mode == "profiler":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            yield
    else:
        with profiling.tracing():
            yield


@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_spans_nest_under_one_root(cell, mode):
    """One call: the root ``ortho`` and its four stages under one trace
    id, in order; the stages and the root's self time add up to the root;
    ``ortho.bands`` counts the bands warped and the CPU launches no
    quantize kernel."""
    from benchmark.harness import program_spans

    sc = cell["scene"]
    with _spans(mode):
        pipeline.orthorectify_cube(cell["geometry"], sc["raw"],
                                   loc=sc["loc"], obs=sc["obs"],
                                   quality_mask=cell["qmask"],
                                   config=cell["config"])
    call = profiling.records()
    profiling.clear()
    recs = {r.name: r for r in call}
    assert len(recs) == len(call) == 5
    root = recs["ortho"]
    assert root.parent_id is None and root.trace_id == root.span_id
    for name in STAGES:
        assert recs[name].parent_id == root.span_id
        assert recs[name].trace_id == root.span_id
    starts = [recs[n].start_s for n in STAGES]
    assert starts == sorted(starts)
    stages = sum(program_spans.stage_ms(call, n) for n in STAGES)
    own = program_spans.self_ms(call)
    assert 0.0 <= own < root.ms
    assert stages + own == pytest.approx(root.ms)
    bands = sum(r.counts.get(pipeline.BANDS_COUNTER, 0) for r in call)
    assert bands == RAW[2] + 3 + 11
    assert not any("quantize.kernel" in r.counts for r in call)


def test_spans_off_record_nothing(cell, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.clear()
    pipeline.orthorectify_cube(cell["geometry"], cell["scene"]["raw"],
                               config=cell["config"], u16=False)
    assert profiling.records() == []


# ------------------------------------------------------- the file path ---

@pytest.fixture(scope="module")
def granule(tmp_path_factory):
    """A 96 x 100 x 24 ``make_scene`` granule with an OBS granule (11
    smooth bands) and an L2A mask granule (cloud, cirrus, spacecraft
    lines; a water flag the quality mask leaves out)."""
    d = tmp_path_factory.mktemp("ortho_resident")
    sc = make_scene(d / "scene", raw_shape=RAW[:2], n_bands=RAW[2],
                    s2_size=480)
    h, w = RAW[:2]
    with EmitGranule(sc.emit_nc_path) as g:
        glt, gt = g.glt.astype(np.float64), np.array(g.geotransform)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    obs = np.stack([10.0 * (i + 1) + 100.0 * xx + 50.0 * (i % 3) * yy
                    for i in range(11)], axis=-1).astype(np.float32)
    wgr = HDF5Writer(d / "obs.nc")
    wgr.create_dataset("/obs", obs)
    wgr.create_group("/location")
    wgr.create_dataset("/location/glt_x", glt[..., 0])
    wgr.create_dataset("/location/glt_y", glt[..., 1])
    wgr.set_attrs("/", geotransform=gt)
    wgr.save()
    mask = np.zeros((h, w, 8), np.float32)
    mask[30:42, 20:45, 0] = 1.0
    mask[60:64, 50:70, 1] = 1.0
    mask[[15, 77], :, 3] = 1.0
    mask[5:25, 60:90, 2] = 1.0
    bm = np.packbits(np.zeros((h, w, RAW[2] + (-RAW[2]) % 8), np.uint8),
                     axis=-1)
    wgr = HDF5Writer(d / "mask.nc")
    wgr.create_dataset("/mask", mask)
    wgr.create_dataset("/band_mask", bm)
    wgr.save()
    return {"scene": sc, "obs": d / "obs.nc", "mask": d / "mask.nc",
            "mask_bands": mask, "dir": d}


def _tif(path):
    with TiffReader(path) as t:
        return np.moveaxis(t.read(), 0, -1)


@pytest.mark.parametrize("band_chunk", [8, 32])
def test_file_path_equals_the_core(granule, band_chunk):
    """``orthorectify_granule`` (f32 ingest; band_chunk 8: the streamed
    fold in 3 chunks, 32: the whole raw cube) writes the core's products
    bit for bit: the DATA, LOC and OBS ENVI cubes and the four GeoTIFFs'
    codes."""
    sc = granule["scene"]
    cfg = OrthoConfig(ingest_transfer="f32", band_chunk=band_chunk,
                      obs_sample_stride=STRIDE)
    out = granule["dir"] / f"out{band_chunk}"
    res = pipeline.orthorectify_granule(
        sc.emit_nc_path, out, sc.s2_tif_path, obs_file=granule["obs"],
        mask_file=granule["mask"], export_loc=True, config=cfg,
        keep_device_cube=True, device="cpu")
    streamed = [k for k in res.info["stages"] if "streamed" in k]
    assert streamed == (["data_streamed_orthowarp"] if band_chunk == 8
                        else [])
    with EmitGranule(sc.emit_nc_path) as g, \
            EmitGranule(granule["obs"]) as og:
        geom = pipeline.OrthoGeometry.build(
            g.glt, (g.raw_height, g.raw_width), g.ortho_grid, res.utm_grid,
            "cpu")
        raw = torch.from_numpy(g.read_cube())
        loc = torch.from_numpy(np.stack(
            [g.location("lon"), g.location("lat"), g.location("elev")],
            axis=-1).astype(np.float32))
        obs = torch.from_numpy(og.read_cube())
    qmask = pipeline.quality_flags(torch.from_numpy(granule["mask_bands"]),
                                   cfg.quality_bands)
    core = pipeline.orthorectify_cube(geom, raw, loc=loc, obs=obs,
                                      quality_mask=qmask, config=cfg)
    assert res.info["mask"]["ortho_cells_quality_masked"] == int(
        geom.valid.sum() - geom.masked_valid(qmask).sum()) > 0

    def cube(kind):
        hdr = out / f"{res.info['tag']}{kind}.hdr"
        return envi.EnviReader(hdr).read()

    assert torch.equal(res.device_cube, core.data)
    np.testing.assert_array_equal(cube(""), core.data.numpy())
    np.testing.assert_array_equal(cube("_LOC"), core.loc.numpy())
    np.testing.assert_array_equal(cube("_OBS"), core.obs.numpy())
    outs = res.info["outputs"]
    for key, codes in (("data_utm_tif", core.data_u16),
                       ("data_diag_utm_tif", core.diag_u16),
                       ("loc_utm_tif", core.loc_u16),
                       ("obs_utm_tif", core.obs_u16)):
        np.testing.assert_array_equal(_tif(outs[key]), codes.numpy(), key)
    dec = res.info["stages"]["obs_utm_tif"]["uint16_decode"]
    assert dec == core.decode["obs"]
    assert res.info["stages"]["loc_utm_tif"]["uint16_decode"] == \
        core.decode["loc"]

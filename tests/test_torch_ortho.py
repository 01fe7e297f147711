"""The port's ortho export path (``hyperres_torch.ortho.pipeline.
orthorectify_granule``) against the JAX package's on the CPU, end to
end, on the ``make_scene`` granule (raw 96 x 112 x 285): the ENVI DATA
cube, the decoded u16 DATA / LOC / OBS GeoTIFFs, the ``info`` ledger and
the XML sidecar, for the u16 / f32 / u12 transfers and a band-masked
run; the idempotent skip, the unported branches, and a kernel fault in
the OBS export. Each configuration runs once per package (module-scoped
fixtures). The port runs with ``device="cpu"`` (the kernels' plain
versions)."""

import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
from scipy.ndimage import binary_erosion

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres.core.config import OrthoConfig as JOrthoConfig  # noqa: E402
from hyperres.io.hdf5 import HDF5Writer  # noqa: E402
from hyperres.ortho import orthorectify_granule as j_ortho  # noqa: E402
from hyperres.testing.scenes import make_mask_granule, make_scene  # noqa: E402
from hyperres_torch.core.config import OrthoConfig  # noqa: E402
from hyperres_torch.io import envi  # noqa: E402
from hyperres_torch.io.granule import EmitGranule, EmitMaskGranule  # noqa: E402
from hyperres_torch.io.tiff import TiffReader  # noqa: E402
from hyperres_torch.kernels import quantize  # noqa: E402
from hyperres_torch.kernels.host import (  # noqa: E402
    prepare_glt, scanline_cstar, source_index_field,
)
from hyperres_torch.kernels.warp import orthowarp_two_pass  # noqa: E402
from hyperres_torch.ortho import convert_granules  # noqa: E402
from hyperres_torch.ortho import orthorectify_granule as t_ortho  # noqa: E402

#: the port's additions to the ledger (ortho/pipeline.py's docstring)
PORT_STAGES = {"data_xml"}
TIMING_KEYS = {"seconds", "read_seconds"}
#: run name -> (config fields, extra keyword arguments)
RUNS = {
    "default": ({}, {"export_loc": True}),
    # a 120 x 120 UTM grid holds 4 samples at the default stride of 64 (one
    # valid), where p1 == p99; at 8 the OBS ranges come from ~100 samples
    "obs": ({"obs_sample_stride": 8}, {"export_loc": True, "obs": True}),
    "f32": ({"ingest_transfer": "f32"}, {}),
    "u12": ({"ingest_transfer": "u12"}, {}),
    "bandmask": ({"apply_band_mask": True}, {"mask": True}),
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("orthoscene")
    sc = make_scene(d / "scene")
    rng = np.random.default_rng(0)
    h, w = sc.emit_raw_shape
    # an OBS granule with the real L1B_OBS layout, sharing the GLT
    with EmitGranule(sc.emit_nc_path) as g:
        glt, gt = g.glt.astype(np.float64), np.array(g.geotransform)
    names = [f"Geometry band {i}" for i in range(11)]
    # geometry-like bands: smooth ramps across the swath (a range of about
    # half the value, as the angles have) and a little noise
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    obs = np.stack([10.0 * (i + 1) + 100.0 * xx + 50.0 * (i % 3) * yy
                    + 0.01 * rng.normal(size=(h, w)) for i in range(11)],
                   axis=-1).astype(np.float32)
    wgr = HDF5Writer(d / "obs.nc")
    wgr.create_dataset("/obs", obs)
    wgr.create_group("/sensor_band_parameters")
    wgr.create_dataset("/sensor_band_parameters/observation_bands",
                       np.array([n.encode() for n in names], dtype="S32"))
    wgr.create_group("/location")
    wgr.create_dataset("/location/glt_x", glt[..., 0])
    wgr.create_dataset("/location/glt_y", glt[..., 1])
    wgr.set_attrs("/", geotransform=gt)
    wgr.save()
    cloud = np.zeros((h, w), bool)
    cloud[10:20, 30:50] = True
    bm = rng.random((h, w, 285)) < 0.15
    mask = make_mask_granule(d / "mask.nc", (h, w), cloud_mask=cloud,
                             band_mask=bm)
    return {"scene": sc, "obs": d / "obs.nc", "mask": mask, "dir": d}


def _run(fn, cfg_cls, scene, name, pkg, **kw):
    fields, extra = RUNS[name]
    out = scene["dir"] / f"{pkg}_{name}"
    res = fn(scene["scene"].emit_nc_path, out, scene["scene"].s2_tif_path,
             config=cfg_cls(**fields), export_loc=extra.get("export_loc",
                                                            False),
             obs_file=scene["obs"] if extra.get("obs") else None,
             mask_file=scene["mask"] if extra.get("mask") else None,
             save_info_path=out / "info.json", **kw)
    return res, out


@pytest.fixture(scope="module")
def runs(scene):
    """Each configuration once per package: name -> (jax, port), each
    (result, out_dir)."""
    return {name: (_run(j_ortho, JOrthoConfig, scene, name, "jax"),
                   _run(t_ortho, OrthoConfig, scene, name, "port",
                        device="cpu"))
            for name in RUNS}


def _norm(v, dirs):
    """A ledger with the run directories replaced by <OUT> and the
    timing fields dropped."""
    if isinstance(v, dict):
        return {k: _norm(x, dirs) for k, x in v.items()
                if k not in TIMING_KEYS}
    if isinstance(v, (list, tuple)):
        return [_norm(x, dirs) for x in v]
    if isinstance(v, str):
        for d in dirs:
            v = v.replace(str(d), "<OUT>")
        return v
    return v


def _assert_same(got, want, path="info"):
    """Equal structure and values; floats to 1e-6 relative (the OBS
    ranges are f32 percentiles that may differ by one ulp)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), path
    else:
        assert got == want, path


def _band_mass(scene, utm_grid):
    """The band-masked fold's denominator: the per-band validity planes
    warped with the quality-masked GLT validity (H, W, 285)."""
    with EmitGranule(scene["scene"].emit_nc_path) as g, \
            EmitMaskGranule(scene["mask"]) as mg:
        flat, valid = prepare_glt(g.glt, (g.raw_height, g.raw_width))
        valid &= ~mg.quality_mask((0, 1, 3)).astype(bool).reshape(-1)[flat]
        vb = (~mg.band_mask().astype(bool)).astype(np.float32)
        rows, cols = source_index_field(g.ortho_grid, utm_grid)
        cstar = scanline_cstar(rows, cols, g.ortho_grid.height)
    T = torch.from_numpy
    return orthowarp_two_pass(T(vb), T(flat), T(valid), T(rows), T(cols),
                              T(cstar)).numpy()


def _cube(res):
    return envi.EnviReader(res.data_envi_bin.with_suffix(".hdr")).read()


@pytest.mark.parametrize("name", list(RUNS))
def test_data_cube_matches(runs, scene, name):
    """The ENVI DATA cube: identical nodata masks; atol 1e-5 on the
    interior (2-px eroded valid area, and with the band mask a band
    validity mass >= 0.5), as test_torch_warp.py states for the two-pass
    warp against JAX; elsewhere 2e-4 of max(|v|, 1), where a small
    carried validity mass amplifies f32 rounding."""
    (jres, _), (tres, _) = runs[name]
    want, got = _cube(jres), _cube(tres)
    assert got.shape == want.shape == (*tres.utm_grid.shape, 285)
    fill = want == -9999.0
    np.testing.assert_array_equal(got == -9999.0, fill)
    assert fill.any() and not fill.all()
    interior = binary_erosion(~fill.all(-1), iterations=2)[..., None] & ~fill
    if name == "bandmask":
        # a band's interior also needs its own validity mass >= 0.5
        interior &= _band_mass(scene, tres.utm_grid) >= 0.5
    assert interior.sum() > 0.5 * (~fill).sum()
    np.testing.assert_allclose(got[interior], want[interior], rtol=0,
                               atol=1e-5)
    ok = ~fill
    err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
    assert err.max() <= 2e-4
    assert tres.utm_grid.geotransform == jres.utm_grid.geotransform


def _tif(res, key):
    with TiffReader(res.info["outputs"][key]) as t:
        return t.read(), t.nodata, t.dataset_tags, t.band_tags, \
            t.descriptions


@pytest.mark.parametrize("name,key", [(n, "data_utm_tif") for n in RUNS]
                         + [("default", "loc_utm_tif"),
                            ("obs", "loc_utm_tif"),
                            ("obs", "obs_utm_tif"),
                            ("default", "data_diag_utm_tif")])
def test_geotiffs_match(runs, name, key):
    """The decoded u16 GeoTIFFs within 1 step, identical sentinel
    masks, the same nodata, tags and descriptions (tag values to 1e-6
    relative)."""
    (jres, _), (tres, _) = runs[name]
    q, nod, tags, btags, desc = _tif(tres, key)
    jq, jnod, jtags, jbtags, jdesc = _tif(jres, key)
    assert q.dtype == jq.dtype == np.uint16 and q.shape == jq.shape
    assert nod == jnod and desc == jdesc and tags == jtags
    np.testing.assert_array_equal(q == nod, jq == jnod)
    assert np.abs(q.astype(np.int32) - jq.astype(np.int32)).max() <= 1
    assert len(btags) == len(jbtags)
    for a, b in zip(btags, jbtags):
        assert sorted(a) == sorted(b)
        for k in a:
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-6)


@pytest.mark.parametrize("name", list(RUNS))
def test_info_ledger_and_xml_match(runs, name):
    """The info ledger has the reference's keys plus the port's
    documented additions (the data_xml stage, read_seconds), and the
    same non-timing values except the warp backend's name; the saved
    JSON and the XML sidecar text match."""
    (jres, jout), (tres, tout) = runs[name]
    dirs = (jout, tout)
    got, want = _norm(tres.info, dirs), _norm(jres.info, dirs)
    assert PORT_STAGES <= set(got["stages"])
    stage = [k for k in tres.info["stages"] if "streamed" in k]
    assert len(stage) == 1
    assert tres.info["stages"][stage[0]]["read_seconds"] >= 0
    for k in PORT_STAGES:
        del got["stages"][k]
    assert want["out"].pop("warp_backend") == "auto"
    assert got["out"].pop("warp_backend") == "pallas_banded"
    _assert_same(got, want)
    assert (jout / "info.json").exists() and (tout / "info.json").exists()
    xml = tres.data_envi_bin.with_suffix(".xml").read_text()
    jxml = jres.data_envi_bin.with_suffix(".xml").read_text()
    assert xml == jxml


def test_idempotent_skip_and_device_cube(runs, scene):
    """A second run into a finished directory skips, with the
    reference's outputs record; keep_device_cube returns the DATA cube
    as a tensor equal to the ENVI file; the default device is the card
    (no silent CPU fallback)."""
    sc = scene["scene"]
    (jres, jout), (tres, tout) = runs["obs"]
    kw = dict(export_loc=True, obs_file=scene["obs"])
    t2 = t_ortho(sc.emit_nc_path, tout, sc.s2_tif_path, device="cpu", **kw)
    j2 = j_ortho(sc.emit_nc_path, jout, sc.s2_tif_path, **kw)
    assert t2.info["skipped"] is True and t2.device_cube is None
    _assert_same(_norm(t2.info, (jout, tout)), _norm(j2.info, (jout, tout)))
    assert t2.data_envi_bin == tres.data_envi_bin
    assert t2.utm_grid.geotransform == j2.utm_grid.geotransform
    kept = t_ortho(sc.emit_nc_path, scene["dir"] / "kept", sc.s2_tif_path,
                   config=OrthoConfig(ingest_transfer="f32",
                                      save_geotiffs=False, write_xml=False),
                   keep_device_cube=True, device="cpu")
    assert isinstance(kept.device_cube, torch.Tensor)
    np.testing.assert_array_equal(kept.device_cube.numpy(), _cube(kept))
    np.testing.assert_array_equal(_cube(kept), _cube(runs["f32"][1][0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ortho(sc.emit_nc_path, scene["dir"] / "nocard",
                    sc.s2_tif_path)


@pytest.mark.parametrize("fields,missing", [
    ({"warp_kernel": "taploop"}, "orthowarp_taploop"),
    ({"fused_orthowarp": False}, "resample_to_grid"),
    ({"resampling": "nearest"}, "resample_to_grid"),
])
def test_unported_branches_raise(scene, fields, missing, tmp_path):
    """The tap-loop warp and the two-step gather + resample_to_grid path
    are not ported: they raise, naming the module, and never fall back
    to the two-pass warp."""
    sc = scene["scene"]
    with pytest.raises(NotImplementedError, match=missing):
        t_ortho(sc.emit_nc_path, tmp_path, sc.s2_tif_path,
                config=OrthoConfig(**fields), device="cpu")
    assert not (tmp_path / "geotiff").exists()


def test_kernel_fault_in_obs_export_propagates(scene, monkeypatch,
                                                tmp_path):
    """A RuntimeError from the quantize kernel's wrapper inside
    export_obs_u16 makes orthorectify_granule raise (it is not recorded
    as obs_error); a fault of the OBS file itself is recorded and the
    run goes on; convert_granules records a missing granule and lets a
    kernel fault through."""
    sc = scene["scene"]
    orig = quantize.quantize_u16

    def faulty(x, *a, **k):
        if x.shape[-1] == 11:     # the OBS cube
            raise RuntimeError("quantize_u16 kernel launch failed: CUDA "
                               "error 700")
        return orig(x, *a, **k)

    cfg = OrthoConfig(ingest_transfer="f32", write_xml=False)
    monkeypatch.setattr(quantize, "quantize_u16", faulty)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t_ortho(sc.emit_nc_path, tmp_path / "a", sc.s2_tif_path,
                obs_file=scene["obs"], config=cfg, device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        convert_granules([sc.emit_nc_path], tmp_path / "b", sc.s2_tif_path,
                         obs_files=[scene["obs"]], config=cfg, device="cpu")
    monkeypatch.setattr(quantize, "quantize_u16", orig)
    res = t_ortho(sc.emit_nc_path, tmp_path / "c", sc.s2_tif_path,
                  obs_file=tmp_path / "missing_obs.nc",
                  config=replace(cfg, save_geotiffs=False), device="cpu")
    assert "obs_error" in res.info and "obs_envi_bin" not in res.info[
        "outputs"]
    out = convert_granules([tmp_path / "missing.nc", sc.emit_nc_path],
                           tmp_path / "d", sc.s2_tif_path,
                           config=replace(cfg, save_geotiffs=False),
                           device="cpu")
    assert out[0][0] is None and "error" in out[0][1]
    assert out[1][0] is not None and out[1][0].exists()

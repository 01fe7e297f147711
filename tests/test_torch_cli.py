"""The port's command-line interface (``python -m hyperres_torch``) on the
CPU: each of the ten subcommands with ``--device cpu`` on the scene
sizes of tests/test_cli.py (raw 36 x 40, 12 bands, S2 180 px), and
``--help`` listing the ten. The ``ortho`` product is held to the JAX
CLI's on that scene, the ``fuse`` product on a 48-band scene (at 12
bands neither package finds a valid 60 m pixel to fuse), with the
bounds of
tests/test_torch_ortho.py (the ENVI cube: the same fill, atol 1e-5 on
the 2-px eroded interior, elsewhere 2e-4 of max(|v|, 1)) and
tests/test_torch_pair_pipeline.py (the fused GeoTIFF of the default
fused engine: the same valid pixels, > 35 dB from the reference's, whose
OT samples come from another generator); ``srf`` imports the same
tables as the JAX CLI from one CSV sheet (array-equal).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.ndimage import binary_erosion

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hyperres.cli import main as jmain  # noqa: E402
from hyperres_torch.cli import main  # noqa: E402
from hyperres_torch.io import envi  # noqa: E402
from hyperres_torch.io.tiff import TiffReader  # noqa: E402
from hyperres_torch.pipeline import psnr  # noqa: E402
from hyperres_torch.spectral.srf_cache import load_srf_npz  # noqa: E402
from hyperres_torch.spectral.srf_tables import (  # noqa: E402
    S2_BANDS_13, builtin_srf,
)

COMMANDS = ["ortho", "fuse", "tiles", "coreg", "scene", "batch", "srf",
            "verify-granule", "info", "quicklook"]


def run(argv, capsys):
    """The port's CLI in this process on the CPU: (exit code, stdout)."""
    rc = main(["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cliscene")
    assert main(["scene", str(d), "--raw", "36", "40", "--bands", "12",
                 "--s2-size", "180"]) == 0
    return d


@pytest.fixture(scope="module")
def ortho_runs(scene_dir, tmp_path_factory):
    """``ortho`` by both CLIs on the scene."""
    out = tmp_path_factory.mktemp("torch_cli_ortho")
    nc = str(next(scene_dir.glob("*.nc")))
    s2 = str(scene_dir / "s2_stack_10m.tif")
    assert main(["ortho", nc, str(out / "t"), "--s2", s2,
                 "--device", "cpu"]) == 0
    assert jmain(["ortho", nc, str(out / "j"), "--s2", s2]) == 0
    return out


def test_help_lists_ten_subcommands():
    """``python -m hyperres_torch --help`` exits 0 and names the ten
    subcommands, and ``--device``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "hyperres_torch", "--help"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    listed = r.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert listed == COMMANDS
    assert "--device" in r.stdout


def test_device_option_before_or_after_the_subcommand():
    """``--device`` parses in either place; the default is None (the
    card)."""
    from hyperres_torch.cli import build_parser

    p = build_parser()
    assert p.parse_args(["info", "x.tif"]).device is None
    assert p.parse_args(["--device", "cpu", "info", "x.tif"]).device == "cpu"
    assert p.parse_args(["info", "x.tif", "--device", "cpu"]).device == "cpu"


def test_cli_scene_and_info(scene_dir, capsys):
    s2 = scene_dir / "s2_stack_10m.tif"
    assert s2.exists() and next(scene_dir.glob("*.nc")).exists()
    rc, out = run(["info", str(s2)], capsys)
    assert rc == 0 and "s2_stack_10m.tif: 180x180x10 uint16" in out


def test_cli_ortho_matches_jax_cli(ortho_runs):
    """The ENVI DATA cube of ``ortho`` against the JAX CLI's (bounds in
    the module docstring); both wrote ortho_info.json."""
    got = envi.EnviReader(next((ortho_runs / "t").glob("*.hdr"))).read()
    want = envi.EnviReader(next((ortho_runs / "j").glob("*.hdr"))).read()
    assert got.shape == want.shape and got.shape[-1] == 12
    fill = want == -9999.0
    np.testing.assert_array_equal(got == -9999.0, fill)
    interior = binary_erosion(~fill.all(-1), iterations=2)[..., None] & ~fill
    assert interior.sum() > 0.5 * (~fill).sum()
    np.testing.assert_allclose(got[interior], want[interior], rtol=0,
                               atol=1e-5)
    ok = ~fill
    err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
    assert err.max() <= 2e-4
    for d in ("t", "j"):
        assert (ortho_runs / d / "ortho_info.json").exists()


def test_cli_fuse_and_tiles(scene_dir, tmp_path, capsys):
    """``fuse`` with tests/test_cli.py's arguments: its JSON and report;
    then ``tiles`` on its overlap products. (At 12 bands the scene has
    no valid 60 m pixel for the fusion, in both packages; the product is
    held to the JAX CLI's on a 48-band scene below.)"""
    nc = str(next(scene_dir.glob("*.nc")))
    s2 = str(scene_dir / "s2_stack_10m.tif")
    rc, out = run(["fuse", nc, s2, str(tmp_path / "f"), "--tile-size", "10",
                   "--max-black-frac", "0.1", "--max-tiles", "2", "--no-sr"],
                  capsys)
    assert rc == 0
    doc = json.loads(out)
    assert doc["n_tiles"] >= 0 and (tmp_path / "f" / "report.md").exists()
    emit_tif = tmp_path / "f" / "emit" / "emit_overlap.tif"
    s2_tif = tmp_path / "f" / "s2" / "s2_overlap.tif"
    rc, out = run(["tiles", str(emit_tif), str(s2_tif), str(tmp_path / "t"),
                   "--tile-size", "8", "--max-black-frac", "0.2",
                   "--max-tiles", "3"], capsys)
    assert rc == 0
    doc = json.loads(out)
    assert doc["n_tiles"] >= 1
    assert all(Path(t["emit"]).exists() and Path(t["s2"]).exists()
               for t in doc["tiles"])


def test_cli_fuse_matches_jax_cli(tmp_path, capsys):
    """``fuse`` by both CLIs on tests/test_batch_parallel.py's scene size
    (raw 48 x 52, 48 bands, S2 360 px; tiles of 16, SR off): the fused
    GeoTIFF's valid pixels equal and > 35 dB from the JAX CLI's (bounds
    in the module docstring)."""
    from hyperres_torch.testing.scenes import make_scene

    sc = make_scene(tmp_path / "sc", raw_shape=(48, 52), n_bands=48,
                    s2_size=360)
    args = [str(sc.emit_nc_path), str(sc.s2_tif_path)]
    opts = ["--tile-size", "16", "--max-black-frac", "0.5", "--no-sr"]
    rc, out = run(["fuse", *args, str(tmp_path / "f"), *opts], capsys)
    assert rc == 0
    fused = Path(json.loads(out)["fused_tif"])
    assert jmain(["fuse", *args, str(tmp_path / "jf"), *opts]) == 0
    capsys.readouterr()
    with TiffReader(fused) as r:
        got = r.read().astype(np.float64)
        nod = r.nodata
    with TiffReader(tmp_path / "jf" / fused.relative_to(tmp_path / "f")) as r:
        want = r.read().astype(np.float64)
    ok = np.isfinite(got) & (got != nod)
    np.testing.assert_array_equal(ok, np.isfinite(want) & (want != nod))
    assert ok.mean() > 0.3
    assert psnr(got[ok], want[ok]) > 35.0


def test_cli_batch(scene_dir, tmp_path, capsys):
    """``batch`` over one job: summary one done, the manifest written,
    the attempt on ``cpu``."""
    nc = next(scene_dir.glob("*.nc"))
    jobs = [{"pair_id": "p1", "emit_nc_path": str(nc),
             "s2_stack_tif": str(scene_dir / "s2_stack_10m.tif")}]
    jobs_path = tmp_path / "jobs.json"
    jobs_path.write_text(json.dumps(jobs))
    rc, out = run(["batch", str(jobs_path), str(tmp_path / "batchout")],
                  capsys)
    assert rc == 0
    doc = json.loads(out)
    assert doc["summary"] == {"done": 1, "failed": 0, "pending": 0}
    man = json.loads(Path(doc["manifest"]).read_text())
    assert man["p1"]["attempts"][-1]["device"] == "cpu"


def test_cli_coreg(tmp_path, capsys):
    """``coreg`` end to end on tests/test_cli.py's shifted pair: the
    attempts ledger printed, exit code 0 on success (with the output
    GeoTIFF) and 1 otherwise."""
    import cv2
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid
    from hyperres_torch.io.hdf5 import HDF5Writer
    from hyperres_torch.io.tiff import write_geotiff

    rng = np.random.default_rng(3)
    h = w = 360
    f = rng.normal(size=(h // 10 + 2, w // 10 + 2))
    base = cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC).astype(
        np.float32)
    base = (base - base.min()) / (np.ptp(base) + 1e-6)
    utm = CRS.utm(33, True)
    s2_grid = Grid(utm, 500000.0, 5800000.0, 10.0, 10.0, w, h)
    M = np.float32([[1, 0, -2.0], [0, 1, 3.0]])
    shifted = cv2.warpAffine(base, M, (w, h), flags=cv2.INTER_CUBIC,
                             borderMode=cv2.BORDER_REFLECT)
    write_geotiff(tmp_path / "s2.tif",
                  (np.stack([shifted]) * 10000).astype(np.uint16),
                  s2_grid, nodata=0, descriptions=["B08_nir"])
    emit_grid = Grid(utm, 500000.0, 5800000.0, 60.0, 60.0, w // 6, h // 6)
    emit = base.reshape(h // 6, 6, w // 6, 6).mean(axis=(1, 3))
    write_geotiff(tmp_path / "emit.tif",
                  (emit[None] * 10000).astype(np.uint16), emit_grid,
                  nodata=65535)
    wgr = HDF5Writer(tmp_path / "emit.nc")
    wgr.create_dataset("/reflectance", np.zeros((4, 4, 1), np.float32))
    wgr.create_group("/sensor_band_parameters")
    wgr.create_dataset("/sensor_band_parameters/wavelengths",
                       np.array([842.0], dtype=np.float32),
                       attrs={"units": "nanometers"})
    wgr.create_group("/location")
    wgr.create_dataset("/location/glt_x", np.ones((4, 4)))
    wgr.create_dataset("/location/glt_y", np.ones((4, 4)))
    wgr.set_attrs("/", geotransform=np.array([0., 1., 0., 0., 0., -1.]))
    wgr.save()

    rc, out = run(["coreg", "--emit-ref", str(tmp_path / "emit.tif"),
                   "--s2", str(tmp_path / "s2.tif"),
                   "--nc", str(tmp_path / "emit.nc"),
                   "--out", str(tmp_path / "out.tif")], capsys)
    doc = json.loads(out)
    assert "attempts" in doc
    assert rc == (0 if doc["final"].get("success") else 1)
    if rc == 0:
        assert (tmp_path / "out.tif").exists()


def test_cli_srf_imports_the_jax_clis_tables(tmp_path, capsys):
    """``srf`` on a CSV sheet (the 13 S2A bands of the builtin SRF on a
    1 nm grid) into a directory: the same tables as the JAX CLI's
    import, array for array; no source and no --fetch is exit code 2."""
    srf = builtin_srf("S2A")
    wl = np.arange(400.0, 2401.0)
    cols = {b: np.interp(wl, *srf[b], left=0.0, right=0.0)
            for b in S2_BANDS_13}
    sheet = tmp_path / "sheet.csv"
    with open(sheet, "w") as f:
        f.write(",".join(["SR_WL"] + [f"S2A_SR_AV_{b}" for b in cols]) + "\n")
        for k, x in enumerate(wl):
            f.write(",".join([f"{x:g}"] + [f"{cols[b][k]:.8g}"
                                           for b in cols]) + "\n")
    rc, out = run(["srf", str(sheet), "--platforms", "S2A", "--dest",
                   str(tmp_path / "t")], capsys)
    assert rc == 0
    path = json.loads(out)["imported"]["S2A"]
    assert jmain(["srf", str(sheet), "--platforms", "S2A", "--dest",
                  str(tmp_path / "j")]) == 0
    jpath = json.loads(capsys.readouterr().out)["imported"]["S2A"]
    got, want = load_srf_npz(path), load_srf_npz(jpath)
    assert set(got) == set(want) == set(S2_BANDS_13)
    for b in got:
        for g, w in zip(got[b], want[b]):
            np.testing.assert_array_equal(g, w)
    rc, out = run(["srf"], capsys)
    assert rc == 2 and "error" in out


def test_cli_verify_granule(scene_dir, tmp_path, capsys):
    """``verify-granule`` on the scene: exit code 0 when ``passed`` and
    1 otherwise, its gates and report paths printed."""
    nc = str(next(scene_dir.glob("*.nc")))
    rc, out = run(["verify-granule", nc, str(scene_dir / "s2_stack_10m.tif"),
                   str(tmp_path / "v")], capsys)
    doc = json.loads(out)
    assert rc == (0 if doc["passed"] else 1)
    assert Path(doc["report"]).exists() and Path(doc["json"]).exists()
    assert doc["gates"]


def test_cli_quicklook(scene_dir, ortho_runs, tmp_path, capsys):
    """``quicklook`` from the granule (.nc), the ENVI product (.hdr) and
    the S2 GeoTIFF: each writes its HTML viewer and prints its path."""
    for src in (next(scene_dir.glob("*.nc")),
                next((ortho_runs / "t").glob("*.hdr")),
                scene_dir / "s2_stack_10m.tif"):
        out_html = tmp_path / f"{src.stem}.html"
        rc, out = run(["quicklook", str(src), str(out_html), "--max-size",
                       "32", "--max-bands", "8"], capsys)
        assert rc == 0 and out.strip() == str(out_html)
        assert "<canvas" in out_html.read_text()

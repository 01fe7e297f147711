"""The port's device rule: every entry point takes a ``device`` that
defaults to the current CUDA device and raises ``RuntimeError`` where
there is none; ``device="cpu"`` asks for the CPU. No entry point falls
back to the CPU by itself.

``torch.cuda.is_available`` is patched to False in the tests of the
raise, so they hold on a machine with a card too."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres_torch import device as tdevice  # noqa: E402
from hyperres_torch.core.config import (  # noqa: E402
    CoregConfig, OTConfig, RidgeSRConfig,
)
from hyperres_torch.entry import entry  # noqa: E402
from hyperres_torch.fusion import fused as tfused  # noqa: E402
from hyperres_torch.fusion import ot as tot  # noqa: E402
from hyperres_torch.fusion import ridge_sr as tridge  # noqa: E402
from hyperres_torch.io import ingest as tingest  # noqa: E402
from hyperres_torch.io import pipeline as tpipeline  # noqa: E402
from hyperres_torch import pipeline as tfuse  # noqa: E402
from hyperres_torch import verify as tverify  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.fusion.histogram import histogram_match_rgb  # noqa: E402
from hyperres_torch.fusion.linear import calibrate_linear  # noqa: E402
from hyperres_torch.io import envi as tenvi  # noqa: E402
from hyperres_torch.kernels import glt as tglt  # noqa: E402
from hyperres_torch.kernels import srf as tsrf  # noqa: E402
from hyperres_torch.kernels import warp as twarp  # noqa: E402
from hyperres_torch.ortho.pipeline import orthorectify_granule  # noqa: E402
from hyperres_torch.spectral import synth as tsynth  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402
from hyperres_torch.testing.bench_scene import generate_scene  # noqa: E402
from hyperres_torch.catalog import s2_stack as ts2  # noqa: E402
from hyperres_torch.coreg import granule as tcoreg  # noqa: E402
from hyperres_torch.coreg import local as tlocal  # noqa: E402
from hyperres_torch.kernels import phasecorr as tpc  # noqa: E402
from hyperres_torch.tiling import tiles as ttiles  # noqa: E402
from hyperres_torch.ortho import toolkit as ttoolkit  # noqa: E402

OT = OTConfig(n_samples=200, num_itermax=20)


@pytest.fixture(scope="module")
def scene():
    return generate_scene(0.05, 0)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _rgb_pair():
    rng = np.random.default_rng(11)
    src = rng.random((24, 20, 3)).astype(np.float32)
    ref = np.clip(0.8 * src + 0.1, 0, 1).astype(np.float32)
    return src, ref, rng.random((24, 20)) > 0.2


def _plan(scene, **kw):
    return tfused.FusedOrthoFusionPlan(
        scene["ortho_grid"], scene["utm60"], scene["s2_grid"],
        scene["raw"].shape[:2], scene["glt"], scene["wavelengths"],
        scene["good_mask"], s2_nodata=65535.0, s2_scale=1e-4,
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), **kw)


def _fusion_plan(scene, **kw):
    return tfused.FusedFusionPlan(
        scene["utm60"], scene["s2_grid"], scene["wavelengths"],
        scene["good_mask"], s2_nodata=65535.0, s2_scale=1e-4,
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), **kw)


def _load_params(tmp_path, **kw):
    path = tmp_path / "sr.npz"
    X = np.random.default_rng(2).random((300, 4)).astype(np.float32)
    Y = np.clip(0.3 + 0.4 * X[:, :3], 0.01, 0.99).astype(np.float32)
    tridge.save_params(path, tridge.RidgeSpectralSR(
        4, 3, RidgeSRConfig(degree=2), device="cpu").fit(X, Y))
    return tridge.load_params(path, **kw)


def _from_state(scene, **kw):
    plan = _plan(scene, device="cpu")
    return tfused.FusedOrthoFusionPlan.from_state(
        plan.state_dict_numpy(), plan.statics, **kw)


def _stream(**kw):
    cube = np.random.default_rng(3).random((6, 5, 7)).astype(np.float32)
    return tingest.stream_cube_to_device(
        lambda a, b: cube[..., a:b], cube.shape, chunk_bands=3, **kw)


def _prefetch(**kw):
    items = [np.arange(4, dtype=np.float32)]
    return list(tpipeline.PrefetchToDevice(iter(items), **kw))


def _fuse_pair(scene, **kw):
    """``fuse_pair`` on a 10 x 12 px 60 m grid (phase-wise: the fused
    plan resolves its device in its constructor, a case of its own)."""
    g60 = Grid(CRS.utm(33, True), 0.0, 0.0, 60.0, 60.0, 12, 10)
    g10 = Grid(CRS.utm(33, True), 0.0, 0.0, 10.0, 10.0, 72, 60)
    rng = np.random.default_rng(5)
    cube = rng.random((10, 12, 285)).astype(np.float32)
    s2 = rng.random((3, 60, 72)).astype(np.float32)
    return tfuse.fuse_pair(cube, scene["wavelengths"], g60, s2, g10,
                           fusion_method="linear", engine="phases",
                           synth_method="box", **kw).fused_10m


def _resample(**kw):
    g60 = Grid(CRS.utm(33, True), 0.0, 0.0, 60.0, 60.0, 12, 10)
    g10 = Grid(CRS.utm(33, True), 0.0, 0.0, 10.0, 10.0, 72, 60)
    data = np.random.default_rng(6).random((10, 12, 2)).astype(np.float32)
    return twarp.resample_to_grid(data, g60, g10, **kw)


def _pseudo_s2_from_envi(scene, tmp, **kw):
    g60 = Grid(CRS.utm(33, True), 0.0, 0.0, 60.0, 60.0, 6, 5)
    cube = np.random.default_rng(7).random((5, 6, 285)).astype(np.float32)
    tenvi.write_cube(tmp / "cube", cube, g60, interleave="bil",
                     extra_header={"wavelength": [
                         float(x) for x in scene["wavelengths"]]})
    return tsynth.pseudo_s2_from_envi(tmp / "cube.hdr", bands=["B2"],
                                      **kw)[0]["B2"]


def _windows():
    rng = np.random.default_rng(8)
    ref = rng.random((2, 32, 32)).astype(np.float32)
    return ref, np.roll(ref, (1, 2), axis=(1, 2))


def _coreg_local(**kw):
    ref, tgt = _windows()
    cfg = CoregConfig(window_size=(32, 32), grid_res=16,
                      min_reliability=0.0)
    return tlocal.coregister_local(ref[0], tgt[0], config=cfg, **kw)


def _deshift(**kw):
    res = tlocal.CoregResult(True, None, affine=np.array(
        [[0.0, 0.0, 0.5], [0.0, 0.0, -1.0]]))
    return tlocal.deshift(_windows()[0], res, **kw)


def _tiles(**kw):
    rng = np.random.default_rng(9)
    return ttiles.find_valid_paired_tiles(
        rng.random((3, 8, 8)), rng.random((2, 24, 24)), emit_tile_size=4,
        scale=3, **kw)


class _Granule:
    """A granule with an identity GLT (what ``merge_emit`` reads)."""

    def __init__(self, x0):
        self.n_bands = 3
        self.ortho_grid = Grid(CRS.geographic(), x0, 6.0, 1.0, 1.0, 7, 6)
        self.glt = np.stack(np.meshgrid(np.arange(1, 8), np.arange(1, 7)),
                            axis=-1).astype(np.int32)

    def read_cube(self):
        return np.random.default_rng(3).random((6, 7, 3)).astype(np.float32)


#: every entry point, called with the keyword arguments it is given
ENTRY_POINTS = {
    "resolve_device": lambda sc, tmp, **kw: tdevice.resolve_device(
        kw.get("device")),
    "RidgeSpectralSR": lambda sc, tmp, **kw: tridge.RidgeSpectralSR(
        10, 32, **kw),
    "entry": lambda sc, tmp, **kw: entry(**kw),
    "load_params": lambda sc, tmp, **kw: _load_params(tmp, **kw),
    "FusedOrthoFusionPlan": lambda sc, tmp, **kw: _plan(sc, **kw),
    "FusedOrthoFusionPlan.from_state": lambda sc, tmp, **kw: _from_state(
        sc, **kw),
    "FusedFusionPlan": lambda sc, tmp, **kw: _fusion_plan(sc, **kw),
    "fit_ot_affine": lambda sc, tmp, **kw: tot.fit_ot_affine(
        *_rgb_pair(), OT, **kw),
    "ot_match_rgb_sinkhorn": lambda sc, tmp, **kw: tot.ot_match_rgb_sinkhorn(
        *_rgb_pair(), n_samples=200, num_itermax=20, **kw),
    "fit_ot_poly": lambda sc, tmp, **kw: tot.fit_ot_poly(
        *_rgb_pair(), deg=2, cfg=OT, **kw),
    "apply_poly": lambda sc, tmp, **kw: tot.apply_poly(
        _rgb_pair()[0], np.array([[0.0, 1.0, 0.0]] * 3), **kw),
    "stream_cube_to_device": lambda sc, tmp, **kw: _stream(**kw),
    "PrefetchToDevice": lambda sc, tmp, **kw: _prefetch(**kw),
    "fuse_pair": lambda sc, tmp, **kw: _fuse_pair(sc, **kw),
    "fuse_pair(fused)": lambda sc, tmp, **kw: tfuse.fuse_pair(
        sc["raw"][:2, :2], sc["wavelengths"], sc["utm60"],
        sc["s2_dn"], sc["s2_grid"], engine="fused", **kw),
    "resample_to_grid": lambda sc, tmp, **kw: _resample(**kw),
    "reproject_stack_to_grid": lambda sc, tmp, **kw:
        tsynth.reproject_stack_to_grid(
            np.ones((1, 10, 12), np.float32),
            Grid(CRS.utm(33, True), 0.0, 0.0, 60.0, 60.0, 12, 10),
            Grid(CRS.utm(33, True), 0.0, 0.0, 10.0, 10.0, 72, 60), **kw),
    "histogram_match_rgb": lambda sc, tmp, **kw: histogram_match_rgb(
        *_rgb_pair(), **kw),
    "calibrate_linear": lambda sc, tmp, **kw: calibrate_linear(
        np.moveaxis(_rgb_pair()[0], -1, 0), np.moveaxis(_rgb_pair()[1], -1, 0),
        _rgb_pair()[2], **kw)[0],
    "pseudo_s2_from_envi": lambda sc, tmp, **kw: _pseudo_s2_from_envi(
        sc, tmp, **kw),
    "pseudo_s2_srf_integral": lambda sc, tmp, **kw:
        tsrf.pseudo_s2_srf_integral(
            sc["raw"][:3, :4], sc["wavelengths"],
            builtin_srf("S2A", bands=["B3"]), **kw)["B3"],
    "orthorectify": lambda sc, tmp, **kw: tglt.orthorectify(
        sc["raw"], sc["glt"], **kw),
    "verify_granule": lambda sc, tmp, **kw: tverify.verify_granule(
        tmp / "missing.nc", tmp / "missing.tif", tmp / "out", **kw),
    "phase_correlate_batch": lambda sc, tmp, **kw:
        tpc.phase_correlate_batch(*_windows(), **kw)[0],
    "estimate_shift": lambda sc, tmp, **kw: tpc.estimate_shift(
        *(w[0] for w in _windows()), **kw),
    "coregister_local": lambda sc, tmp, **kw: _coreg_local(**kw),
    "deshift": lambda sc, tmp, **kw: _deshift(**kw),
    "coregister_s2_to_emit": lambda sc, tmp, **kw:
        tcoreg.coregister_s2_to_emit(
            emit_ref_tif=tmp / "missing.tif", s2_tgt_tif=tmp / "m.tif",
            emit_nc_path=tmp / "missing.nc", out_s2_tif=tmp / "o.tif", **kw),
    "find_valid_paired_tiles": lambda sc, tmp, **kw: _tiles(**kw),
    "save_tile_pair": lambda sc, tmp, **kw: ttiles.save_tile_pair(
        tmp / "missing.tif", tmp / "m.tif", {"idx": 0}, tmp / "t", **kw),
    "build_s2_spectral_stack": lambda sc, tmp, **kw:
        ts2.build_s2_spectral_stack({}, tmp / "stack.tif", **kw),
    "run_pair_pipeline": lambda sc, tmp, **kw: tfuse.run_pair_pipeline(
        tmp / "missing.nc", tmp / "missing.tif", tmp / "out", **kw),
    "merge_emit": lambda sc, tmp, **kw: ttoolkit.merge_emit(
        [_Granule(0.0), _Granule(4.5)], **kw)[0],
}
#: entry points whose CPU run needs files this module does not make: the
#: raise without a card is checked here, the CPU run in its own test file
NEEDS_FILES = {"verify_granule": "tests/test_torch_verify.py",
               "fuse_pair(fused)": "tests/test_torch_fuse_pair.py",
               "coregister_s2_to_emit": "tests/test_torch_coreg.py",
               "save_tile_pair": "tests/test_torch_tiling.py",
               "build_s2_spectral_stack": "tests/test_torch_artifacts.py",
               "run_pair_pipeline": "tests/test_torch_pair_pipeline.py"}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(name, scene, tmp_path,
                                              no_card):
    """With no device given and no CUDA device, each entry point raises
    RuntimeError naming CUDA, instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](scene, tmp_path)


@pytest.mark.parametrize("name", sorted(set(ENTRY_POINTS)
                                        - set(NEEDS_FILES)))
def test_cpu_when_asked(name, scene, tmp_path):
    """The same calls with ``device="cpu"`` run, on the CPU."""
    out = ENTRY_POINTS[name](scene, tmp_path, device="cpu")
    assert out is not None
    dev = out if isinstance(out, torch.device) else getattr(out, "device",
                                                            None)
    if isinstance(dev, torch.device):
        assert dev == torch.device("cpu")


def test_orthorectify_granule_default_raises(tmp_path, no_card):
    """``orthorectify_granule`` resolves its device before it touches a
    file: with none given and no card, it raises."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        orthorectify_granule(tmp_path / "missing.nc", tmp_path / "out",
                             tmp_path / "missing.tif")


def test_resolve_device_default_is_the_current_card(monkeypatch):
    """``None`` resolves to the current CUDA device, with its index; an
    explicit device is kept as given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert tdevice.resolve_device(None) == torch.device("cuda", 3)
    assert tdevice.resolve_device("cuda") == torch.device("cuda")
    assert tdevice.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")

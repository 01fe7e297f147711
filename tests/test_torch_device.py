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
from hyperres_torch.core.config import OTConfig, RidgeSRConfig  # noqa: E402
from hyperres_torch.entry import entry  # noqa: E402
from hyperres_torch.fusion import fused as tfused  # noqa: E402
from hyperres_torch.fusion import ot as tot  # noqa: E402
from hyperres_torch.fusion import ridge_sr as tridge  # noqa: E402
from hyperres_torch.io import ingest as tingest  # noqa: E402
from hyperres_torch.io import pipeline as tpipeline  # noqa: E402
from hyperres_torch.ortho.pipeline import orthorectify_granule  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402
from hyperres_torch.testing.bench_scene import generate_scene  # noqa: E402

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
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(name, scene, tmp_path,
                                              no_card):
    """With no device given and no CUDA device, each entry point raises
    RuntimeError naming CUDA, instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](scene, tmp_path)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
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

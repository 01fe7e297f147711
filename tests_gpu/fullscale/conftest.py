"""Session fixtures of the full-scale path checks, each made once and
shared (the first three by ``card_inputs``, once a process, so that the
kernel table reuses them): the bench scene at scale 1.0 and its plan
(``bench``) with one call's output (``base``), and the full-width granule
(``granule``: ``make_scene``'s 1242 x 1280 x 285 with its 9600 px S2
stack, in a temporary directory), its two ortho runs (``ortho``) and the
shifted S2 stack made from them (``shifted_s2``). Every case runs a main
path of the port at its real size on the card and skips without one:

    python -m pytest tests_gpu/fullscale -q
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import card_inputs
from card_inputs import PAIRS_SHIFT, counted


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def workdir(tmp_path):
    """A temporary directory, removed after the case (its products run
    to gigabytes)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="session")
def bench(card):
    """The bench scene at scale 1.0 and its plan (``card_inputs.bench``)."""
    return card_inputs.bench(card)


@pytest.fixture(scope="session")
def base(bench):
    """The default plan's output of one call and its launch counts."""
    return counted(lambda: bench.plan(bench.raw, bench.s2,
                                      generator=bench.plan.generator(0)))


@pytest.fixture(scope="session")
def granule(card):
    """The full-width granule (``card_inputs.granule``)."""
    return card_inputs.granule()


@pytest.fixture(scope="session")
def ortho(granule):
    """``card_inputs.ortho_run`` with u16 ingest (plus LOC), then with f32
    ingest into the same directory: transfer -> (``res``, ``counts``, the
    u16 run's decoded DATA GeoTIFF ``data``); products removed."""
    runs = {t: card_inputs.ortho_run(t) for t in ("u16", "f32")}
    shutil.rmtree(granule.dir / "ortho", ignore_errors=True)
    return runs


@pytest.fixture(scope="session")
def shifted_s2(card, granule, ortho) -> Path:
    """The pairs check's S2 stack, made as tests/test_coreg.py:280 makes
    the reference's: the f32 ortho run's UTM cube SRF-synthesized to the
    granule's S2 stack's 10 bands at 60 m and bilinearly upsampled to its
    10 m grid (descriptions, nodata 65535), 0 outside the swath, its fill
    and cubic overshoot (values past [0, 1]) left out; rolled by
    PAIRS_SHIFT (tgt(r, c) = src(r - dy, c - dx)), nodata on the
    rolled-in edges; u16 x 1e4, uncompressed. ``make_scene``'s own stack
    is smooth at the matching windows' 5 km (no tie point passes
    CoregConfig()'s reliability gate); nodata outside the swath would
    make the deshift write codes near 65534 there, which the SR fit
    would take for valid inputs."""
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.io.tiff import TiffReader, write_geotiff
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.kernels.warp import resample_tensor_to_grid
    from hyperres_torch.spectral.srf_tables import builtin_srf
    from hyperres_torch.testing.scenes import S2_CODE_TO_SHORT

    run = ortho["f32"].res
    cube = run.device_cube
    with TiffReader(granule.scene.s2_tif_path) as r:
        grid, descs = r.grid, r.descriptions
    with EmitGranule(granule.scene.emit_nc_path) as g:
        wl, good = np.asarray(g.wavelengths), g.good_wavelengths
    shorts = [S2_CODE_TO_SHORT[str(d).split("_")[0]] for d in descs]
    W, _, _ = build_srf_weight_matrix(wl, builtin_srf("S2A"), good,
                                      bands=shorts)
    synth = cube @ torch.from_numpy(W).to(card)
    bad = ((cube[..., 0] == NO_DATA_VALUE) | (synth < 0.0).any(dim=-1)
           | (synth > 1.0).any(dim=-1))
    synth[bad] = NO_DATA_VALUE
    x = resample_tensor_to_grid(synth, run.utm_grid, grid, method="bilinear",
                                nodata=NO_DATA_VALUE, fill=0.0)
    del synth
    dy, dx = PAIRS_SHIFT
    x = torch.roll(x, shifts=(dy, dx), dims=(0, 1))
    if dy:
        x[slice(None, dy) if dy > 0 else slice(dy, None)] = float("nan")
    if dx:
        x[:, slice(None, dx) if dx > 0 else slice(dx, None)] = float("nan")
    q = torch.clamp(torch.round(x * 10000.0), 0.0, 65534.0)
    q = torch.where(torch.isfinite(x), q.to(torch.int32), 65535)
    data = q.to(torch.uint16).permute(2, 0, 1).contiguous().cpu().numpy()
    del x, q
    out = granule.dir / "s2_shifted.tif"
    write_geotiff(out, data, grid, nodata=65535, descriptions=descs,
                  compress=None)
    return out

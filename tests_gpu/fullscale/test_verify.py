"""``verify_granule`` (``hyperres_torch.verify``) on the full-width
granule and its 9600 px S2 stack, on the default device: the shipped
route (two-pass warp, fused engine) beside the exact one (tap-loop warp,
phase-wise engine), at the default gates. The fused gate compares two
draws of 5000 OT samples (the card's generator, NumPy's) and spreads
across 40 dB over scene seeds (``VERIFY_SCENE_SEED``)."""

import warnings

import pytest

from card_inputs import ORTHO_CHUNKS, counted
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES

pytestmark = pytest.mark.gpu


def test_verify_granule_passes(granule, workdir):
    """``passed`` is true at the default gates, the JSON and the report
    are written, and each fused ortho warp pass launched once per chunk
    of the shipped ortho run (the exact run and both fusions launch
    none)."""
    from hyperres_torch.verify import verify_granule

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*PARAMETRIC.*")
        res, counts = counted(lambda: verify_granule(
            granule.scene.emit_nc_path, granule.scene.s2_tif_path,
            workdir / "verify"))
    assert res.json_path.exists() and res.report_path.exists()
    assert res.passed, res.metrics["gates"]
    assert all(counts.get(k) == ORTHO_CHUNKS for k in KERNEL_NAMES.values()
               ), counts

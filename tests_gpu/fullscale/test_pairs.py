"""``run_pair_pipeline`` on the default device on the full-width granule
and ``shifted_s2`` (PAIRS_SHIFT px of 10 m), ``coregister=True``,
``predict_sr_cube=True``, the default configs and
``max_tiles=PAIRS_MAX_TILES`` (the one cut: host deflate)."""

import numpy as np
import pytest

from card_inputs import ORTHO_CHUNKS, PAIRS_SHIFT, counted
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES
from hyperres_torch.kernels.deshift_warp import KERNEL_NAME as DESHIFT
from hyperres_torch.kernels.quantize import KERNEL_NAME as QUANT
from hyperres_torch.kernels.sr_predict import KERNEL_NAME as SR

pytestmark = pytest.mark.gpu

#: the bound on the recovered shift (tests/test_pipeline_e2e.py:99: the
#: EMIT reference carries the GLT's nearest-neighbour quantization, +-0.5
#: raw px), the tiles written and the checks of the products
PAIRS_SHIFT_TOL = 1.5
PAIRS_MAX_TILES = 32
PAIRS_R2_MIN = 0.8
PAIRS_FINITE_MIN = 0.3
PAIRS_SECTIONS = ("Orthorectification", "Coregistration",
                  "Fusion (OT + poly)", "Tiles", "Spectral SR (ridge)",
                  "Spectral SR 10 m product", "Timing")


def test_run_pair_pipeline(granule, shifted_s2, workdir):
    """The coregistration succeeds within PAIRS_SHIFT_TOL px of the shift;
    the fused product is finite on > PAIRS_FINITE_MIN of its pixels with
    values in [0, 1]; tiles are written with a record each and the
    manifest; the SR fit's ``r2_mean`` > PAIRS_R2_MIN;
    ``emit_sr_10m.tif`` decodes with one u16 band per SR band on the fused
    product's grid; ``report.md`` has every section; each fused ortho warp
    pass launched at least once per chunk, quantize at least once, the
    SR kernel and the deshift kernel exactly once."""
    from hyperres_torch.core.config import (
        CoregConfig, OrthoConfig, PolyFusionConfig, RidgeSRConfig,
        TilingConfig,
    )
    from hyperres_torch.core.grid import Window
    from hyperres_torch.io.tiff import TiffReader
    from hyperres_torch.pipeline import run_pair_pipeline

    res, counts = counted(lambda: run_pair_pipeline(
        granule.scene.emit_nc_path, shifted_s2, workdir / "pairs",
        ortho_config=OrthoConfig(), fusion_config=PolyFusionConfig(),
        tiling_config=TilingConfig(), sr_config=RidgeSRConfig(),
        coreg_config=CoregConfig(), coregister=True,
        max_tiles=PAIRS_MAX_TILES, train_sr=True, predict_sr_cube=True))
    final = res.info["coreg"]["final"]
    assert final.get("success"), res.info["coreg"]
    assert max(abs(a - b) for a, b in zip(final["mean_shift_px"],
                                          PAIRS_SHIFT)) < PAIRS_SHIFT_TOL
    fused = res.fusion.fused_10m
    ok = np.isfinite(fused).all(axis=-1)
    vals = fused[ok]
    assert ok.mean() > PAIRS_FINITE_MIN
    assert vals.min() >= 0.0 and vals.max() <= 1.0
    assert res.tiles and len(res.tile_records) == len(res.tiles)
    assert res.run.local_manifest_csv.exists()
    m = res.sr_metrics
    assert m["r2_mean"] > PAIRS_R2_MIN, m["r2_mean"]
    with TiffReader(m["sr_cube_tif"]) as r:
        corner = r.read(window=Window(0, 0, min(512, r.width),
                                      min(512, r.height)))
        shape = (r.count, r.height, r.width)
    assert shape == (len(m["band_indices"]),) + fused.shape[:2]
    assert corner.dtype == np.uint16
    text = res.report_path.read_text()
    assert all(f"## {h}\n" in text for h in PAIRS_SECTIONS)
    assert all(counts.get(k, 0) >= ORTHO_CHUNKS for k in KERNEL_NAMES.values()
               ), counts
    assert counts.get(QUANT, 0) >= 1, counts
    assert counts.get(SR) == 1 and counts.get(DESHIFT) == 1, counts

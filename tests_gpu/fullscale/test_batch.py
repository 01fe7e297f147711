"""``BatchPairDriver.run(jobs, devices=[card] * BATCH_WORKERS)`` on three
``make_scene`` pairs cut to BATCH_RAW x 285 bands (S2 BATCH_S2 px), each
job a ``run_pair_pipeline`` (test_pairs.py's, cut), tiles BATCH_TILE px."""

import time

import pytest

from card_inputs import ORTHO_BANDS, counted
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES

pytestmark = pytest.mark.gpu

BATCH_RAW = (192, 200)
BATCH_S2 = 1200
BATCH_WORKERS = 2
BATCH_TILE = 32


def test_batch_driver(card, workdir):
    """Every pair ``done`` on the card, two pipelines overlapping in wall
    clock, each fused ortho warp pass launched for every pair; a second
    run runs nothing (resume); with a fourth job whose granule is
    missing, that one ``failed`` after two recorded attempts and the
    rest ``done``."""
    from hyperres_torch.batch import BatchPairDriver, PairJob
    from hyperres_torch.core.config import TilingConfig
    from hyperres_torch.testing.scenes import make_scene

    scenes = [make_scene(workdir / f"scene{i}", raw_shape=BATCH_RAW,
                         n_bands=ORTHO_BANDS, s2_size=BATCH_S2, seed=i,
                         compress_granule=False) for i in range(3)]
    jobs = [PairJob(f"pair{i}", str(s.emit_nc_path), str(s.s2_tif_path))
            for i, s in enumerate(scenes)]
    driver = BatchPairDriver(workdir / "out", tiling_config=TilingConfig(
        emit_tile_size=BATCH_TILE, max_black_frac=0.5))
    base, spans = driver.runner, {}

    def tracking(job, pair_dir):
        t = time.perf_counter()
        out = base(job, pair_dir)
        spans[job.pair_id] = (t, time.perf_counter())
        return out

    driver.runner = tracking
    devices = [card] * BATCH_WORKERS
    manifest, counts = counted(lambda: driver.run(jobs, devices=devices))
    ids = sorted(spans)
    overlap = max([min(spans[a][1], spans[b][1]) - max(spans[a][0],
                                                       spans[b][0])
                   for i, a in enumerate(ids) for b in ids[i + 1:]],
                  default=0.0)
    assert {v["status"] for v in manifest.values()} == {"done"}, manifest
    assert overlap > 0.0
    assert {a["device"] for v in manifest.values()
            for a in v["attempts"]} == {str(card)}
    assert all(counts.get(k, 0) >= len(jobs) for k in KERNEL_NAMES.values()
               ), counts
    calls = []
    driver.runner = lambda job, d: calls.append(job.pair_id) or {}
    driver.run(jobs, devices=devices)
    assert not calls
    missing = PairJob("missing", str(workdir / "nope.nc"),
                      str(scenes[0].s2_tif_path))
    driver.runner = base
    manifest = driver.run(jobs + [missing], devices=devices)
    assert {k: v["status"] for k, v in manifest.items()} == {
        "pair0": "done", "pair1": "done", "pair2": "done",
        "missing": "failed"}
    assert [a["attempt"] for a in manifest["missing"]["attempts"]] == [1, 2]

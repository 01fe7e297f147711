"""The port's batch pair driver (``hyperres_torch.batch``) on the CPU:
the sequential path and the threaded path (``devices=["cpu"] * 3``, three
worker threads) on three small ``make_scene`` pairs, as
tests/test_batch_parallel.py runs the JAX driver on three virtual
devices; resume and retries; record-and-continue held to the JAX
driver (the manifest's statuses and attempt keys on the same jobs and
the same runner); and the worker death the reference leaves silent: an
exception outside a pair's attempts makes ``run`` raise, and the pairs
never run stay ``pending``. A ``torch.AcceleratorError`` (a CUDA error
that loses the context) is not retried: the batch stops with the pair
``pending`` and its attempt recorded, and a resumed run completes it;
``torch.OutOfMemoryError`` and a refused launch are recorded and retried.

No tolerances: the checks are statuses, keys, counts and wall-clock
overlap.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

from hyperres.batch import BatchPairDriver as JDriver  # noqa: E402
from hyperres.batch import PairJob as JJob  # noqa: E402
from hyperres_torch.batch import BatchPairDriver, PairJob  # noqa: E402
from hyperres_torch.core.config import TilingConfig  # noqa: E402
from hyperres_torch.device import launch_error  # noqa: E402
from hyperres_torch.testing.scenes import make_scene  # noqa: E402

TILING = TilingConfig(emit_tile_size=16, max_black_frac=0.5)


@pytest.fixture(scope="module")
def pair_scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_batch_scenes")
    return [make_scene(root / f"pair{i}", raw_shape=(48, 52), n_bands=48,
                       s2_size=360, seed=i) for i in range(3)]


def _jobs(scenes, cls=PairJob):
    return [cls(pair_id=f"pair{i}", emit_nc_path=str(s.emit_nc_path),
                s2_stack_tif=str(s.s2_tif_path))
            for i, s in enumerate(scenes)]


def test_batch_runs_pairs_concurrently_on_cpu_devices(pair_scenes,
                                                      tmp_path):
    """Three worker threads (devices ``["cpu"] * 3``) with the default
    runner and a fourth job whose granule is missing: the three pairs
    ``done`` with their device recorded, at least two pipelines overlap
    in wall clock, the missing one ``failed`` after 1 + max_retries
    recorded attempts; a second run (a runner that succeeds) reruns only
    the failed pair: the ``done`` pairs' records are unchanged."""
    spans = {}
    driver = BatchPairDriver(tmp_path / "out", sr_config=None,
                             tiling_config=TILING)
    base_runner = driver.runner

    def tracking_runner(job, pair_dir):
        t0 = time.monotonic()
        out = base_runner(job, pair_dir)
        spans[job.pair_id] = (t0, time.monotonic())
        return out

    driver.runner = tracking_runner
    jobs = _jobs(pair_scenes) + [PairJob(
        "missing", str(tmp_path / "nope.nc"), str(pair_scenes[0].s2_tif_path))]
    manifest = driver.run(jobs, devices=["cpu"] * 3)
    assert set(manifest) == {"pair0", "pair1", "pair2", "missing"}
    for pid in ("pair0", "pair1", "pair2"):
        rec = manifest[pid]
        assert rec["status"] == "done"
        assert rec["attempts"][-1]["success"]
        assert rec["attempts"][-1]["device"] == "cpu"
        assert np.isfinite(rec["outputs"]["total_seconds"])
    miss = manifest["missing"]
    assert miss["status"] == "failed"
    assert [a["attempt"] for a in miss["attempts"]] == [1, 2]
    assert all(not a["success"] and a["error"] for a in miss["attempts"])
    assert driver.summary() == {"done": 3, "failed": 1, "pending": 0}
    ids = sorted(spans)
    assert any(spans[a][0] < spans[b][1] and spans[b][0] < spans[a][1]
               for i, a in enumerate(ids) for b in ids[i + 1:]), spans

    before = {k: len(v["attempts"]) for k, v in manifest.items()}
    calls = []
    driver.runner = lambda job, d: calls.append(job.pair_id) or {}
    after = {k: len(v["attempts"])
             for k, v in driver.run(jobs, devices=["cpu"] * 3).items()}
    assert calls == ["missing"]
    assert {k: after[k] - before[k] for k in after} == {
        "pair0": 0, "pair1": 0, "pair2": 0, "missing": 1}


def test_batch_sequential_and_resume_from_disk(pair_scenes, tmp_path):
    """The sequential path (one device entry) with the default runner on
    one pair: ``done`` on ``cpu``; a new driver on the same directory
    loads the manifest and runs nothing."""
    jobs = _jobs(pair_scenes[:1])
    driver = BatchPairDriver(tmp_path / "seq", sr_config=None,
                             tiling_config=TILING)
    manifest = driver.run(jobs, devices=["cpu"])
    assert manifest["pair0"]["status"] == "done"
    assert manifest["pair0"]["attempts"][-1]["device"] == "cpu"
    again = BatchPairDriver(tmp_path / "seq", sr_config=None,
                            runner=lambda job, d: pytest.fail("ran again"))
    assert again.run(jobs)["pair0"]["status"] == "done"


def _flaky_runner():
    """Fails the first attempt of ``flaky``, every attempt of a job whose
    granule does not exist, and succeeds otherwise."""
    seen = {}
    lock = threading.Lock()

    def runner(job, pair_dir):
        with lock:
            seen[job.pair_id] = seen.get(job.pair_id, 0) + 1
            n = seen[job.pair_id]
        if not Path(job.emit_nc_path).exists():
            raise FileNotFoundError(job.emit_nc_path)
        if job.pair_id == "flaky" and n == 1:
            raise RuntimeError("transient")
        return {"pair": job.pair_id}
    return runner


@pytest.mark.parametrize("threaded", [False, True])
def test_record_and_continue_matches_jax(pair_scenes, tmp_path, threaded):
    """Retries and record-and-continue on four jobs (one flaky, one
    missing, two fine) with the same runner in both drivers, sequential
    and threaded over three devices: the statuses, the attempt numbers,
    successes and keys of every record equal the JAX driver's."""
    nc = str(pair_scenes[0].emit_nc_path)
    s2 = str(pair_scenes[0].s2_tif_path)
    spec = [("ok0", nc), ("flaky", nc), ("missing", str(tmp_path / "x.nc")),
            ("ok1", nc)]
    t = BatchPairDriver(tmp_path / "t", runner=_flaky_runner())
    j = JDriver(tmp_path / "j", runner=_flaky_runner())
    tm = t.run([PairJob(p, n, s2) for p, n in spec],
               devices=["cpu"] * 3 if threaded else None)
    jm = j.run([JJob(p, n, s2) for p, n in spec],
               devices=jax.devices()[:3] if threaded else None)
    assert set(tm) == set(jm)
    for pid in tm:
        assert tm[pid]["status"] == jm[pid]["status"]
        assert set(tm[pid]) == set(jm[pid])
        assert ([(a["attempt"], a["success"], sorted(a))
                 for a in tm[pid]["attempts"]]
                == [(a["attempt"], a["success"], sorted(a))
                    for a in jm[pid]["attempts"]])
    assert tm["flaky"]["status"] == "done"
    assert tm["missing"]["status"] == "failed"
    assert t.summary() == j.summary() == {"done": 3, "failed": 1,
                                          "pending": 0}


def test_worker_failure_is_raised_and_unrun_pairs_stay_pending(tmp_path):
    """A manifest write that raises inside a worker (outside a pair's
    attempts): ``run`` re-raises it after the workers stop, no worker
    takes another pair, so of six jobs on three workers at most three
    ran and the rest stay ``pending``. (The JAX driver's worker dies
    silently and its ``run`` returns.)"""
    ran = []

    def runner(job, pair_dir):
        ran.append(job.pair_id)
        return {}

    driver = BatchPairDriver(tmp_path / "w", runner=runner)

    def broken_save():
        raise OSError("disk full")

    driver._save_manifest = broken_save
    jobs = [PairJob(f"p{i}", "a.nc", "b.tif") for i in range(6)]
    with pytest.raises(OSError, match="disk full"):
        driver.run(jobs, devices=["cpu"] * 3)
    assert 1 <= len(ran) <= 3
    status = {k: v["status"] for k, v in driver.manifest.items()}
    assert set(status) == {f"p{i}" for i in range(6)}
    assert sum(s == "pending" for s in status.values()) == 6 - len(ran)
    assert all(status[p] == "done" for p in ran)


def _statuses(path):
    """{pair_id: (status, [success of each attempt])} of the manifest on
    disk."""
    m = BatchPairDriver(path).manifest
    return {k: (v["status"], [a["success"] for a in v["attempts"]])
            for k, v in m.items()}


@pytest.mark.parametrize("threaded", [False, True])
def test_cuda_fault_stops_the_batch(tmp_path, threaded):
    """A runner that raises ``torch.AcceleratorError`` on the second job
    (sequential: three jobs; threaded: six on ``["cpu"] * 3``, the other
    pairs slow enough that the fault lands while they run): ``run``
    re-raises it after one call for that pair. The manifest on disk has
    that pair ``pending`` with one failed attempt (error, traceback and
    device recorded), every pair that ran ``done`` and every other one
    ``pending`` with no attempt; sequentially exactly pair 1 ran before
    it, threaded at most the two other workers' first pairs did. A new
    driver on the same directory with a good runner completes the rest
    and reruns no ``done`` pair."""
    n = 6 if threaded else 3
    jobs = [PairJob(f"p{i}", "a.nc", "b.tif") for i in range(n)]
    calls = []

    def faulty(job, pair_dir):
        calls.append(job.pair_id)
        if job.pair_id == "p1":
            raise torch.AcceleratorError(
                "CUDA error: an illegal memory access was encountered")
        time.sleep(0.3 if threaded else 0.0)
        return {}

    devices = ["cpu"] * 3 if threaded else ["cpu"]
    driver = BatchPairDriver(tmp_path / "b", runner=faulty)
    with pytest.raises(torch.AcceleratorError, match="illegal memory"):
        driver.run(jobs, devices=devices)
    assert calls.count("p1") == 1
    ran = set(calls) - {"p1"}
    assert ran == {"p0"} if not threaded else ran <= {"p0", "p2", "p3"}
    status = _statuses(tmp_path / "b")
    assert status == {f"p{i}": ("done", [True]) if f"p{i}" in ran
                      else ("pending", [False] if i == 1 else [])
                      for i in range(n)}
    failed = BatchPairDriver(tmp_path / "b").manifest["p1"]["attempts"][0]
    assert "illegal memory" in failed["error"]
    assert "AcceleratorError" in failed["traceback"]
    assert failed["device"] == "cpu"

    rerun = []

    def good(job, pair_dir):
        rerun.append(job.pair_id)
        return {}

    BatchPairDriver(tmp_path / "b", runner=good).run(jobs, devices=devices)
    assert sorted(rerun) == sorted(f"p{i}" for i in range(n)
                                   if f"p{i}" not in ran)
    status = _statuses(tmp_path / "b")
    assert status["p1"] == ("done", [False, True])
    assert all(s == "done" for s, _ in status.values())


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    launch_error("quantize_u16 kernel launch", 1)])
def test_out_of_memory_and_refused_launch_are_retried(tmp_path, error):
    """``torch.OutOfMemoryError`` and a launch the host code refused
    (CUDA error 1, a plain ``RuntimeError``) are no
    ``torch.AcceleratorError``: the pair that raises them is recorded
    and retried (1 + max_retries attempts) and ``failed``, and the batch
    goes on to the next pair, as the reference's driver does."""
    assert not isinstance(error, torch.AcceleratorError)

    def runner(job, pair_dir):
        if job.pair_id == "p0":
            raise error
        return {}

    jobs = [PairJob(f"p{i}", "a.nc", "b.tif") for i in range(2)]
    driver = BatchPairDriver(tmp_path / "o", runner=runner)
    driver.run(jobs)
    assert _statuses(tmp_path / "o") == {"p0": ("failed", [False, False]),
                                         "p1": ("done", [True])}
    assert str(error) in driver.manifest["p0"]["attempts"][-1]["error"]

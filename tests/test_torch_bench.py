"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

- ``build_workload(0.05)``: the scene's arrays equal ``bench.
  build_workload(0.05)``'s (``array_equal``), its grids field by field,
  and the plan is the port's ``FusedOrthoFusionPlan``.
- ``accuracy_metrics`` against a JAX copy of ``bench.py:351-372`` on
  seeded arrays with NaN holes: the finite fraction exact, the max
  exact, the PSNRs within 1e-4 dB, SAM within 1e-6 rad.
- ``main(["--device", "cpu"])`` at HYPERRES_BENCH_SCALE=0.1: one JSON
  line last on stdout, with the keys below, every default gate met (the
  gates are full-scale gates: at 0.1 the pipeline PSNR reads ~45.4 dB,
  at 0.05 ~40.9 dB, which the tiny grid's warp limits); with
  HYPERRES_BENCH_PSNR_GATE=99 it exits 4 with ``accuracy_gate_failed``;
  ``main([])`` without a card exits 3 with ``no_cuda_device`` and runs
  nothing.
- The fused product at scale 0.05 against the JAX plan's: the same
  valid pixels, PSNR > 35 dB (the two packages draw different OT
  samples: ROADMAP's PRNG pin, as tests/test_bench_workload.py:58-68).
"""

import json
import sys
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
import bench_torch  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hyperres.core.config import OTConfig, PolyFusionConfig  # noqa: E402
from hyperres.kernels.lstsq import polyval_channels  # noqa: E402
from hyperres.kernels.stats import erode_mask  # noqa: E402
from hyperres.pipeline import psnr  # noqa: E402
from hyperres_torch.core import config as tconfig  # noqa: E402
from hyperres_torch.fusion.fused import FusedOrthoFusionPlan  # noqa: E402
from hyperres_torch.testing import bench_scene  # noqa: E402

#: bench.py's JSON keys, with bench.py's XLA-only ones dropped
#: (bench_torch.py's docstring) and the port's four added
RESULT_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_kind",
               "psnr_db", "sam_rad", "method_psnr_db", "ingest_s",
               "ingest_inclusive_s", "transfer", "compile_s", "warmup_s",
               "setup_s", "engine", "warp_kernel", "warp_backend",
               "device", "power_limit_w", "peak_mem_gb", "launches"}
OT_SMALL = dict(n_samples=1500, num_itermax=120)


@pytest.fixture(scope="module")
def workloads():
    """Both packages' workload at scale 0.05 with 1500 OT samples (the
    config of tests/test_bench_workload.py)."""
    jwk = bench.build_workload(
        scale=0.05, config=PolyFusionConfig(ot=OTConfig(**OT_SMALL)))
    twk = bench_torch.build_workload(
        scale=0.05, config=tconfig.PolyFusionConfig(
            ot=tconfig.OTConfig(**OT_SMALL)), device="cpu")
    return jwk, twk


@pytest.fixture
def bench_env(monkeypatch, tmp_path_factory):
    """Scale 0.1, and the scene cache in a directory of this pytest run."""
    monkeypatch.setattr(bench_scene, "CACHE_DIR",
                        tmp_path_factory.getbasetemp() / "scenecache")
    monkeypatch.setenv("HYPERRES_BENCH_SCALE", "0.1")
    for k in ("HYPERRES_BENCH_WARP", "HYPERRES_BENCH_RUNS",
              "HYPERRES_BENCH_TRANSFER", "HYPERRES_BENCH_OT_DEBIAS",
              *bench_torch.GATE_ENV.values()):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _last_json(out: str) -> dict:
    lines = out.strip().splitlines()
    assert lines
    return json.loads(lines[-1])


def test_build_workload_matches_bench(workloads):
    """The same scene as bench.build_workload, and the port's plan."""
    jwk, twk = workloads
    for k in ("raw", "s2_dn", "glt", "wavelengths", "good_mask", "spectra"):
        np.testing.assert_array_equal(twk[k], jwk[k])
        assert twk[k].dtype == jwk[k].dtype
    for k in ("ortho_grid", "utm60", "s2_grid"):
        assert astuple(twk[k]) == astuple(jwk[k])
    assert isinstance(twk["plan"], FusedOrthoFusionPlan)
    assert twk["plan"].device == torch.device("cpu")


def _jax_accuracy(fused, target, coeffs):
    """bench.py:351-372, verbatim but for the jit."""
    vf = jnp.isfinite(fused).all(axis=-1)
    valid = vf & jnp.isfinite(target).all(axis=-1)
    e = erode_mask(valid, 2)
    n = jnp.maximum(jnp.sum(e), 1)
    mapped = jnp.clip(polyval_channels(coeffs, jnp.nan_to_num(target)),
                      0.0, 1.0)

    def psnr_vs(ref):
        diff = jnp.where(e[..., None], fused - ref, 0.0)
        mse = jnp.sum(diff * diff) / (n * fused.shape[-1])
        return 10.0 * jnp.log10(1.0 / mse)

    num = jnp.sum(fused * mapped, axis=-1)
    den = (jnp.linalg.norm(fused, axis=-1)
           * jnp.linalg.norm(mapped, axis=-1) + 1e-12)
    ang = jnp.arccos(jnp.clip(num / den, -1.0, 1.0))
    sam = jnp.sum(jnp.where(e, ang, 0.0)) / n
    return (vf.mean(), jnp.nanmax(fused), psnr_vs(mapped), psnr_vs(target),
            sam)


def test_accuracy_metrics_matches_jax_copy(rng):
    """Finite fraction and max exact; PSNRs within 1e-4 dB; SAM within
    1e-6 rad, on seeded (60, 70, 3) arrays with NaN holes."""
    target = rng.uniform(0.05, 0.9, (60, 70, 3)).astype(np.float32)
    fused = np.clip(target + rng.normal(0, 0.01, target.shape), 0, 1
                    ).astype(np.float32)
    fused[5:9, 10:14] = np.nan
    fused[40, :, 1] = np.nan
    target[20:23, 50:60] = np.nan
    coeffs = np.array([[0.1, -0.2, 0.1, 0.95, 0.01],
                       [0.0, 0.05, -0.1, 1.02, 0.0],
                       [-0.05, 0.1, 0.0, 0.9, 0.02]], np.float32)
    got = bench_torch.accuracy_metrics(torch.from_numpy(fused),
                                       torch.from_numpy(target),
                                       torch.from_numpy(coeffs))
    want = [float(x) for x in _jax_accuracy(jnp.asarray(fused),
                                            jnp.asarray(target),
                                            jnp.asarray(coeffs))]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) <= 1e-4
    assert abs(got[3] - want[3]) <= 1e-4
    assert abs(got[4] - want[4]) <= 1e-6
    assert 0.0 < got[0] < 1.0 and 30.0 < got[2] < 60.0


def test_main_on_cpu_meets_the_gates(bench_env, capsys):
    """One JSON line, last on stdout, with every key; the default gates
    met at scale 0.1; the returned dict is the printed one."""
    result = bench_torch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 1
    line = _last_json(out)
    assert line == json.loads(json.dumps(result))
    assert set(line) == RESULT_KEYS
    assert line["metric"] == bench._METRIC_NAME
    assert line["unit"] == "seconds" and line["value"] > 0
    assert line["vs_baseline"] == round(2.0 / line["value"], 3)
    assert line["psnr_db"] >= 45.0 and line["sam_rad"] <= 0.01
    assert line["method_psnr_db"] >= 28.0
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["peak_mem_gb"] is None and line["launches"] == {}
    assert line["transfer"] == "u16" and line["warp_kernel"] == "auto"
    assert line["engine"] == "FusedOrthoFusionPlan"


def test_gate_failure_exits_4(bench_env, capsys):
    bench_env.setenv("HYPERRES_BENCH_PSNR_GATE", "99")
    bench_env.setenv("HYPERRES_BENCH_RUNS", "1")
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--device", "cpu"])
    assert exc.value.code == 4
    line = _last_json(capsys.readouterr().out)
    assert line["status"] == "accuracy_gate_failed"
    assert line["psnr_db"] < 99.0


def test_no_card_exits_3_and_runs_nothing(bench_env, capsys):
    """Without a card and without --device: the partial line, exit 3,
    and no workload is built (no CPU fallback)."""
    bench_env.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **k):
        raise AssertionError("build_workload ran without a card")

    bench_env.setattr(bench_torch, "build_workload", refuse)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main([])
    assert exc.value.code == 3
    line = _last_json(capsys.readouterr().out)
    assert line["status"] == "no_cuda_device"
    assert line["value"] is None and line["metric"] == bench._METRIC_NAME


def test_fused_product_agrees_with_the_jax_plan(workloads):
    """Same valid pixels; PSNR > 35 dB (different OT samples)."""
    jwk, twk = workloads
    jplan, tplan = jwk["plan"], twk["plan"]
    jout = jplan(jwk["raw"], jplan.prepare_s2(jwk["s2_dn"]),
                 key=jax.random.PRNGKey(1))
    tout = tplan(twk["raw"], tplan.prepare_s2(twk["s2_dn"]),
                 generator=tplan.generator(1))
    jf = np.asarray(jout["fused_10m"])
    tf = tout["fused_10m"].numpy()
    va, vb = np.isfinite(tf).all(-1), np.isfinite(jf).all(-1)
    np.testing.assert_array_equal(va, vb)
    assert va.mean() > 0.3
    assert psnr(tf[va], jf[vb]) > 35.0

"""The port's full-scale programs under ``scripts/torch_*.py`` against the
JAX scripts they port, at small sizes on the CPU (every call passes
``device="cpu"``).

- ``torch_bench_throughput.py`` at scale 0.05 with 2 granules: ``main``'s
  JSON line; on granule 1, each stage up to the stretch (the UTM cube,
  the SRF synthesis, both stretched sides) against the same JAX
  functions on the same granule within 1e-5; the fused product
  statistically, PSNR > 35 dB on the same valid pixels (the packages
  draw different OT samples: ROADMAP's PRNG pin).
- ``torch_bench_sr_granule.py`` at ``--scale 0.01`` with the JAX fit's
  parameters carried across (``params_from_numpy``; through the JAX
  checkpoint for ``main``): the u16 codes within one step of
  ``RidgeSpectralSR._predict_quant_batches`` and the same 65535 mask.
- ``torch_validate_fullscale.py`` at 0.05: each warp's PSNR within 0.01
  dB and SAM within 1e-5 rad of the JAX script's numbers computed here
  from the same scene, and ``PASS``.
- ``torch_validate_fused_parity.py`` at 0.05: each warp's valid-mask
  agreement equal to the JAX script's computation here, its
  99.9th-percentile difference within 1e-5 of it.
- ``torch_run_production_fullscale.run`` on a raw 96 x 100 scene: the
  same product files (relative paths) as the JAX pipeline's run with
  the JAX script's arguments on the same scene files.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_bench_sr_granule as sr_bench  # noqa: E402
import torch_bench_throughput as tp  # noqa: E402
import torch_run_production_fullscale as prod  # noqa: E402
import torch_validate_fullscale as vfull  # noqa: E402
import torch_validate_fused_parity as vpar  # noqa: E402
from hyperres import pipeline as jpipe  # noqa: E402
from hyperres.core.config import OTConfig, RidgeSRConfig  # noqa: E402
from hyperres.core.config import TilingConfig  # noqa: E402
from hyperres.fusion.ridge_sr import RidgeSpectralSR, save_params  # noqa: E402
from hyperres.fusion.sampling import sample_valid_pixels_device  # noqa: E402
from hyperres.kernels import glt as jglt  # noqa: E402
from hyperres.kernels import warp as jwarp  # noqa: E402
from hyperres.kernels.lstsq import polyfit, polyval_channels  # noqa: E402
from hyperres.kernels.sinkhorn import ot_barycentric_targets  # noqa: E402
from hyperres.kernels.srf import srf_synthesize  # noqa: E402
from hyperres.kernels.stats import (cube_psnr_sam,  # noqa: E402
                                    shared_percentile_stretch)
from hyperres.pipeline import psnr  # noqa: E402

STAGE_TOL = 1e-5


def _jax_throughput_program(ctx, raw, s2rgb, key):
    """The body of scripts/bench_throughput.py's ``pipe`` (:112-138) on
    the port context's operands, brought to the host."""
    def j(t):
        return jnp.asarray(t.numpy())

    ot_cfg = OTConfig()
    utm_cube = jwarp.orthowarp_two_pass(
        jnp.asarray(raw), j(ctx["flat_idx"]).astype(jnp.int32),
        j(ctx["valid"]), j(ctx["wr"]), j(ctx["wc"]), j(ctx["cstar"]),
        method="cubic", fill=-9999.0)
    synth = srf_synthesize(utm_cube, j(ctx["Wsrf"]), fast=True)
    valid60 = utm_cube[..., 0] != -9999.0
    sim_n = shared_percentile_stretch(synth[..., ::-1], valid60)
    ref_n = shared_percentile_stretch(jnp.asarray(s2rgb)[..., ::-1], valid60)
    k1, k2 = jax.random.split(key)
    Xs, _ = sample_valid_pixels_device(sim_n, valid60, ot_cfg.n_samples, k1)
    Ys, _ = sample_valid_pixels_device(ref_n, valid60, ot_cfg.n_samples, k2)
    Ybar = ot_barycentric_targets(Xs, Ys, reg=ot_cfg.reg,
                                  num_itermax=ot_cfg.num_itermax,
                                  stop_thr=ot_cfg.stop_thr)
    coeffs = jnp.stack([polyfit(Xs[:, c], Ybar[:, c], 4) for c in range(3)])
    sim10 = jwarp.separable_resample_matmul(sim_n, j(ctx["Wr10"]),
                                            j(ctx["Wc10"]), fill=jnp.nan)
    fused = jnp.clip(polyval_channels(coeffs, sim10), 0.0, 1.0)
    return {k: np.asarray(v) for k, v in
            dict(utm_cube=utm_cube, synth=synth, sim_n=sim_n, ref_n=ref_n,
                 fused=fused).items()}


def test_throughput_program_matches_jax(monkeypatch, capsys):
    monkeypatch.setenv("HYPERRES_TP_SCALE", "0.05")
    monkeypatch.setenv("HYPERRES_TP_GRANULES", "2")
    monkeypatch.delenv("HYPERRES_TP_TRANSFER", raising=False)
    result = tp.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "pre-generating granules ..."
    assert out[-2].startswith("throughput: 2 granules in ")
    line = json.loads(out[-1])
    assert line == json.loads(json.dumps(result))
    assert set(line) == {"granules", "total_s", "granules_per_min",
                         "transfer", "device", "power_limit_w"}
    assert line["granules"] == 2 and line["granules_per_min"] > 0
    assert line["transfer"] == "u16" and line["device"] == "cpu"

    ctx = tp.make_context(0.05, "cpu")
    raw, s2rgb = tp.gen_granule(ctx, 1)
    g = torch.Generator()
    g.manual_seed(1)
    got = tp.granule_program(ctx, torch.from_numpy(raw),
                             torch.from_numpy(s2rgb), g)
    want = _jax_throughput_program(ctx, raw, s2rgb, jax.random.PRNGKey(1))
    for k in ("utm_cube", "synth", "sim_n", "ref_n"):
        a, b = got[k].numpy(), want[k]
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=STAGE_TOL, err_msg=k)
    tf, jf = got["fused"].numpy(), want["fused"]
    va, vb = np.isfinite(tf).all(-1), np.isfinite(jf).all(-1)
    np.testing.assert_array_equal(va, vb)
    assert va.mean() > 0.3
    assert psnr(tf[va], jf[vb]) > 35.0
    assert np.isfinite(float(got["sanity"]))


def test_sr_granule_codes_match_jax(tmp_path, capsys):
    """Within one u16 step of the reference's batched program, the same
    65535 pixels (the n // 20 stripe and nothing else)."""
    rng = np.random.default_rng(0)
    Xt, Yt = sr_bench.training_data(rng)
    jm = RidgeSpectralSR(10, 32, RidgeSRConfig(degree=3, batch_pixels=4096))
    jm.fit(Xt, Yt)
    h, w = sr_bench.granule_shape(0.01)
    cube = sr_bench.granule_cube(rng, h, w)
    n = h * w

    from hyperres_torch.core.config import RidgeSRConfig as TConfig
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR as TModel

    p = jm.params
    model = TModel(10, 32, TConfig(degree=3), device="cpu").params_from_numpy(
        *(np.asarray(a) for a in (p.x_mean, p.x_std, p.W, p.intercept)))
    legs, _, q, q_host = sr_bench.product_legs(model, cube)
    assert set(legs) == {"upload_s", "compile_s", "device_program_s",
                         "readback_s"}
    np.testing.assert_array_equal(q.numpy(), q_host)

    X = cube.reshape(10, n).T
    batch = 4096
    n_pad = -(-n // batch) * batch
    Xp = np.zeros((n_pad, 10), np.float32)
    Xp[:n] = X
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    valid[:n // 20] = False
    want = np.asarray(jm._predict_quant_batches(
        jm.params, jnp.asarray(Xp), jnp.asarray(valid), batch))[:n].T
    got = q_host.reshape(32, n)
    assert (got == 65535).any()
    np.testing.assert_array_equal(got == 65535, want == 65535)
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
    assert ((got == 65535).all(0) == (np.arange(n) < n // 20)).all()

    ckpt = tmp_path / "sr.npz"
    save_params(str(ckpt), jm)
    result = sr_bench.main(["--scale", "0.01", "--params", str(ckpt),
                            "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(line) == {"metric", "mpx", "bands_in", "bands_out", "fit_s",
                         "compile_s", "device_program_s", "device_px_per_s",
                         "upload_s", "readback_s", "e2e_s", "e2e_px_per_s",
                         "valid_px", "batch", "device", "power_limit_w"}
    assert line["metric"] == "spectral_sr_10m_product"
    assert line["valid_px"] == n - n // 20 and line["fit_s"] == 0.0


def test_validate_fullscale_matches_jax(capsys):
    """PSNR within 0.01 dB, SAM within 1e-5 rad, of the JAX script's
    metrics on the same scene; ``PASS``."""
    results = vfull.main(["0.05", "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "PASS"
    sc = vfull.make_scene(0.05)
    args = [jnp.asarray(sc[k]) for k in ("raw", "flat_idx", "valid", "wr",
                                         "wc")]
    args[1] = args[1].astype(jnp.int32)
    truth = jnp.clip(jnp.asarray(sc["a_truth"]) @ jnp.asarray(sc["spectra"]),
                     0.005, 0.95)
    cubes = {"taploop": jwarp.orthowarp_taploop(*args, method="cubic",
                                                fill=-9999.0, row_chunks=64),
             "two_pass": jwarp.orthowarp_two_pass(
                 *args, jnp.asarray(sc["cstar"]), method="cubic",
                 fill=-9999.0, backend="xla")}
    assert set(results) == set(cubes)
    for name, cube in cubes.items():
        vf, p, s = (float(x) for x in cube_psnr_sam(cube, truth,
                                                    fill=-9999.0, erode=2))
        r = results[name]
        assert abs(r["valid_fraction"] - vf) <= 1e-6, name
        assert abs(r["psnr_db"] - p) <= 0.01, name
        assert abs(r["sam_rad"] - s) <= 1e-5, name


def test_validate_fused_parity_matches_jax():
    """Each warp against the two-step path: the mask agreement equal,
    the 99.9th percentile within 1e-5, of the JAX computation."""
    got = vpar.compare(0.05, "cpu")
    sc = vpar.make_scene(0.05)
    args = [jnp.asarray(sc[k]) for k in ("raw", "flat_idx", "valid", "wr",
                                         "wc")]
    args[1] = args[1].astype(jnp.int32)
    ortho = jglt.glt_gather(args[0], args[1], args[2], fill_value=-9999.0)
    two = jwarp.warp_interpolate_taploop(ortho, args[3], args[4],
                                         nodata=-9999.0, method="cubic",
                                         fill=-9999.0)
    fused = {"taploop": jwarp.orthowarp_taploop(*args, method="cubic",
                                                fill=-9999.0, row_chunks=64),
             "two_pass": jwarp.orthowarp_two_pass(
                 *args, jnp.asarray(sc["cstar"]), method="cubic",
                 fill=-9999.0, backend="xla")}
    assert set(got) == set(vpar.WARPS) == set(fused)
    for name, f in fused.items():
        want = vpar.agreement(torch.from_numpy(np.array(f)),
                              torch.from_numpy(np.array(two)),
                              vpar.WARPS[name])
        assert got[name]["mask_agreement"] == want["mask_agreement"], name
        assert abs(got[name]["p99_9"] - want["p99_9"]) <= 1e-5, name
    assert got["taploop"]["mask_agreement"] > vpar.MASK_AGREEMENT_MIN
    assert got["taploop"]["p99_9"] < vpar.P999_MAX


def _products(root: Path) -> set:
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.is_file()}


def test_production_run_writes_the_jax_product_set(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERRES_SRF_SOURCE", "parametric")
    res = prod.run(tmp_path / "torch", raw_shape=(96, 100), s2_size=720,
                   device="cpu")
    scene = tmp_path / "torch" / "scene"
    jres = jpipe.run_pair_pipeline(
        next(scene.glob("*.nc")), next(scene.glob("*.tif")),
        tmp_path / "jax_run", tiling_config=TilingConfig(max_black_frac=0.05),
        max_tiles=4, train_sr=True)
    got = _products(tmp_path / "torch" / "run")
    assert got == _products(tmp_path / "jax_run")
    assert len(res.tiles) == len(jres.tiles)
    assert res.report_path.exists()

#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device: needs ``torch.cuda.is_available()``; prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the three kernels (``csrc/scanline_warp.cu``,
   ``csrc/sr_predict.cu``, ``csrc/sinkhorn_duals.cu``) with nvcc for
   sm_90a, one nvcc each, all started together, and prints the build
   times and ptxas reports.
3. Kernel vs plain: both banded passes of the scanline kernel against
   their plain PyTorch version on the scale-0.25 bench scene's warp
   operands, cubic and bilinear, within KERNEL_TOL; the dense route
   (both passes, pass 2 on pass 1's natural layout) against its dense
   plain version on the same operands.
4. Main path: generates the full-scale (1.0) bench scene, builds the
   port's ``FusedOrthoFusionPlan`` on the card, runs it once to warm up
   and N_RUNS times under CUDA events, checks the output shapes and that
   every run launched each pass of the kernel once. Then times the
   kernel against its plain version at the main path's shapes.
5. Accuracy gates of ``bench.py`` against the plan's own
   ``s2_reference_10m``: finite fraction > 0.3, max <= 1, pipeline PSNR
   >= 45 dB, SAM <= 0.01 rad, method PSNR >= 28 dB.
5a. The ``warp_kernel="pallas"`` plan (the dense scanline route) at
   full scale: warm-up and N_RUNS runs under CUDA events, two dense
   launches per run, every gate of phase 5, its ``utm_cube`` within
   KERNEL_TOL of phase 4's; then the dense route and its plain version
   timed at the plan's shapes.
5b. Sinkhorn at 5000 x 5000 on the full-scale scene's stretched 60 m
   OT samples and slot weights, under the plan's own ``OTConfig``
   (the defaults): the duals kernel against its plain version at a
   fixed sweep count, P = exp(Mr + f + g) within SINKHORN_P_RTOL of
   its largest entry, f and g within SINKHORN_FG_TOL, err within
   SINKHORN_ERR_RTOL / _ATOL; both with the config's stop rule, the
   same sweep count and err within the same bound;
   ``ot_barycentric_targets(engine=
   "pallas")``, whose run must launch the kernel, against
   ``engine="xla"`` at an equal sweep count within ENGINE_TOL (with
   the stop rule the two engines stop on different marginals, and
   their difference is printed); both engines timed.
5c. The ``fusion_method="ot_affine"`` plan at full scale: shapes,
   finite fraction > 0.3, max <= 1; its PSNRs and SAM printed
   (``bench.py`` gates only ``ot_poly``).
6. Spectral-SR fit and entry: fits the product ridge model (degree 3,
   10 -> 32 bands) on the card on 200k seeded pixels and checks its
   predictions against the same fit on the CPU (SR_FIT_TOL); runs
   ``hyperres_torch.entry``'s forward (10 -> 285) and checks (8192, 285)
   finite.
7. SR kernel vs plain: ``csrc/sr_predict.cu`` against its plain PyTorch
   version on a 1024 x 1024 px cube with a NaN and a nodata pixel, both
   layouts, By = 32 and By = 285: identical 65535 mask, <= SR_STEPS_TOL
   u16 steps.
8. SR main path at full scale: ``predict_cube_u16`` on a (10, 9140,
   9309) cube with a nodata stripe over the first 5 % of rows, once to
   warm up and N_RUNS times under CUDA events; checks the (32, 9140,
   9309) u16 product, that the stripe and nothing else is 65535, that
   every run launched the kernel, and the kernel against its plain
   version at that shape; times both.

Prints the kernels' JSON line (the two banded passes, the dense route,
``sr_predict_u16``, ``sinkhorn_duals``), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

MAIN_SCALE = 1.0
CHECK_SCALE = 0.25
N_RUNS = 3
#: kernel vs plain, max abs error: both evaluate the same <= 4 taps in
#: f32, in the same order; they differ only by FMA contraction in the
#: weights and the accumulation (a few ulp of values <= ~1)
KERNEL_TOL = 1e-5
GATES = {"finite_frac_min": 0.3, "max_le": 1.0, "psnr_db_min": 45.0,
         "sam_rad_max": 0.01, "method_psnr_db_min": 28.0}
EXPECT_UTM = (1523, 1550, 285)
EXPECT_FUSED = (9140, 9309, 3)
REPLACES = {"scanline_resample_pass1": "hyperres/kernels/pallas_ops.py:390",
            "scanline_resample_pass2": "hyperres/kernels/pallas_ops.py:467"}
SCANLINE_SOURCE = "hyperres_torch/csrc/scanline_warp.cu"
DENSE_REPLACES = ("hyperres/kernels/pallas_ops.py:189 "
                  "(pallas_scanline_resample)")
#: kernel vs plain at 5000 x 5000, both summing f32 exps in fixed orders
#: of their own: max |dP| over max P, with P = exp(Mr + f + g) (~10 ulp
#: of log P; measured 1.6e-6 on an H100), and max |df|, |dg| (~25 ulp
#: of duals of magnitude ~30)
SINKHORN_P_RTOL = 1e-5
SINKHORN_FG_TOL = 1e-4
#: kernel vs plain, the row-marginal err: near convergence it is rounding
#: noise of the two orders (measured on an H100: 6.9e-9 / 1.2e-8 at 300
#: sweeps, 6.9e-7 / 7.4e-7 at the stop), so |dErr| <= RTOL * err + ATOL
SINKHORN_ERR_RTOL = 0.1
SINKHORN_ERR_ATOL = 1e-8
#: engine="pallas" vs engine="xla" targets at an equal sweep count: the
#: reference's bound for its two engines (tests/test_kernels_ot_lstsq.py:120)
ENGINE_TOL = 5e-5
SINKHORN_SOURCE = "hyperres_torch/csrc/sinkhorn_duals.cu"
SINKHORN_REPLACES = "hyperres/kernels/pallas_ops.py:605 (pallas_sinkhorn_duals)"
#: the SR product: a degree-3 ridge model from 10 S2 bands to 32 EMIT
#: bands over a 9140 x 9309 px 10 m granule (scripts/bench_sr_granule.py)
SR_BX, SR_BY, SR_DEGREE = 10, 32, 3
SR_SHAPE = (SR_BX, 9140, 9309)
SR_CHECK_HW = (1024, 1024)
SR_NODATA = -9999.0
#: kernel vs plain: the same f32 terms summed in another order move a
#: value on a rounding edge by one u16 step
SR_STEPS_TOL = 1
#: card fit vs CPU fit, predictions: the f32 Gram sums run in another
#: order on the card (measured 9.7e-6 on an H100; the CPU's f32 fit is
#: within 9e-7 of an f64 fit of the same data)
SR_FIT_TOL = 1e-4
SR_SOURCE = "hyperres_torch/csrc/sr_predict.cu"
SR_REPLACES = ("hyperres/kernels/pallas_ops.py:828 "
               "(pallas_sr_predict_u16_cmajor); "
               "hyperres/kernels/pallas_ops.py:725 (pallas_sr_predict_u16)")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA
    events around ``reps`` calls after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_passes(src_ext, cstar, rows, method: str, timed: bool) -> dict:
    """Both kernel passes against the plain version on the same inputs
    (pass 2 on the kernel's pass-1 output). Returns per pass name:
    max_abs_err and, if ``timed``, ms / plain_ms."""
    import torch
    from hyperres_torch.kernels.banded import (
        KERNEL_NAMES, scanline_resample, scanline_resample_reference,
    )

    res = {}
    h = None
    for axis, src, pos in ((1, src_ext, cstar), (0, None, rows)):
        src = h if src is None else src
        got = scanline_resample(src, pos, axis, method)
        want = scanline_resample_reference(src, pos, axis, method)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        entry = {"max_abs_err": err}
        del want
        if timed:
            entry["ms"] = cuda_ms(
                lambda: scanline_resample(src, pos, axis, method), 10)
            entry["plain_ms"] = cuda_ms(
                lambda: scanline_resample_reference(src, pos, axis,
                                                    method), 3)
        res[KERNEL_NAMES[axis]] = entry
        h = got
    return res


def compare_dense(src_ext, cstar, rows, method: str, timed: bool) -> dict:
    """The dense route against its dense plain version on the same
    inputs, both passes as ``orthowarp_two_pass(backend="pallas")`` runs
    them (pass 2 on the kernel's pass-1 output). Returns max_abs_err
    over both passes and, if ``timed``, per pass ms / plain_ms."""
    import torch
    from hyperres_torch.kernels.banded import (
        scanline_resample_dense, scanline_resample_dense_reference,
    )

    res, h = {"max_abs_err": 0.0}, None
    for axis, src, pos in ((1, src_ext, cstar), (0, None, rows)):
        src = h if src is None else src
        k = 2 - axis
        got = scanline_resample_dense(src, pos, method, axis=axis)
        want = scanline_resample_dense_reference(src, pos, method, axis=axis)
        torch.cuda.synchronize()
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float((got - want).abs().max()))
        del want
        if timed:
            res[f"pass{k}_ms"] = cuda_ms(
                lambda: scanline_resample_dense(src, pos, method, axis=axis),
                10)
            res[f"pass{k}_plain_ms"] = cuda_ms(
                lambda: scanline_resample_dense_reference(src, pos, method,
                                                          axis=axis), 2)
        h = got
    return res


def accuracy_metrics(fused, target, coeffs, method: str = "ot_poly"):
    """bench.py's gates (bench.py:351-372): finite fraction, max, the
    pipeline PSNR (fused vs the fit applied to the target), the method
    PSNR (fused vs the target) and SAM, over the 2-px eroded interior of
    the jointly valid pixels. ``method`` names the fit's form."""
    import torch
    from hyperres_torch.fusion.fused import apply_params
    from hyperres_torch.kernels.stats import erode_mask

    vf = torch.isfinite(fused).all(dim=-1)
    valid = vf & torch.isfinite(target).all(dim=-1)
    e = erode_mask(valid, 2)
    n = torch.clamp(e.sum(), min=1)
    mapped = torch.clamp(apply_params(method, coeffs,
                                      torch.nan_to_num(target)), 0.0, 1.0)
    zero = torch.zeros((), device=fused.device)

    def psnr_vs(ref):
        diff = torch.where(e[..., None], fused - ref, zero)
        mse = torch.sum(diff * diff) / (n * fused.shape[-1])
        return float(10.0 * torch.log10(1.0 / mse))

    num = torch.sum(fused * mapped, dim=-1)
    den = (torch.linalg.norm(fused, dim=-1)
           * torch.linalg.norm(mapped, dim=-1) + 1e-12)
    ang = torch.arccos(torch.clamp(num / den, -1.0, 1.0))
    sam = float(torch.where(e, ang, zero).sum() / n)
    fmax = float(torch.where(torch.isnan(fused),
                             torch.tensor(float("-inf"),
                                          device=fused.device),
                             fused).max())
    return (float(vf.to(torch.float32).mean()), fmax, psnr_vs(mapped),
            psnr_vs(target), sam)


def u16_compare(got, want) -> tuple:
    """(mask equal, max |got - want| in steps, differing elements) of two
    u16 tensors of one shape, one slice of the first axis at a time (in
    int32: CUDA takes few operators on uint16)."""
    import torch

    same_mask, worst, n_diff = True, 0, 0
    for g, w in zip(got, want):
        g = g.to(torch.int32)
        w = w.to(torch.int32)
        same_mask &= bool(((g == 65535) == (w == 65535)).all())
        d = (g - w).abs()
        worst = max(worst, int(d.max()))
        n_diff += int((d != 0).sum())
    return same_mask, worst, n_diff


def sr_training_data(rng, n: int = 200_000):
    """The SR bench's synthetic training pixels
    (scripts/bench_sr_granule.py:56-62)."""
    X = rng.random((n, SR_BX)).astype(np.float32)
    Y = np.clip(0.15 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2]
                + 0.05 * rng.random((n, SR_BY)), 0.01,
                0.99).astype(np.float32)
    return X, Y


def sr_phases(dev) -> dict:
    """Phases 6-8 (see the module docstring). Returns the SR kernel's
    entry of the kernels line."""
    import torch
    from hyperres.core.config import RidgeSRConfig
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.entry import entry
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
    from hyperres_torch.kernels.sr_predict import (
        KERNEL_NAME, sr_predict_u16, sr_predict_u16_reference, valid_pixels,
    )

    # -- 6. fit on the card, entry forward ---------------------------------
    rng = np.random.default_rng(0)
    Xt, Yt = sr_training_data(rng)
    cfg = RidgeSRConfig(degree=SR_DEGREE)
    t0 = time.perf_counter()
    model = RidgeSpectralSR(SR_BX, SR_BY, cfg, device=dev).fit(Xt, Yt)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    cpu_model = RidgeSpectralSR(SR_BX, SR_BY, cfg).fit(Xt, Yt)
    xq = rng.random((8192, SR_BX)).astype(np.float32)
    fit_err = float((model.predict(xq).cpu() - cpu_model.predict(xq))
                    .abs().max())
    r2, rmse = model.evaluate(Xt[:20000], Yt[:20000])
    log(f"SR fit ({len(Xt)} px, degree {SR_DEGREE}, F = "
        f"{model.n_features}) on the card in {t_fit:.3f} s; vs the CPU "
        f"fit max abs err {fit_err:.3e} (tol {SR_FIT_TOL:g}); mean R^2 "
        f"{float(r2.mean()):.4f}, mean RMSE {float(rmse.mean()):.5f}")
    if not fit_err <= SR_FIT_TOL:
        fail(f"SR fit on the card disagrees with the CPU fit: {fit_err:.3e}")
    fwd, (x,) = entry(dev)
    y = fwd(x)
    torch.cuda.synchronize()
    log(f"entry forward: {tuple(y.shape)}, finite "
        f"{bool(torch.isfinite(y).all())}")
    if tuple(y.shape) != (8192, 285) or not bool(torch.isfinite(y).all()):
        fail("entry forward is not a finite (8192, 285) tensor")

    # -- 7. kernel vs plain at 1024 x 1024 px, both layouts, By 32 / 285 ----
    worst = 0
    h, w = SR_CHECK_HW
    cube = rng.random((SR_BX, h, w)).astype(np.float32)
    cube[3, h // 10, w // 5] = np.nan
    cube[7, h // 2, w // 2] = SR_NODATA
    Xc = torch.from_numpy(cube).to(dev).reshape(SR_BX, h * w)
    for m in (model, fwd):
        args = (m.x_mean, m.x_std, m.W, m.intercept, m.factors)
        for layout in ("cmajor", "rowmajor"):
            X = Xc if layout == "cmajor" else Xc.T.contiguous()
            kw = {"nodata": SR_NODATA}
            if layout == "rowmajor":  # validity from a mask
                kw = {"valid": valid_pixels(X, SR_NODATA)}
            got = sr_predict_u16(X, *args, layout=layout, **kw)
            want = sr_predict_u16_reference(X, *args, layout=layout, **kw)
            if layout == "rowmajor":
                got, want = got.T, want.T
            same, steps, n_diff = u16_compare(got, want)
            n_nodata = int((got.to(torch.int32) == 65535).sum())
            log(f"check SR {layout} By={m.n_outputs}: mask identical "
                f"{same}, max |dq| {steps} (tol {SR_STEPS_TOL}), "
                f"{n_diff} of {got.numel()} elements differ, "
                f"{n_nodata // m.n_outputs} nodata px")
            if not (same and steps <= SR_STEPS_TOL and
                    n_nodata == 2 * m.n_outputs):
                fail(f"SR kernel disagrees with its plain version "
                     f"({layout}, By={m.n_outputs})")
            worst = max(worst, steps)
    del Xc, got, want, fwd, x, y

    # -- 8. main SR path at full scale -------------------------------------
    t0 = time.perf_counter()
    cube = rng.random(SR_SHAPE, dtype=np.float32)
    stripe = SR_SHAPE[1] // 20
    cube[:, :stripe, :] = SR_NODATA
    X = torch.from_numpy(cube).to(dev)
    del cube
    torch.cuda.synchronize()
    n_px = SR_SHAPE[1] * SR_SHAPE[2]
    log(f"SR cube {SR_SHAPE} f32 ({X.numel() * 4 / 1e9:.2f} GB) made and "
        f"moved to the card in {time.perf_counter() - t0:.1f} s; nodata "
        f"stripe rows [0, {stripe})")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out = model.predict_cube_u16(X, nodata=SR_NODATA)
    torch.cuda.synchronize()
    del out
    times = []
    for i in range(N_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = model.predict_cube_u16(X, nodata=SR_NODATA)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1000.0)
        if i < N_RUNS - 1:
            del out
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    med = statistics.median(times)
    log(f"SR main path runs (s): {[round(t, 5) for t in times]}; median "
        f"{med:.5f} s, {n_px / med / 1e6:.1f} Mpx/s; peak memory "
        f"{peak_gb:.2f} GB; launches {counts}")
    expect = (SR_BY,) + SR_SHAPE[1:]
    if tuple(out.shape) != expect or out.dtype != torch.uint16:
        fail(f"SR product {tuple(out.shape)} {out.dtype}, expected {expect} "
             f"uint16")
    if counts.get(KERNEL_NAME, 0) != N_RUNS + 1:
        fail(f"{KERNEL_NAME} launched {counts.get(KERNEL_NAME, 0)} times in "
             f"{N_RUNS + 1} runs of the SR main path")
    for band in out:
        nod = band.to(torch.int32) == 65535
        if not (bool(nod[:stripe].all()) and not bool(nod[stripe:].any())):
            fail("the SR product's 65535 pixels are not exactly the stripe")
    log(f"SR product: {expect} uint16, 65535 exactly on the stripe")

    X2 = X.reshape(SR_BX, n_px)
    args = (model.x_mean, model.x_std, model.W, model.intercept,
            model.factors)
    want = sr_predict_u16_reference(X2, *args, nodata=SR_NODATA)
    same, steps, n_diff = u16_compare(out.reshape(SR_BY, n_px), want)
    log(f"SR full scale kernel vs plain: mask identical {same}, max |dq| "
        f"{steps}, {n_diff} of {want.numel()} elements differ")
    if not (same and steps <= SR_STEPS_TOL):
        fail("SR kernel disagrees with its plain version at full scale")
    worst = max(worst, steps)
    del out, want
    ms = cuda_ms(lambda: sr_predict_u16(X2, *args, nodata=SR_NODATA), 5)
    plain_ms = cuda_ms(lambda: sr_predict_u16_reference(
        X2, *args, nodata=SR_NODATA), 1)
    log(f"SR kernel at {SR_SHAPE} -> {expect}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms")
    return {"name": KERNEL_NAME, "route": "cuda", "source": SR_SOURCE,
            "replaces": SR_REPLACES, "launches": counts[KERNEL_NAME],
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def build_plan(scene: dict, device, **kw):
    from hyperres_torch.fusion.fused import FusedOrthoFusionPlan
    from hyperres_torch.spectral.srf_tables import builtin_srf

    raw_h, raw_w = scene["raw"].shape[:2]
    return FusedOrthoFusionPlan(
        scene["ortho_grid"], scene["utm60"], scene["s2_grid"],
        (raw_h, raw_w), scene["glt"], scene["wavelengths"],
        scene["good_mask"], s2_nodata=65535.0, s2_scale=1e-4,
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), device=device,
        **kw)


def run_plan(plan, raw, s2, label: str):
    """Counts set to 0, one warm-up call and N_RUNS calls under CUDA
    events, counts read. Returns (last output, run seconds, counts)."""
    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats(raw.device)
    reset_launch_counts()
    out = plan(raw, s2, generator=plan.generator(0))
    torch.cuda.synchronize()
    del out
    times = []
    for i in range(N_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plan(raw, s2, generator=plan.generator(i + 1))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1000.0)
        if i < N_RUNS - 1:
            del out
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(raw.device) / 1e9
    log(f"{label} runs (s): {[round(t, 4) for t in times]}; median "
        f"{statistics.median(times):.4f} s; peak memory {peak_gb:.2f} GB")
    utm_shape = tuple(out["utm_cube"].shape)
    fused_shape = tuple(out["fused_10m"].shape)
    log(f"{label}: utm_cube {utm_shape}, fused_10m {fused_shape}, "
        f"launches {counts}")
    if utm_shape != EXPECT_UTM or fused_shape != EXPECT_FUSED:
        fail(f"{label}: shapes {utm_shape} / {fused_shape}, expected "
             f"{EXPECT_UTM} / {EXPECT_FUSED}")
    return out, times, counts


def check_gates(plan, out, s2, label: str, method: str = "ot_poly",
                gated: bool = True) -> None:
    """Phase 5's accuracy metrics of one plan output; ``gated`` fails
    below bench.py's gates, otherwise only finite fraction and max are
    checked (bench.py gates no other method than ot_poly)."""
    target = plan.s2_reference_10m(out["utm_cube"], s2)
    finite_frac, fmax, psnr_db, method_psnr_db, sam_rad = accuracy_metrics(
        out["fused_10m"], target, out["coeffs"], method)
    log(f"{label} accuracy: pipeline PSNR {psnr_db:.3f} dB, SAM "
        f"{sam_rad:.6f} rad, method PSNR {method_psnr_db:.3f} dB, finite "
        f"frac {finite_frac:.4f}, max {fmax:.4f}; n_valid_60m "
        f"{int(out['n_valid_60m'])}; coeffs "
        f"{np.round(out['coeffs'].cpu().numpy(), 4).tolist()}")
    ok = finite_frac > GATES["finite_frac_min"] and fmax <= GATES["max_le"]
    if gated:
        ok = (ok and psnr_db >= GATES["psnr_db_min"]
              and sam_rad <= GATES["sam_rad_max"]
              and method_psnr_db >= GATES["method_psnr_db_min"])
    if not ok:
        fail(f"{label}: accuracy gates {GATES} not met")


def sinkhorn_phase(Xs, wxs, Ys, wys, ot) -> dict:
    """Phase 5b (see the module docstring) on the OT stage's samples.
    Returns the kernel's entry of the kernels line."""
    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.sinkhorn import (
        marginal, ot_barycentric_targets, sqeuclidean_cdist,
    )
    from hyperres_torch.kernels.sinkhorn_duals import (
        KERNEL_NAME, sinkhorn_duals, sinkhorn_duals_reference,
    )

    n, m = Xs.shape[0], Ys.shape[0]
    la = torch.log(marginal(wxs, n, Xs.device))
    lb = torch.log(marginal(wys, m, Ys.device))
    Mr = -sqeuclidean_cdist(Xs, Ys) / ot.reg
    log(f"Sinkhorn: {n} x {m} samples ({int(wxs.sum())} / {int(wys.sum())} "
        f"real), reg {ot.reg}, num_itermax {ot.num_itermax}, stop_thr "
        f"{ot.stop_thr}")

    def err_close(kerr, perr) -> bool:
        kerr, perr = float(kerr), float(perr)
        return abs(kerr - perr) <= (SINKHORN_ERR_RTOL * max(kerr, perr)
                                    + SINKHORN_ERR_ATOL)

    # kernel vs plain at a fixed sweep count
    fixed = (ot.num_itermax, 0.0)
    f, g, err = sinkhorn_duals(la, lb, Mr, *fixed)
    f2, g2, _ = sinkhorn_duals(la, lb, Mr, *fixed)
    rf, rg, rerr = sinkhorn_duals_reference(la, lb, Mr, *fixed)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    p_max = float(P.max())
    p_err = float((P - torch.exp(Mr + rf[:, None] + rg[None, :]))
                  .abs().max())
    del P
    fg_err = max(float((f - rf).abs().max()), float((g - rg).abs().max()))
    same = bool(torch.equal(f, f2) and torch.equal(g, g2))
    log(f"Sinkhorn {fixed[0]} sweeps, kernel vs plain: P max abs err "
        f"{p_err:.3e} = {p_err / p_max:.3e} of P max {p_max:.3e} (tol "
        f"{SINKHORN_P_RTOL:g}); f, g max abs err {fg_err:.3e} (tol "
        f"{SINKHORN_FG_TOL:g}; max |f| {float(f.abs().max()):.3f}, max |g| "
        f"{float(g.abs().max()):.3f}); err {float(err):.3e} / "
        f"{float(rerr):.3e}; two kernel runs bit-equal {same}")
    if not (p_err <= SINKHORN_P_RTOL * p_max and fg_err <= SINKHORN_FG_TOL
            and err_close(err, rerr) and same):
        fail("sinkhorn_duals disagrees with its plain version")
    ms_fixed = cuda_ms(lambda: sinkhorn_duals(la, lb, Mr, *fixed), 3)
    plain_fixed = cuda_ms(lambda: sinkhorn_duals_reference(la, lb, Mr,
                                                           *fixed), 1)
    log(f"Sinkhorn per sweep: kernel {ms_fixed / fixed[0] * 1e3:.2f} us, "
        f"plain {plain_fixed / fixed[0] * 1e3:.2f} us")

    # the config's stop rule
    rule = (ot.num_itermax, ot.stop_thr)
    *_, kerr, ksw = sinkhorn_duals(la, lb, Mr, *rule, return_sweeps=True)
    *_, perr, psw = sinkhorn_duals_reference(la, lb, Mr, *rule,
                                             return_sweeps=True)
    ms = cuda_ms(lambda: sinkhorn_duals(la, lb, Mr, *rule), 5)
    plain_ms = cuda_ms(lambda: sinkhorn_duals_reference(la, lb, Mr, *rule),
                       2)
    log(f"Sinkhorn stop rule: kernel {ksw} sweeps, err {float(kerr):.3e}, "
        f"{ms:.3f} ms; plain {psw} sweeps, err {float(perr):.3e}, "
        f"{plain_ms:.3f} ms")
    if not (ksw == psw and err_close(kerr, perr)):
        fail("under the stop rule sinkhorn_duals stops at another sweep "
             "or err than its plain version")

    # the engines: the main path of this phase first
    kw = dict(reg=ot.reg, wx=wxs, wy=wys)
    reset_launch_counts()
    t_rule = ot_barycentric_targets(Xs, Ys, num_itermax=ot.num_itermax,
                                    stop_thr=ot.stop_thr, engine="pallas",
                                    **kw)
    torch.cuda.synchronize()
    launches = launch_counts.get(KERNEL_NAME, 0)
    log(f"ot_barycentric_targets(engine='pallas'): launches {launches}")
    if launches < 1:
        fail(f"{KERNEL_NAME} did not launch in the engine='pallas' run")
    x_rule = ot_barycentric_targets(Xs, Ys, num_itermax=ot.num_itermax,
                                    stop_thr=ot.stop_thr, engine="xla", **kw)
    eng = [ot_barycentric_targets(Xs, Ys, num_itermax=fixed[0],
                                  stop_thr=0.0, engine=e, **kw)
           for e in ("pallas", "xla")]
    eng_err = float((eng[0] - eng[1]).abs().max())
    rule_diff = float((t_rule - x_rule).abs().max())
    log(f"engines at {fixed[0]} sweeps each: targets max abs diff "
        f"{eng_err:.3e} (tol {ENGINE_TOL:g}); with the stop rule (row vs "
        f"column marginal): {rule_diff:.3e}")
    if not eng_err <= ENGINE_TOL:
        fail("engine='pallas' and engine='xla' targets disagree")
    e_ms = {e: cuda_ms(lambda: ot_barycentric_targets(
        Xs, Ys, num_itermax=ot.num_itermax, stop_thr=ot.stop_thr, engine=e,
        **kw), 3) for e in ("pallas", "xla")}
    log(f"ot_barycentric_targets with the stop rule: engine='pallas' "
        f"{e_ms['pallas']:.3f} ms, engine='xla' {e_ms['xla']:.3f} ms")
    return {"name": KERNEL_NAME, "route": "cuda", "source": SINKHORN_SOURCE,
            "replaces": SINKHORN_REPLACES, "launches": launches,
            "max_abs_err": p_err, "ms": ms, "plain_ms": plain_ms}


def main() -> None:
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    from hyperres_torch.kernels import _build
    from hyperres_torch.kernels.banded import DENSE_KERNEL_NAME
    from hyperres_torch.kernels.warp import orthowarp_src_ext
    from hyperres_torch.testing.bench_scene import generate_scene

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_libraries(["scanline_warp", "sr_predict", "sinkhorn_duals"])
    log(f"build: all kernels in {time.perf_counter() - t0:.3f} s")
    for name, info in _build.build_info.items():
        log(f"build: {name}: nvcc {info['seconds']:.3f} s")
        log(info["ptxas"])

    # -- 3. kernel vs plain at the scale-0.25 bench scene ------------------
    worst = {}
    t0 = time.perf_counter()
    small = generate_scene(CHECK_SCALE, 0)
    plan = build_plan(small, dev)
    src_ext = orthowarp_src_ext(
        torch.from_numpy(small["raw"]).to(dev), plan._flat_idx, plan._valid)
    for method in ("cubic", "bilinear"):
        res = compare_passes(src_ext, plan._cstar, plan._wr, method,
                             timed=False)
        res[DENSE_KERNEL_NAME] = compare_dense(src_ext, plan._cstar,
                                               plan._wr, method, timed=False)
        for name, r in res.items():
            log(f"check scale {CHECK_SCALE} {method} {name}: max abs err "
                f"{r['max_abs_err']:.3e} (tol {KERNEL_TOL:g}), src "
                f"{tuple(src_ext.shape)}")
            worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
    del src_ext, plan, small
    log(f"kernel check done in {time.perf_counter() - t0:.1f} s")

    # -- 4. main path at full scale ------------------------------------------
    t0 = time.perf_counter()
    scene = generate_scene(MAIN_SCALE, 0)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(scene, dev)
    t_plan = time.perf_counter() - t0
    raw = torch.from_numpy(scene["raw"]).to(dev)
    s2 = plan.prepare_s2(scene["s2_dn"])
    torch.cuda.synchronize()
    log(f"scene (scale {MAIN_SCALE}) generated in {t_scene:.1f} s, plan "
        f"built in {t_plan:.1f} s; raw {tuple(raw.shape)}, UTM grid "
        f"{scene['utm60'].height}x{scene['utm60'].width}, 10 m grid "
        f"{scene['s2_grid'].height}x{scene['s2_grid'].width}")
    out, _, counts = run_plan(plan, raw, s2, "main path")
    for name in REPLACES:
        if counts.get(name, 0) != N_RUNS + 1:
            fail(f"{name} launched {counts.get(name, 0)} times in "
                 f"{N_RUNS + 1} runs of the main path")

    # -- 5. accuracy gates -------------------------------------------------
    check_gates(plan, out, s2, "main path")
    base_utm = out["utm_cube"]
    del out

    # kernel vs plain at the main path's shapes (full scale, cubic)
    src_ext = orthowarp_src_ext(raw, plan._flat_idx, plan._valid)
    full = compare_passes(src_ext, plan._cstar, plan._wr, "cubic",
                          timed=True)
    del src_ext
    kernels = []
    for name, r in full.items():
        err = max(worst[name], r["max_abs_err"])
        log(f"full scale cubic {name}: max abs err {r['max_abs_err']:.3e}; "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
        if not err <= KERNEL_TOL:
            fail(f"{name} disagrees with its plain version: {err:.3e}")
        kernels.append({
            "name": name, "route": "cuda", "source": SCANLINE_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"]})

    # -- 5a. the warp_kernel="pallas" plan: the dense route ---------------
    dplan = build_plan(scene, dev, warp_kernel="pallas")
    log(f"(the next peak includes the default plan's utm_cube, "
        f"{base_utm.numel() * 4 / 1e9:.2f} GB, held for the comparison)")
    out, _, counts = run_plan(dplan, raw, s2, "warp_kernel='pallas' plan")
    if counts.get(DENSE_KERNEL_NAME, 0) != 2 * (N_RUNS + 1):
        fail(f"{DENSE_KERNEL_NAME} launched "
             f"{counts.get(DENSE_KERNEL_NAME, 0)} times in {N_RUNS + 1} "
             f"runs of the warp_kernel='pallas' plan")
    check_gates(dplan, out, s2, "warp_kernel='pallas' plan")
    same_fill = bool(torch.equal(out["utm_cube"] == -9999.0,
                                 base_utm == -9999.0))
    utm_err = float((out["utm_cube"] - base_utm).abs().max())
    log(f"warp_kernel='pallas' utm_cube vs the default plan's: max abs err "
        f"{utm_err:.3e} (tol {KERNEL_TOL:g}), same fill pixels {same_fill}")
    if not (same_fill and utm_err <= KERNEL_TOL):
        fail("the dense route's utm_cube differs from the banded route's")
    del out, base_utm, dplan
    src_ext = orthowarp_src_ext(raw, plan._flat_idx, plan._valid)
    dense = compare_dense(src_ext, plan._cstar, plan._wr, "cubic",
                          timed=True)
    del src_ext
    err = max(worst[DENSE_KERNEL_NAME], dense["max_abs_err"])
    log(f"full scale cubic {DENSE_KERNEL_NAME}: max abs err "
        f"{dense['max_abs_err']:.3e}; pass 1 kernel {dense['pass1_ms']:.3f} "
        f"ms, plain {dense['pass1_plain_ms']:.3f} ms; pass 2 kernel "
        f"{dense['pass2_ms']:.3f} ms, plain {dense['pass2_plain_ms']:.3f} ms")
    if not err <= KERNEL_TOL:
        fail(f"{DENSE_KERNEL_NAME} disagrees with its plain version: "
             f"{err:.3e}")
    kernels.append({
        "name": DENSE_KERNEL_NAME, "route": "cuda", "source": SCANLINE_SOURCE,
        "replaces": DENSE_REPLACES,
        "launches": counts[DENSE_KERNEL_NAME], "max_abs_err": err,
        "ms": dense["pass1_ms"] + dense["pass2_ms"],
        "plain_ms": dense["pass1_plain_ms"] + dense["pass2_plain_ms"]})

    # -- 5b. Sinkhorn at 5000 x 5000 on the plan's OT samples ------------
    utm_cube = plan.warp(raw)
    samples = plan.ot_samples(utm_cube, s2, plan.generator(0))
    kernels.append(sinkhorn_phase(*samples, plan.statics.ot))
    del samples, utm_cube

    # -- 5c. the ot_affine plan --------------------------------------------
    aplan = build_plan(scene, dev, fusion_method="ot_affine")
    out, _, _ = run_plan(aplan, raw, s2, "ot_affine plan")
    check_gates(aplan, out, s2, "ot_affine plan", method="ot_affine",
                gated=False)
    if tuple(out["coeffs"].shape) != (4, 3):
        fail(f"ot_affine params {tuple(out['coeffs'].shape)}, expected (4, 3)")
    del out, aplan, raw, s2, plan, scene
    torch.cuda.empty_cache()

    kernels.append(sr_phases(dev))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

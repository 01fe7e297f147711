#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device: needs ``torch.cuda.is_available()``; prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the scanline-warp kernel (``csrc/scanline_warp.cu``)
   with nvcc for sm_90a and prints the build time and ptxas report.
3. Kernel vs plain: both passes of the kernel against their plain
   PyTorch version on the scale-0.25 bench scene's warp operands, cubic
   and bilinear, within KERNEL_TOL.
4. Main path: generates the full-scale (1.0) bench scene, builds the
   port's ``FusedOrthoFusionPlan`` on the card, runs it once to warm up
   and N_RUNS times under CUDA events, checks the output shapes and that
   every run launched each pass of the kernel once. Then times the
   kernel against its plain version at the main path's shapes.
5. Accuracy gates of ``bench.py`` against the plan's own
   ``s2_reference_10m``: finite fraction > 0.3, max <= 1, pipeline PSNR
   >= 45 dB, SAM <= 0.01 rad, method PSNR >= 28 dB.

Prints the kernels' JSON line, then as its last line
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


def accuracy_metrics(fused, target, coeffs):
    """bench.py's gates (bench.py:351-372): finite fraction, max, the
    pipeline PSNR (fused vs the fit applied to the target), the method
    PSNR (fused vs the target) and SAM, over the 2-px eroded interior of
    the jointly valid pixels."""
    import torch
    from hyperres_torch.kernels.lstsq import polyval_channels
    from hyperres_torch.kernels.stats import erode_mask

    vf = torch.isfinite(fused).all(dim=-1)
    valid = vf & torch.isfinite(target).all(dim=-1)
    e = erode_mask(valid, 2)
    n = torch.clamp(e.sum(), min=1)
    mapped = torch.clamp(polyval_channels(coeffs, torch.nan_to_num(target)),
                         0.0, 1.0)
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


def build_plan(scene: dict, device):
    from hyperres_torch.fusion.fused import FusedOrthoFusionPlan
    from hyperres_torch.spectral.srf_tables import builtin_srf

    raw_h, raw_w = scene["raw"].shape[:2]
    return FusedOrthoFusionPlan(
        scene["ortho_grid"], scene["utm60"], scene["s2_grid"],
        (raw_h, raw_w), scene["glt"], scene["wavelengths"],
        scene["good_mask"], s2_nodata=65535.0, s2_scale=1e-4,
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), device=device)


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

    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels import _build
    from hyperres_torch.kernels.warp import orthowarp_src_ext
    from hyperres_torch.testing.bench_scene import generate_scene

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library("scanline_warp")
    info = _build.build_info["scanline_warp"]
    log(f"build: scanline_warp in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {info['seconds']:.3f} s)")
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

    torch.cuda.reset_peak_memory_stats(dev)
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
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"main path runs (s): {[round(t, 4) for t in times]}; median "
        f"{statistics.median(times):.4f} s; peak memory {peak_gb:.2f} GB")
    utm_shape = tuple(out["utm_cube"].shape)
    fused_shape = tuple(out["fused_10m"].shape)
    log(f"utm_cube {utm_shape}, fused_10m {fused_shape}, launches {counts}")
    if utm_shape != EXPECT_UTM or fused_shape != EXPECT_FUSED:
        fail(f"shapes {utm_shape} / {fused_shape}, expected {EXPECT_UTM} "
             f"/ {EXPECT_FUSED}")
    for name in REPLACES:
        if counts.get(name, 0) != N_RUNS + 1:
            fail(f"{name} launched {counts.get(name, 0)} times in "
                 f"{N_RUNS + 1} runs of the main path")

    # -- 5. accuracy gates -------------------------------------------------
    target = plan.s2_reference_10m(out["utm_cube"], s2)
    finite_frac, fmax, psnr_db, method_psnr_db, sam_rad = accuracy_metrics(
        out["fused_10m"], target, out["coeffs"])
    log(f"accuracy: pipeline PSNR {psnr_db:.3f} dB, SAM {sam_rad:.6f} rad, "
        f"method PSNR {method_psnr_db:.3f} dB, finite frac "
        f"{finite_frac:.4f}, max {fmax:.4f}; n_valid_60m "
        f"{int(out['n_valid_60m'])}; coeffs "
        f"{np.round(out['coeffs'].cpu().numpy(), 4).tolist()}")
    ok = (finite_frac > GATES["finite_frac_min"] and fmax <= GATES["max_le"]
          and psnr_db >= GATES["psnr_db_min"]
          and sam_rad <= GATES["sam_rad_max"]
          and method_psnr_db >= GATES["method_psnr_db_min"])
    if not ok:
        fail(f"accuracy gates {GATES} not met")
    del out, target

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
            "name": name, "route": "cuda",
            "source": "hyperres_torch/csrc/scanline_warp.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

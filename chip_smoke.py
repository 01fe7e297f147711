#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device: needs ``torch.cuda.is_available()``; prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the five kernels (``csrc/scanline_warp.cu``,
   ``csrc/sr_predict.cu``, ``csrc/sinkhorn_duals.cu``,
   ``csrc/quantize_u16.cu``, ``csrc/srf_synthesize.cu``) with nvcc for
   sm_90a, one nvcc each, all started together, and prints the build
   times and ptxas reports.
2a. The ingest's two hazards: PREFETCH_CHUNKS seeded slabs go through
   ``PrefetchToDevice`` while the loader's side stream is held back
   before each copy (so copies are still queued when the next batch is
   pinned) and the consumer's stream is held back before it reads each
   slab; the consumer allocates and frees a slab-sized tensor between
   batches and drops each slab as soon as its read is queued. Every
   slab must arrive bit-equal to its host array: a pinned buffer freed
   before its copy, or a side-stream tensor not ``record_stream``'d (its
   memory handed to a later copy), would show as a differing slab.
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
   (the defaults), on the one-pass route: the duals kernel against its
   plain version at a fixed sweep count, P = exp(Mr + f + g) within
   SINKHORN_P_RTOL of its largest entry, f and g within
   SINKHORN_FG_TOL, err within SINKHORN_ERR_RTOL / _ATOL, two runs
   bit-equal, only the one-pass counter launched; with the config's
   stop rule, the same sweep count and err within the same bound; the
   same sweeps timed on the two-read kernels for comparison;
   ``ot_barycentric_targets(engine="pallas")``, whose run must launch
   the one-pass kernel and nothing else, against ``engine="xla"`` at an
   equal sweep count within ENGINE_TOL (with the stop rule the two
   engines stop on different marginals, and their difference is
   printed); both engines timed; the long-rows route's kernels timed on
   the same sweeps too. Then the long-rows route (column slices) at each
   of SINKHORN_LONG_ROWS_SHAPES (128 x 100,000 and 1024 x 20,000 seeded
   samples): ``ot_barycentric_targets(engine="pallas")`` must launch the
   long-rows kernels and nothing else, then the same checks (err's
   floor SINKHORN_LONG_ROWS_ERR_ATOL), and the two-read kernels timed on
   the same sweeps. The stop rule once more at 128 x 100,000 on the
   samples of SINKHORN_FRAGILE_SEED, whose err at a check lies ~1 % from
   ``stop_thr``: there the sweep counts of kernel and plain version may
   differ by one group of checks, and by no more (SINKHORN_STOP_MARGIN).
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
   layouts, By = 32 and By = 285, and on a 256 x 256 px cube for a
   degree-4 model (F = 1000, 16 bands per CTA): identical 65535 mask,
   <= SR_STEPS_TOL u16 steps; the row-major serving form timed at
   By = 285.
7a. The streamed SR route: a model whose W does not fit shared memory
   (12 bands at degree 4, F = 1819, 2080 K columns; fitted on seeded
   pixels) against the plain version at 256 x 256 px in both layouts;
   the product model forced onto the streamed route gives the resident
   route's codes bit for bit; ``predict_cube_u16`` on a (12, 1024, 1024)
   cube, once to warm up and N_RUNS times, must launch the streamed
   kernel each time and agree with the plain version; kernel and plain
   timed there. A model past the kernel's limits (18 bands, degree 2)
   runs through ``engine="auto"`` on the ``"xla"`` program, launches no
   kernel, agrees with the plain version, and raises under
   ``engine="pallas"``.
8. SR main path at full scale: ``predict_cube_u16`` on a (10, 9140,
   9309) cube with a nodata stripe over the first 5 % of rows, once to
   warm up and N_RUNS times under CUDA events; checks the (32, 9140,
   9309) u16 product, that the stripe and nothing else is 65535, that
   every run launched the kernel, and the kernel against its plain
   version at that shape; times both. The bound counts the contraction
   as SR_TC_TERMS TF32 products at the dense TF32 peak (f32 accuracy on
   the tensor cores); the f32 pipes' bound and the earlier SIMT f32
   kernel's time are printed beside it.
9. Ortho export path at full width: the port's ``make_scene`` writes an
   uncompressed 1242 x 1280 x 285 granule into a temporary directory;
   ``orthorectify_granule`` runs with ``OrthoConfig()`` (u16 streamed
   ingest, plus the LOC product) and again with ``ingest_transfer="f32"``
   (``overwrite=True``, same directory), onto a full S2 tile's grid.
   Each run must launch each scanline pass once per 32-band chunk (9)
   and the quantize kernel once per u16 product. The u16 run's decoded
   DATA GeoTIFF must equal the quantizer's plain version on its cube;
   the f32 fold must be bit-equal to one ``orthowarp_two_pass`` of the
   whole raw cube (read through the port's reader); the u16 cube must
   stay within CUBIC_ABS_GAIN * step_b / 2 + U16_INGEST_ATOL of the f32
   one where every tap is valid (the max elsewhere is printed). Prints
   each run's ``info["stages"]``, peak device memory and launches.
10. Quantize kernel vs plain on that UTM cube: the reflectance form
   (validity in the kernel, sentinel 65535), the Pallas form (scalar
   lo/hi, a mask) and per-band OBS-like p1/p99 ranges (sentinel 0): no
   code may differ. Kernel and plain timed in the reflectance form.
11. SRF synthesis: ``srf_synthesize_auto(use_pallas=True)`` on the UTM
   cube must launch the kernel; the kernel (tiled route) against its
   plain version at S = 13 (S2A) and S = 3 (B2, B3, B4) with the
   valid-pixel mask, within SRF_TOL and the fill exact, and so the
   file's earlier warp kernel forced onto the same rows; kernel, plain,
   ``torch.matmul`` and the warp kernel timed; the tiled kernel's
   shared-memory plan equal to the wrapper's mirror. Then seeded rows
   at shapes whose route the rule picks, one launch under that route's
   counter each: B = 401, S = 20 (tiled, 32-row tiles, two passes of 16
   output bands), B = 400, S = 20 (generic) and B = 244, S = 13 (warp,
   and the generic kernel forced onto the same rows), within
   SRF_WIDE_RTOL of the largest output.

Prints the kernels' JSON line (the two banded passes, the dense route,
``sinkhorn_duals`` (one pass), ``sinkhorn_duals_long_rows``,
``sr_predict_u16``, ``sr_predict_u16_streamed``, ``quantize_u16``,
``srf_synthesize``; each with its launches, error, times, its bound on
this card and a library call's time where one PyTorch call computes the
same function), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

T_START = time.perf_counter()

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
#: the ortho export path: an EMIT granule at its real raw size, every band
ORTHO_RAW = (1242, 1280)
ORTHO_BANDS = 285
#: the S2 stack that make_scene writes is not read on this path; the grid
#: passed instead is a full S2 tile (10980 px of 10 m, the stack's own
#: 60 m lattice) centred on the swath, so the UTM grid is the swath's
ORTHO_S2_SIZE = 600
S2_TILE_PX = 10980
#: the fold's chunks: ceil(285 / OrthoConfig().band_chunk)
ORTHO_CHUNKS = 9
#: the u16 ingest against the f32 one on pixels whose taps are all valid:
#: each raw value moves by at most half a step (vmax_b - vmin_b) / 65534,
#: and the two-pass cubic's weights sum in absolute value to at most 1.25
#: per pass
CUBIC_ABS_GAIN = 1.5625
U16_INGEST_ATOL = 1e-6
#: SRF kernel vs plain: the same f32 products summed in another order
SRF_TOL = 1e-5
REFL_HI_EFF = 6.5535        # export_reflectance_u16's hi for (0, 1) -> 0..10000
QUANT_NAME = "quantize_u16"
QUANT_SOURCE = "hyperres_torch/csrc/quantize_u16.cu"
QUANT_REPLACES = "hyperres/kernels/pallas_ops.py:122 (pallas_quantize_u16)"
SRF_SOURCE = "hyperres_torch/csrc/srf_synthesize.cu"
SRF_REPLACES = "hyperres/kernels/pallas_ops.py:70 (pallas_srf_synthesize)"
#: the ingest hazard stress: many small slabs; per batch the loader's side
#: stream is held back ~0.5 ms and the consumer's ~2 ms (torch.cuda._sleep
#: cycles at ~2 GHz), so the consumer's reads run far behind later copies
PREFETCH_CHUNKS = 96
PREFETCH_SLAB = (256, 256, 8)
PREFETCH_DEPTH = 3
PREFETCH_COPY_HOLD = 1_000_000
PREFETCH_READ_HOLD = 4_000_000
#: the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
#: bytes/s, float32 FLOP/s outside the tensor cores and dense TF32 FLOP/s
#: on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_TC_FLOPS = 495e12
#: the SR kernel's contraction at f32 accuracy on the tensor cores: three
#: TF32 products (A_hi B_hi + A_hi B_lo + A_lo B_hi)
SR_TC_TERMS = 3
#: the degree-4 check: F = 1000 monomials of 10 bands (1184 K columns,
#: 16 bands per CTA)
SR_DEG4_HW = (256, 256)
#: the earlier SIMT f32 SR kernel on an H100 80GB HBM3 at 700 W, for the
#: printout: the product and the row-major (1 M, 10) -> (1 M, 285) form
SR_SIMT_MS = {"product": 62.714, "rowmajor": 8.205}
#: the resident route at the product before the streamed route shared its
#: source (same card and power limit), for the printout
SR_RESIDENT_BEFORE_MS = 34.766
#: the long-rows Sinkhorn route's checks: columns past the one-pass limit,
#: inside the engine budget; few rows (the kernels line's entry) and more
SINKHORN_LONG_ROWS_SHAPES = ((128, 100_000), (1024, 20_000))
#: the samples' seed. Near convergence err falls ~10x per 10 sweeps down to
#: its rounding floor (~6e-7 at 128 x 100,000), so a check whose err lies
#: within that noise of stop_thr = 1e-6 can go either way in any two
#: versions of the arithmetic (seed 11: 0.99e-6 at sweep 50). With this
#: seed the plain version's err is 2.6e-6 at sweep 50 and 5.7e-7 at 60
#: (128 x 100,000), 3.1e-6 at 40 and 4.8e-7 at 50 (1024 x 20,000), so the
#: equal-sweep-count check tests the kernels, not the coincidence.
SINKHORN_LONG_ROWS_SEED = 14
#: the fragile case is kept as a check of its own at 128 x 100,000: with
#: seed 11 the stop rule may split by one group of sweeps, which
#: sinkhorn_stop_rule accepts only this close to stop_thr
SINKHORN_FRAGILE_SEED = 11
SINKHORN_CHECK_EVERY = 10
SINKHORN_STOP_MARGIN = 0.05
#: their err bound's floor: each row sums up to 100,000 exps, in slices,
#: so near convergence err is rounding noise of a few 1e-7 (measured on
#: an H100 at 300 sweeps at 128 x 100,000: 5.4e-7 kernel, 6.9e-7 plain)
SINKHORN_LONG_ROWS_ERR_ATOL = 3e-7
#: the streamed SR route: 12 bands at degree 4 (F = 1819, 2080 K columns),
#: checked at 256 x 256 px and run as a product at 1024 x 1024 px; the
#: model past the kernel's limits: 18 bands at degree 2
SR_STREAM_BX, SR_STREAM_DEGREE = 12, 4
SR_STREAM_HW = (1024, 1024)
SR_XLA_BX, SR_XLA_DEGREE = 18, 2
#: SRF on seeded rows in [0, 1), each shape on the route the rule gives
#: it: past the warp kernel's limits (tiled with 32-row tiles, generic) and
#: an even band count inside them (warp, with the generic kernel forced
#: onto the same rows for its time and check); tolerance relative to the
#: largest output (sums of up to 401 products, ~100)
SRF_WIDE_ROWS = 200_000
SRF_WIDE_SHAPES = ((401, 20, "tiled"), (400, 20, "generic"),
                   (244, 13, "warp"))
SRF_WIDE_RTOL = 3e-6


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


def bound(n_bytes: float, flops: float,
          peak_flops: float = PEAK_F32_FLOPS) -> dict:
    """The least time the card could take for work that moves ``n_bytes``
    and does ``flops`` operations at ``peak_flops`` (float32 outside the
    tensor cores by default): the larger of the two over the card's
    peaks, and which one it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak_flops
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scanline_bound(src, pos, out_shape) -> dict:
    """One scanline pass: its source and positions read once, its output
    written once; 4 taps (one FMA each) per output element."""
    n_out = float(np.prod(out_shape))
    return bound(4.0 * (src.numel() + pos.numel() + n_out), 8.0 * n_out)


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
            entry.update(scanline_bound(src, pos, got.shape))
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

    res, h = {"max_abs_err": 0.0, "bound_ms": 0.0}, None
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
            res["bound_ms"] += scanline_bound(src, pos, got.shape)["bound_ms"]
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


def sr_training_data(rng, n: int = 200_000, bx: int = SR_BX):
    """The SR bench's synthetic training pixels
    (scripts/bench_sr_granule.py:56-62), from ``bx`` bands."""
    X = rng.random((n, bx)).astype(np.float32)
    Y = np.clip(0.15 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2]
                + 0.05 * rng.random((n, SR_BY)), 0.01,
                0.99).astype(np.float32)
    return X, Y


def sr_bound(n_px: int, n_features: int, by: int,
             mask_bytes: float = 0.0, bx: int = SR_BX) -> dict:
    """The SR kernel's bound: per pixel ``bx`` f32 (and ``mask_bytes`` of
    mask) read and ``by`` u16 written; F monomials times ``by`` outputs,
    one multiply-add each, at f32 accuracy on the tensor cores (SR_TC_TERMS
    TF32 products at the dense TF32 peak). ``f32_ms``: the same
    operations on the f32 pipes, the bound of a kernel without tensor
    cores."""
    n_bytes = n_px * (4.0 * bx + mask_bytes + 2.0 * by)
    flops = 2.0 * n_features * by * n_px
    out = bound(n_bytes, SR_TC_TERMS * flops, PEAK_TF32_TC_FLOPS)
    out["f32_ms"] = bound(n_bytes, flops)["bound_ms"]
    return out


def sr_phases(dev) -> list:
    """Phases 6-8 (see the module docstring). Returns the SR kernel's
    entries of the kernels line: the resident and the streamed route."""
    import torch
    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.entry import entry
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
    from hyperres_torch.kernels import sr_predict as sp
    from hyperres_torch.kernels._build import load_library
    from hyperres_torch.kernels.sr_predict import (
        KERNEL_NAME, STREAMED_NAME, sr_k_columns, sr_predict_u16,
        sr_predict_u16_reference, sr_route, valid_pixels,
    )

    # -- 6. fit on the card, entry forward ---------------------------------
    rng = np.random.default_rng(0)
    Xt, Yt = sr_training_data(rng)
    cfg = RidgeSRConfig(degree=SR_DEGREE)
    t0 = time.perf_counter()
    model = RidgeSpectralSR(SR_BX, SR_BY, cfg, device=dev).fit(Xt, Yt)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    cpu_model = RidgeSpectralSR(SR_BX, SR_BY, cfg, device="cpu").fit(Xt, Yt)
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

    # -- 7. kernel vs plain at 1024 x 1024 px, both layouts, By 32 / 285;
    # degree 4 (F = 1000) at 256 x 256 px; the F limit ----------------------
    def route_in_source(k_cols: int, degree: int) -> tuple:
        """The route by the shared-memory plans of csrc/sr_predict.cu,
        which ``sr_route`` mirrors on the host."""
        lib = load_library("sr_predict")
        bands = lib.sr_predict_tile_bands(k_cols, degree)
        if bands:
            return sp.RESIDENT, bands
        if lib.sr_predict_streamed_fits(k_cols, degree):
            return sp.STREAMED, 32
        return None, 0

    def check_both_layouts(m, Xc) -> int:
        """The kernel against its plain version on the (Bx, N) cube Xc,
        which holds one NaN and one nodata pixel, in both layouts:
        identical 65535 mask (exactly those 2 pixels), <= SR_STEPS_TOL
        steps; the host's route rule equal to the source's plan. Returns
        the largest step."""
        args = (m.x_mean, m.x_std, m.W, m.intercept, m.factors)
        steps_max = 0
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
            k_cols = sr_k_columns(m.factors.cpu().numpy())
            if route_in_source(k_cols, m.cfg.degree) != sr_route(
                    k_cols, m.cfg.degree):
                fail(f"sr_route({k_cols}, {m.cfg.degree}) = "
                     f"{sr_route(k_cols, m.cfg.degree)}, but the kernel's "
                     f"source plans "
                     f"{route_in_source(k_cols, m.cfg.degree)}")
            log(f"check SR {layout} Bx={m.n_inputs} By={m.n_outputs} "
                f"degree {m.cfg.degree} F={m.n_features} ({k_cols} K "
                f"columns, route {sr_route(k_cols, m.cfg.degree)}), "
                f"{Xc.shape[1]} px: mask identical {same}, "
                f"max |dq| {steps} (tol {SR_STEPS_TOL}), {n_diff} of "
                f"{got.numel()} elements differ, {n_nodata // m.n_outputs} "
                f"nodata px")
            if not (same and steps <= SR_STEPS_TOL and
                    n_nodata == 2 * m.n_outputs):
                fail(f"SR kernel disagrees with its plain version "
                     f"({layout}, By={m.n_outputs}, F={m.n_features})")
            steps_max = max(steps_max, steps)
        return steps_max

    def check_cube(h, w, bx=SR_BX):
        cube = rng.random((bx, h, w)).astype(np.float32)
        cube[3, h // 10, w // 5] = np.nan
        cube[7, h // 2, w // 2] = SR_NODATA
        return torch.from_numpy(cube).to(dev).reshape(bx, h * w)

    h, w = SR_CHECK_HW
    Xc = check_cube(h, w)
    worst = max(check_both_layouts(m, Xc) for m in (model, fwd))
    deg4 = RidgeSpectralSR(SR_BX, SR_BY, RidgeSRConfig(degree=4),
                           device=dev).fit(Xt, Yt)
    worst = max(worst, check_both_layouts(deg4, check_cube(*SR_DEG4_HW)))
    del deg4

    # -- 7a. the streamed route; a model past the kernel's limits ----------
    Xb, Yb = sr_training_data(np.random.default_rng(3), 50_000, SR_STREAM_BX)
    big = RidgeSpectralSR(SR_STREAM_BX, SR_BY,
                          RidgeSRConfig(degree=SR_STREAM_DEGREE),
                          device=dev).fit(Xb, Yb)
    big_cols = sr_k_columns(big.factors.cpu().numpy())
    if sr_route(big_cols, SR_STREAM_DEGREE)[0] != sp.STREAMED:
        fail(f"F = {big.n_features} should take the streamed route")
    reset_launch_counts()
    worst_s = check_both_layouts(
        big, check_cube(*SR_DEG4_HW, bx=SR_STREAM_BX))
    if dict(launch_counts) != {STREAMED_NAME: 2}:
        fail(f"the F = {big.n_features} checks should launch the streamed "
             f"kernel alone: {dict(launch_counts)}")
    # both routes on the product model: the same codes
    args = (model.x_mean, model.x_std, model.W, model.intercept,
            model.factors)
    res_q = sr_predict_u16(Xc, *args, nodata=SR_NODATA)
    route_rule = sp.sr_route
    sp.sr_route = lambda k_cols, degree: (sp.STREAMED, 32)
    try:
        str_q = sr_predict_u16(Xc, *args, nodata=SR_NODATA)
    finally:
        sp.sr_route = route_rule
    n_route = n_differ(res_q, str_q)
    log(f"SR resident vs streamed route on the product model at {h * w} px: "
        f"{n_route} of {res_q.numel()} codes differ")
    if n_route:
        fail("the streamed SR route's codes differ from the resident route's")
    del res_q, str_q
    # its product: predict_cube_u16 at SR_STREAM_HW
    hs, ws = SR_STREAM_HW
    Xs = check_cube(hs, ws, bx=SR_STREAM_BX)
    cube_s = Xs.reshape(SR_STREAM_BX, hs, ws)
    reset_launch_counts()
    out = big.predict_cube_u16(cube_s, nodata=SR_NODATA)
    for _ in range(N_RUNS):
        out = big.predict_cube_u16(cube_s, nodata=SR_NODATA)
    torch.cuda.synchronize()
    counts_s = dict(launch_counts)
    if counts_s != {STREAMED_NAME: N_RUNS + 1} or big.last_engine != "pallas":
        fail(f"{STREAMED_NAME} alone should launch {N_RUNS + 1} times in "
             f"{N_RUNS + 1} products of the F = {big.n_features} model: "
             f"{counts_s}, engine {big.last_engine}")
    args_s = (big.x_mean, big.x_std, big.W, big.intercept, big.factors)
    want = sr_predict_u16_reference(Xs, *args_s, nodata=SR_NODATA)
    same, steps, n_diff = u16_compare(out.reshape(SR_BY, hs * ws), want)
    log(f"SR streamed product {tuple(cube_s.shape)} -> {tuple(out.shape)}: "
        f"mask identical {same}, max |dq| {steps}, {n_diff} of "
        f"{want.numel()} elements differ; launches {counts_s}")
    if not (same and steps <= SR_STEPS_TOL
            and tuple(out.shape) == (SR_BY, hs, ws)):
        fail("the streamed SR product disagrees with its plain version")
    worst_s = max(worst_s, steps)
    del out, want
    ms_s = cuda_ms(lambda: sr_predict_u16(Xs, *args_s, nodata=SR_NODATA), 10)
    plain_s = cuda_ms(lambda: sr_predict_u16_reference(
        Xs, *args_s, nodata=SR_NODATA), 2)
    work_s = sr_bound(hs * ws, big.n_features, SR_BY, bx=SR_STREAM_BX)
    f32_s = work_s.pop("f32_ms")
    log(f"SR streamed kernel at {tuple(cube_s.shape)}: kernel {ms_s:.3f} ms, "
        f"plain {plain_s:.3f} ms; bound {work_s['bound_ms']:.3f} ms "
        f"({work_s['bound_by']}), {work_s['bound_ms'] / ms_s:.1%} of it; "
        f"the f32 pipes' bound {f32_s:.3f} ms")
    streamed_entry = {
        "name": STREAMED_NAME, "route": "cuda", "source": SR_SOURCE,
        "replaces": SR_REPLACES, "launches": counts_s[STREAMED_NAME],
        "max_abs_err": worst_s, "ms": ms_s, "plain_ms": plain_s,
        "library_ms": None, **work_s}
    del big, Xs, cube_s
    # past the kernel's limits: engine="auto" is the "xla" program
    Xw, Yw = sr_training_data(np.random.default_rng(4), 50_000, SR_XLA_BX)
    wide = RidgeSpectralSR(SR_XLA_BX, SR_BY,
                           RidgeSRConfig(degree=SR_XLA_DEGREE),
                           device=dev).fit(Xw, Yw)
    Xx = check_cube(*SR_DEG4_HW, bx=SR_XLA_BX)
    reset_launch_counts()
    got = wide.predict_cube_u16(Xx.reshape(SR_XLA_BX, *SR_DEG4_HW),
                                nodata=SR_NODATA)
    want = sr_predict_u16_reference(Xx, wide.x_mean, wide.x_std, wide.W,
                                    wide.intercept, wide.factors,
                                    nodata=SR_NODATA)
    same, steps, n_diff = u16_compare(got.reshape(SR_BY, -1), want)
    log(f"SR Bx={SR_XLA_BX} degree {SR_XLA_DEGREE} (F = {wide.n_features}) "
        f"through engine='auto': engine {wide.last_engine}, launches "
        f"{dict(launch_counts)}; vs plain: mask identical {same}, max |dq| "
        f"{steps}, {n_diff} of {want.numel()} elements differ")
    if not (wide.last_engine == "xla" and not launch_counts and same
            and steps <= SR_STEPS_TOL):
        fail("engine='auto' past the kernel's limits should run the 'xla' "
             "program and agree with the plain version")
    try:
        wide.predict_cube_u16(Xx.reshape(SR_XLA_BX, *SR_DEG4_HW),
                              nodata=SR_NODATA, engine="pallas")
        fail(f"engine='pallas' took Bx = {SR_XLA_BX}")
    except ValueError as e:
        log(f"SR engine='pallas' at Bx = {SR_XLA_BX}: refused ({e})")
    del wide, Xx, got, want
    # the row-major serving form at By = 285, timed
    Xr = Xc.T.contiguous()
    kw = {"valid": valid_pixels(Xr, SR_NODATA), "layout": "rowmajor"}
    args = (fwd.x_mean, fwd.x_std, fwd.W, fwd.intercept, fwd.factors)
    row_ms = cuda_ms(lambda: sr_predict_u16(Xr, *args, **kw), 10)
    row_plain_ms = cuda_ms(lambda: sr_predict_u16_reference(Xr, *args, **kw),
                           2)
    row = sr_bound(h * w, fwd.n_features, fwd.n_outputs, mask_bytes=1.0)
    log(f"SR row-major form ({h * w}, {SR_BX}) -> ({h * w}, "
        f"{fwd.n_outputs}): kernel {row_ms:.3f} ms (the SIMT f32 kernel "
        f"took {SR_SIMT_MS['rowmajor']} ms), plain {row_plain_ms:.3f} ms, "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}; f32 pipes "
        f"{row['f32_ms']:.3f} ms)")
    del Xc, Xr, fwd, x, y

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
    work = sr_bound(n_px, model.n_features, SR_BY)
    f32_ms = work.pop("f32_ms")
    log(f"SR kernel at {SR_SHAPE} -> {expect}: kernel {ms:.3f} ms (the "
        f"SIMT f32 kernel took {SR_SIMT_MS['product']} ms; this route "
        f"before the streamed one was added {SR_RESIDENT_BEFORE_MS} ms), "
        f"plain "
        f"{plain_ms:.3f} ms; bound {work['bound_ms']:.3f} ms "
        f"({work['bound_by']}: {SR_TC_TERMS} TF32 products at "
        f"{PEAK_TF32_TC_FLOPS / 1e12:g} TFLOP/s), {work['bound_ms'] / ms:.1%} "
        f"of it; the f32 pipes' bound {f32_ms:.3f} ms")
    return [{"name": KERNEL_NAME, "route": "cuda", "source": SR_SOURCE,
             "replaces": SR_REPLACES, "launches": counts[KERNEL_NAME],
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "library_ms": None, **work}, streamed_entry]


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


def sinkhorn_bound(n: int, m: int, sweeps: int) -> dict:
    """``sweeps`` Sinkhorn sweeps on an (n, m) Mr. A sweep updates f over
    Mr's rows, then g over its columns. The function needs one read of Mr
    per sweep (a block can keep its rows on chip, take the row update and
    add its column partials in the same pass) plus the f, g, a, b
    vectors; ~6 operations per element and update."""
    per_sweep = bound(4.0 * n * m + 8.0 * (n + m), 12.0 * n * m)
    return {"bound_ms": per_sweep["bound_ms"] * sweeps,
            "bound_by": per_sweep["bound_by"]}


def sinkhorn_checks(la, lb, Mr, ot, name: str,
                    err_atol: float = SINKHORN_ERR_ATOL) -> dict:
    """The duals kernel of the route whose launch counter is ``name``
    against its plain version on one (n, m) Mr: at a fixed sweep count
    (``ot.num_itermax``), P = exp(Mr + f + g) within SINKHORN_P_RTOL of
    its largest entry, f and g within SINKHORN_FG_TOL, err within
    SINKHORN_ERR_RTOL / ``err_atol``, two kernel runs bit-equal, only
    ``name`` launched; then :func:`sinkhorn_stop_rule`. Returns P's error, the stop rule's sweeps and
    times (kernel and plain, fixed count and stop rule)."""
    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.sinkhorn_duals import (
        sinkhorn_duals, sinkhorn_duals_reference,
    )

    def err_close(kerr, perr) -> bool:
        kerr, perr = float(kerr), float(perr)
        return abs(kerr - perr) <= (SINKHORN_ERR_RTOL * max(kerr, perr)
                                    + err_atol)

    n, m = Mr.shape
    fixed = (ot.num_itermax, 0.0)
    reset_launch_counts()
    f, g, err = sinkhorn_duals(la, lb, Mr, *fixed)
    f2, g2, _ = sinkhorn_duals(la, lb, Mr, *fixed)
    counts = dict(launch_counts)
    rf, rg, rerr = sinkhorn_duals_reference(la, lb, Mr, *fixed)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    p_max = float(P.max())
    p_err = float((P - torch.exp(Mr + rf[:, None] + rg[None, :]))
                  .abs().max())
    del P
    fg_err = max(float((f - rf).abs().max()), float((g - rg).abs().max()))
    same = bool(torch.equal(f, f2) and torch.equal(g, g2))
    log(f"Sinkhorn {n} x {m}, {fixed[0]} sweeps, kernel vs plain: P max abs "
        f"err {p_err:.3e} = {p_err / p_max:.3e} of P max {p_max:.3e} (tol "
        f"{SINKHORN_P_RTOL:g}); f, g max abs err {fg_err:.3e} (tol "
        f"{SINKHORN_FG_TOL:g}; max |f| {float(f.abs().max()):.3f}, max |g| "
        f"{float(g.abs().max()):.3f}); err {float(err):.3e} / "
        f"{float(rerr):.3e}; two kernel runs bit-equal {same}; launches "
        f"{counts}")
    if set(counts) != {name}:
        fail(f"Sinkhorn {n} x {m} took another route than {name}: {counts}")
    if not (p_err <= SINKHORN_P_RTOL * p_max and fg_err <= SINKHORN_FG_TOL
            and err_close(err, rerr) and same):
        fail(f"{name} disagrees with its plain version")
    ms_fixed = cuda_ms(lambda: sinkhorn_duals(la, lb, Mr, *fixed), 3)
    plain_fixed = cuda_ms(lambda: sinkhorn_duals_reference(la, lb, Mr,
                                                           *fixed), 1)
    log(f"Sinkhorn {n} x {m} per sweep: kernel "
        f"{ms_fixed / fixed[0] * 1e3:.2f} us, plain "
        f"{plain_fixed / fixed[0] * 1e3:.2f} us, bound "
        f"{sinkhorn_bound(n, m, 1)['bound_ms'] * 1e3:.2f} us")

    stop = sinkhorn_stop_rule(la, lb, Mr, ot, name, err_atol)
    return {"p_err": p_err, "ms_fixed": ms_fixed, **stop}


def sinkhorn_stop_rule(la, lb, Mr, ot, name: str,
                       err_atol: float = SINKHORN_ERR_ATOL) -> dict:
    """The route ``name`` against its plain version under the config's
    stop rule: the same sweep count, and err within SINKHORN_ERR_RTOL /
    ``err_atol``. The counts may differ by one group of
    SINKHORN_CHECK_EVERY sweeps only where the plain version's err at the
    earlier of the two checks lies within SINKHORN_STOP_MARGIN of
    ``stop_thr`` (two versions of the arithmetic then fall on either
    side of it); the errs are then compared at the later count. Returns
    the kernel's sweeps and both times."""
    from hyperres_torch.kernels.sinkhorn_duals import (
        sinkhorn_duals, sinkhorn_duals_reference,
    )

    n, m = Mr.shape
    every = SINKHORN_CHECK_EVERY
    rule = (ot.num_itermax, ot.stop_thr, every)
    *_, kerr, ksw = sinkhorn_duals(la, lb, Mr, *rule, return_sweeps=True)
    *_, perr, psw = sinkhorn_duals_reference(la, lb, Mr, *rule,
                                             return_sweeps=True)
    ms = cuda_ms(lambda: sinkhorn_duals(la, lb, Mr, *rule), 5)
    plain_ms = cuda_ms(lambda: sinkhorn_duals_reference(la, lb, Mr, *rule),
                       2)
    log(f"Sinkhorn {n} x {m} stop rule: kernel {ksw} sweeps, err "
        f"{float(kerr):.3e}, {ms:.3f} ms = {ms / ksw * 1e3:.2f} us per "
        f"sweep; plain {psw} sweeps, err {float(perr):.3e}, "
        f"{plain_ms:.3f} ms")
    if ksw != psw:
        early, late = sorted((ksw, psw))
        *_, at_early = sinkhorn_duals_reference(la, lb, Mr, early, 0.0, every)
        off = abs(float(at_early) - ot.stop_thr) / ot.stop_thr
        log(f"Sinkhorn {n} x {m}: the sweep counts differ; the plain "
            f"version's err at sweep {early} is {float(at_early):.4e}, "
            f"{off:.2%} from stop_thr {ot.stop_thr:g} (margin "
            f"{SINKHORN_STOP_MARGIN:.0%})")
        if late - early != every or off > SINKHORN_STOP_MARGIN:
            fail(f"under the stop rule {name} stops at another sweep than "
                 f"its plain version, away from the threshold")
        *_, kerr = sinkhorn_duals(la, lb, Mr, late, 0.0, every)
        *_, perr = sinkhorn_duals_reference(la, lb, Mr, late, 0.0, every)
    kerr, perr = float(kerr), float(perr)
    if abs(kerr - perr) > SINKHORN_ERR_RTOL * max(kerr, perr) + err_atol:
        fail(f"under the stop rule {name}'s err {kerr:.3e} is not its plain "
             f"version's {perr:.3e} at the same sweep")
    return {"sweeps": ksw, "ms": ms, "plain_ms": plain_ms}


def other_routes_us(sd, la, lb, Mr, sweeps: int, routes) -> dict:
    """us per sweep of ``sweeps`` fixed sweeps on each of ``routes``, forced
    by a stand-in route rule (the rule itself is not changed)."""
    rule = sd.sinkhorn_route
    out = {}
    try:
        for name in routes:
            sd.sinkhorn_route = lambda *shape, name=name: sd.Route(name)
            out[name] = cuda_ms(lambda: sd.sinkhorn_duals(
                la, lb, Mr, sweeps, 0.0), 3) / sweeps * 1e3
    finally:
        sd.sinkhorn_route = rule
    return out


def sinkhorn_phase(Xs, wxs, Ys, wys, ot) -> dict:
    """Phase 5b (see the module docstring) on the OT stage's samples.
    Returns the one-pass kernel's entry of the kernels line."""
    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels import sinkhorn_duals as sd
    from hyperres_torch.kernels.sinkhorn import (
        marginal, ot_barycentric_targets, sqeuclidean_cdist,
    )

    n, m = Xs.shape[0], Ys.shape[0]
    la = torch.log(marginal(wxs, n, Xs.device))
    lb = torch.log(marginal(wys, m, Ys.device))
    Mr = -sqeuclidean_cdist(Xs, Ys) / ot.reg
    log(f"Sinkhorn: {n} x {m} samples ({int(wxs.sum())} / {int(wys.sum())} "
        f"real), reg {ot.reg}, num_itermax {ot.num_itermax}, stop_thr "
        f"{ot.stop_thr}")
    res = sinkhorn_checks(la, lb, Mr, ot, sd.KERNEL_NAME)
    # the same sweeps on the two-read kernels and on the long-rows route's
    # (forced by a stand-in route rule), timed in this process for the
    # comparison
    other = other_routes_us(sd, la, lb, Mr, ot.num_itermax,
                            (sd.TWO_READ, sd.LONG_ROWS))
    log(f"Sinkhorn {n} x {m} per sweep on the two-read kernels: "
        f"{other[sd.TWO_READ]:.2f} us, on the long-rows route's: "
        f"{other[sd.LONG_ROWS]:.2f} us (one pass "
        f"{res['ms_fixed'] / ot.num_itermax * 1e3:.2f} us)")

    # the engines: the main path of this phase first
    kw = dict(reg=ot.reg, wx=wxs, wy=wys)
    reset_launch_counts()
    t_rule = ot_barycentric_targets(Xs, Ys, num_itermax=ot.num_itermax,
                                    stop_thr=ot.stop_thr, engine="pallas",
                                    **kw)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    launches = counts.get(sd.KERNEL_NAME, 0)
    log(f"ot_barycentric_targets(engine='pallas'): launches {counts}")
    if launches < 1 or set(counts) != {sd.KERNEL_NAME}:
        fail(f"{sd.KERNEL_NAME} alone should launch in the engine='pallas' "
             f"run: {counts}")
    x_rule = ot_barycentric_targets(Xs, Ys, num_itermax=ot.num_itermax,
                                    stop_thr=ot.stop_thr, engine="xla", **kw)
    eng = [ot_barycentric_targets(Xs, Ys, num_itermax=ot.num_itermax,
                                  stop_thr=0.0, engine=e, **kw)
           for e in ("pallas", "xla")]
    eng_err = float((eng[0] - eng[1]).abs().max())
    rule_diff = float((t_rule - x_rule).abs().max())
    log(f"engines at {ot.num_itermax} sweeps each: targets max abs diff "
        f"{eng_err:.3e} (tol {ENGINE_TOL:g}); with the stop rule (row vs "
        f"column marginal): {rule_diff:.3e}")
    if not eng_err <= ENGINE_TOL:
        fail("engine='pallas' and engine='xla' targets disagree")
    e_ms = {e: cuda_ms(lambda: ot_barycentric_targets(
        Xs, Ys, num_itermax=ot.num_itermax, stop_thr=ot.stop_thr, engine=e,
        **kw), 3) for e in ("pallas", "xla")}
    log(f"ot_barycentric_targets with the stop rule: engine='pallas' "
        f"{e_ms['pallas']:.3f} ms, engine='xla' {e_ms['xla']:.3f} ms")
    return {"name": sd.KERNEL_NAME, "route": "cuda",
            "source": SINKHORN_SOURCE, "replaces": SINKHORN_REPLACES,
            "launches": launches, "max_abs_err": res["p_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            **sinkhorn_bound(n, m, res["sweeps"]), "library_ms": None}


def long_rows_samples(dev, n: int, m: int, seed: int) -> tuple:
    """Seeded RGB samples in [0, 1): (n, 3) and (m, 3) on ``dev``."""
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random((k, 3), dtype=np.float32))
                 .to(dev) for k in (n, m))


def sinkhorn_fragile_stop(dev, ot) -> None:
    """The long-rows route's stop rule where it is fragile: the first of
    SINKHORN_LONG_ROWS_SHAPES with SINKHORN_FRAGILE_SEED, whose err at
    sweep 50 lies ~1 % under stop_thr in the plain version.
    :func:`sinkhorn_stop_rule` must hold there too; its us per sweep is
    the number to set beside earlier readings of this input."""
    import torch
    from hyperres_torch.kernels.sinkhorn import marginal, sqeuclidean_cdist
    from hyperres_torch.kernels.sinkhorn_duals import LONG_ROWS_NAME

    n, m = SINKHORN_LONG_ROWS_SHAPES[0]
    Xs, Ys = long_rows_samples(dev, n, m, SINKHORN_FRAGILE_SEED)
    la = torch.log(marginal(None, n, dev))
    lb = torch.log(marginal(None, m, dev))
    Mr = -sqeuclidean_cdist(Xs, Ys) / ot.reg
    log(f"Sinkhorn {n} x {m}, seed {SINKHORN_FRAGILE_SEED} (err near "
        f"stop_thr at a check):")
    sinkhorn_stop_rule(la, lb, Mr, ot, LONG_ROWS_NAME,
                       SINKHORN_LONG_ROWS_ERR_ATOL)


def sinkhorn_long_rows_phase(dev, ot, n: int, m: int) -> dict:
    """Phase 5b's long-rows route at n x m: seeded RGB samples in [0, 1),
    uniform marginals, the plan's ``OTConfig``;
    ``ot_barycentric_targets(engine="pallas")`` must launch the long-rows
    kernels and nothing else, then the checks of
    :func:`sinkhorn_checks`, and the two-read kernels timed on the same
    sweeps. Returns the route's entry of the kernels line."""
    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.sinkhorn import (
        marginal, ot_barycentric_targets, sqeuclidean_cdist,
    )
    from hyperres_torch.kernels import sinkhorn_duals as sd
    from hyperres_torch.kernels.sinkhorn_duals import LONG_ROWS_NAME

    Xs, Ys = long_rows_samples(dev, n, m, SINKHORN_LONG_ROWS_SEED)
    reset_launch_counts()
    targets = ot_barycentric_targets(Xs, Ys, reg=ot.reg,
                                     num_itermax=ot.num_itermax,
                                     stop_thr=ot.stop_thr, engine="pallas")
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"ot_barycentric_targets(engine='pallas') at {n} x {m}: launches "
        f"{counts}, targets {tuple(targets.shape)} finite "
        f"{bool(torch.isfinite(targets).all())}")
    if (counts.get(LONG_ROWS_NAME, 0) < 1 or set(counts) != {LONG_ROWS_NAME}
            or not bool(torch.isfinite(targets).all())):
        fail(f"{LONG_ROWS_NAME} alone should launch at {n} x {m}, with "
             f"finite targets: {counts}")
    la = torch.log(marginal(None, n, dev))
    lb = torch.log(marginal(None, m, dev))
    Mr = -sqeuclidean_cdist(Xs, Ys) / ot.reg
    res = sinkhorn_checks(la, lb, Mr, ot, LONG_ROWS_NAME,
                          SINKHORN_LONG_ROWS_ERR_ATOL)
    old = other_routes_us(sd, la, lb, Mr, ot.num_itermax, (sd.TWO_READ,))
    log(f"Sinkhorn {n} x {m} per sweep on the two-read kernels: "
        f"{old[sd.TWO_READ]:.2f} us (long-rows route "
        f"{res['ms_fixed'] / ot.num_itermax * 1e3:.2f} us; plan "
        f"{sd.long_rows_plan(n, m, torch.cuda.get_device_properties(dev).multi_processor_count)})")
    return {"name": LONG_ROWS_NAME, "route": "cuda",
            "source": SINKHORN_SOURCE, "replaces": SINKHORN_REPLACES,
            "launches": counts[LONG_ROWS_NAME], "max_abs_err": res["p_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            **sinkhorn_bound(n, m, res["sweeps"]), "library_ms": None}


def prefetch_phase(dev) -> None:
    """Phase 2a (see the module docstring)."""
    import torch
    from hyperres_torch.io.pipeline import PrefetchToDevice

    rng = np.random.default_rng(7)
    host = [rng.standard_normal(PREFETCH_SLAB, dtype=np.float32)
            for _ in range(PREFETCH_CHUNKS)]
    loader = None

    def hold_copies(item):
        # runs in the loader thread before the batch is pinned and its
        # copy queued on the side stream: that copy waits behind a sleep
        with torch.cuda.stream(loader._stream):
            torch.cuda._sleep(PREFETCH_COPY_HOLD)
        return item

    loader = PrefetchToDevice(iter(host), depth=PREFETCH_DEPTH, device=dev,
                              transform=hold_copies)
    t0 = time.perf_counter()
    got = []
    for x in loader:
        torch.cuda._sleep(PREFETCH_READ_HOLD)
        got.append(x.clone())
        del x
        scratch = torch.full(PREFETCH_SLAB, float("nan"), device=dev)
        del scratch
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bad = [i for i, (g, h) in enumerate(zip(got, host))
           if not np.array_equal(g.cpu().numpy(), h)]
    log(f"ingest hazards: {len(got)} slabs {PREFETCH_SLAB} f32 through "
        f"PrefetchToDevice (depth {PREFETCH_DEPTH}) with held-back copies "
        f"and reads in {secs:.3f} s; {len(bad)} differ from their host "
        f"arrays {bad[:8]}")
    if len(got) != PREFETCH_CHUNKS or bad:
        fail("PrefetchToDevice delivered slabs that differ from their host "
             "arrays")


def n_differ(a, b) -> int:
    """Differing elements of two u16 tensors of one shape (compared as
    int16 bit patterns: CUDA takes few operators on uint16)."""
    import torch

    return int((a.view(torch.int16) != b.view(torch.int16)).sum())


def ortho_phase(dev, workdir) -> dict:
    """Phase 9 (see the module docstring). Returns what the kernel phases
    take from it: the f32 run's UTM cube on the card (``cube``), the
    granule's wavelengths and good-band mask, and the u16 run's launch
    counts."""
    import torch
    from hyperres_torch.core.config import OrthoConfig
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.core.grid import Grid
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.io.tiff import TiffReader
    from hyperres_torch.kernels.banded import KERNEL_NAMES, scanline_resample
    from hyperres_torch.kernels.host import (
        prepare_glt, scanline_cstar, source_index_field,
    )
    from hyperres_torch.kernels.quantize import quantize_u16_reference
    from hyperres_torch.kernels.warp import orthowarp_two_pass
    from hyperres_torch.ortho.pipeline import orthorectify_granule
    from hyperres_torch.testing.scenes import make_scene

    t0 = time.perf_counter()
    scene = make_scene(workdir / "scene", raw_shape=ORTHO_RAW,
                       n_bands=ORTHO_BANDS, compress_granule=False,
                       s2_size=ORTHO_S2_SIZE)
    s2 = scene.s2_grid
    cx, cy = scene.swath_center_utm
    half = S2_TILE_PX * 10.0 / 2.0
    tile = Grid(s2.crs, s2.x0 + 60.0 * round((cx - half - s2.x0) / 60.0),
                s2.y0 + 60.0 * round((cy + half - s2.y0) / 60.0), 10.0,
                10.0, S2_TILE_PX, S2_TILE_PX)
    gran_gb = scene.emit_nc_path.stat().st_size / 1e9
    log(f"ortho: granule {ORTHO_RAW + (ORTHO_BANDS,)} f32 uncompressed "
        f"({gran_gb:.2f} GB) made in {time.perf_counter() - t0:.1f} s")

    out_dir = workdir / "ortho"
    runs = {}
    for transfer in ("u16", "f32"):
        # the u16 run also exports LOC (per-band lo/hi on the kernel); the
        # f32 run overwrites the DATA products in the same directory
        cfg = OrthoConfig(ingest_transfer=transfer,
                          overwrite=transfer == "f32")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        # the default device: the card
        res = orthorectify_granule(scene.emit_nc_path, out_dir, tile,
                                   config=cfg, export_loc=transfer == "u16",
                                   keep_device_cube=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        stages = {k: v["seconds"] for k, v in res.info["stages"].items()
                  if "seconds" in v}
        fold = res.info["stages"]["data_streamed_orthowarp"]
        cube = res.device_cube
        log(f"ortho {transfer} run: {secs:.3f} s; UTM cube "
            f"{tuple(cube.shape)}; peak memory {peak_gb:.2f} GB; launches "
            f"{counts}; stages (s) {stages}; granule reads in the fold "
            f"{fold['read_seconds']} s")
        # one launch per pass per chunk (and one for LOC); one quantize per
        # u16 product: DATA, its diagnostic band (and LOC)
        loc = int(transfer == "u16")
        want_q = 2 + loc
        for name in KERNEL_NAMES.values():
            if counts.get(name, 0) != ORTHO_CHUNKS + loc:
                fail(f"ortho {transfer} run: {name} launched "
                     f"{counts.get(name, 0)} times, expected "
                     f"{ORTHO_CHUNKS + loc}")
        if counts.get(QUANT_NAME, 0) != want_q:
            fail(f"ortho {transfer} run: {QUANT_NAME} launched "
                 f"{counts.get(QUANT_NAME, 0)} times, expected {want_q}")
        if cube.shape[-1] != ORTHO_BANDS or not bool(
                torch.isfinite(cube).all()):
            fail(f"ortho {transfer} run: the UTM cube is not a finite "
                 f"{ORTHO_BANDS}-band cube")
        if transfer == "u16":
            # the u16 GeoTIFF, decoded, against the quantizer's plain
            # version on the run's own cube
            with TiffReader(res.info["outputs"]["data_utm_tif"]) as r:
                q = r.read()
            want = quantize_u16_reference(cube, 0.0, REFL_HI_EFF, None,
                                          65535, nodata_src=NO_DATA_VALUE)
            bad = int(np.count_nonzero(np.moveaxis(q, 0, -1)
                                       != want.cpu().numpy()))
            log(f"ortho u16 run: DATA GeoTIFF {q.shape} u16, {bad} codes "
                f"differ from the plain quantizer on the run's cube")
            if bad:
                fail("the DATA GeoTIFF differs from the plain quantizer")
            del q, want
        runs[transfer] = (res, counts)

    cube16 = runs["u16"][0].device_cube
    cube32 = runs["f32"][0].device_cube
    utm_grid = runs["f32"][0].utm_grid
    with EmitGranule(scene.emit_nc_path) as g:
        raw_np = g.read_cube()
        flat, valid = prepare_glt(g.glt, (g.raw_height, g.raw_width))
        rows, cols = source_index_field(g.ortho_grid, utm_grid)
        cstar = scanline_cstar(rows, cols, g.ortho_grid.height)
        wl, good = np.asarray(g.wavelengths), g.good_wavelengths

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    raw = on_dev(raw_np)
    del raw_np
    flat, valid, rows, cols, cstar = map(on_dev, (flat, valid, rows, cols,
                                                  cstar))
    # the f32 fold against one warp of the whole cube
    ref = orthowarp_two_pass(raw, flat, valid, rows, cols, cstar)
    same = bool(torch.equal(ref, cube32))
    log(f"ortho f32 fold ({ORTHO_CHUNKS} chunks) vs one orthowarp_two_pass "
        f"of the whole raw cube: bit-equal {same}")
    if not same:
        fail(f"the f32 fold differs from the one-shot warp: max abs "
             f"{float((ref - cube32).abs().max()):.3e}")
    del ref
    # the u16 ingest against the f32 one, where every tap is valid: the
    # validity plane's warp (the weight mass) is 1 there
    vplane = valid.to(torch.float32)[..., None]
    mass = scanline_resample(scanline_resample(vplane, cstar, 1), rows,
                             0)[..., 0]
    full = ((mass - 1.0).abs() <= 1e-6) & (cube32[..., 0] != NO_DATA_VALUE)
    ok = torch.isfinite(raw) & (raw != NO_DATA_VALUE)
    vmin = torch.where(ok, raw, float("inf")).amin(dim=(0, 1)).double()
    vmax = torch.where(ok, raw, float("-inf")).amax(dim=(0, 1)).double()
    del raw, ok
    step = (vmax - vmin) / 65534.0
    lim = (CUBIC_ABS_GAIN * step / 2.0 + U16_INGEST_ATOL).float()
    ratio = (cube16 - cube32).abs() / lim
    same_fill = bool(torch.equal(cube16 == NO_DATA_VALUE,
                                 cube32 == NO_DATA_VALUE))
    worst_full = float(ratio[full].max())
    worst_else = float(ratio[~full & (cube32[..., 0] != NO_DATA_VALUE)]
                       .max())
    log(f"ortho u16 vs f32 ingest: {int(full.sum())} px with every tap "
        f"valid, max |d| {worst_full:.4f} of the bound "
        f"{CUBIC_ABS_GAIN} * step_b / 2 + {U16_INGEST_ATOL:g} (step_b "
        f"{float(step.min()):.3e}..{float(step.max()):.3e}); elsewhere "
        f"{worst_else:.4f} of it; same fill pixels {same_fill}")
    if not (worst_full <= 1.0 and same_fill):
        fail("the u16 ingest departs from the f32 one beyond its bound")
    del ratio, cube16, mass, full
    return {"cube": cube32, "wavelengths": wl, "good": good,
            "counts": runs["u16"][1]}


def quantize_phase(cube, launches: int) -> dict:
    """Phase 10: the quantize kernel against its plain version on the
    ortho phase's UTM cube in three forms; timed in the reflectance form.
    Returns the kernel's entry of the kernels line."""
    import torch
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.kernels.quantize import (
        KERNEL_NAME, pallas_quantize_u16, quantize_u16,
        quantize_u16_reference,
    )
    from hyperres_torch.kernels.stats import strided_band_minmax

    x2 = cube.reshape(-1, cube.shape[-1])
    valid = torch.isfinite(x2) & (x2 != NO_DATA_VALUE)
    lo_b, hi_b = strided_band_minmax(cube, NO_DATA_VALUE)
    hi_b = torch.where(hi_b <= lo_b, lo_b + 1e-6, hi_b)
    refl = ((cube, 0.0, REFL_HI_EFF, None, 65535),
            {"nodata_src": NO_DATA_VALUE})
    cases = {
        "reflectance (stats form, validity in the kernel, sentinel 65535)":
            (quantize_u16, refl[0], refl[1]),
        "pallas form (scalar lo/hi, a validity mask, sentinel 65535)":
            (pallas_quantize_u16, (x2, 0.0, REFL_HI_EFF, valid, 65535), {}),
        "OBS-like (per-band p1/p99 lo/hi, sentinel 0)":
            (quantize_u16, (cube, lo_b, hi_b, None, 0),
             {"nodata_src": NO_DATA_VALUE}),
    }
    for label, (fn, args, kw) in cases.items():
        form = {"form": "pallas"} if fn is pallas_quantize_u16 else {}
        got = fn(*args, **kw)
        want = quantize_u16_reference(*args, **kw, **form)
        bad = n_differ(got, want)
        log(f"check quantize {label}: {bad} of {got.numel()} codes differ")
        if bad:
            fail(f"quantize_u16 disagrees with its plain version: {label}")
        del got, want
    ms = cuda_ms(lambda: quantize_u16(*refl[0], **refl[1]), 10)
    plain_ms = cuda_ms(lambda: quantize_u16_reference(*refl[0], **refl[1]),
                       2)
    n = float(cube.numel())
    work = bound(n * (4.0 + 2.0), 6.0 * n)   # f32 in, u16 out
    log(f"quantize at {tuple(cube.shape)}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {work['bound_ms']:.3f} ms "
        f"({work['bound_by']})")
    return {"name": KERNEL_NAME, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": QUANT_REPLACES, "launches": launches,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **work}


def srf_phase(cube, wavelengths, good) -> dict:
    """Phase 11: ``srf_synthesize_auto(use_pallas=True)`` on the ortho
    phase's UTM cube (S2A's 13 bands), which must launch the kernel;
    then the kernel (tiled route) and the warp kernel against the plain
    version at S = 13 and S = 3 with the valid-pixel mask, and the
    kernels, the plain version and ``torch.matmul`` timed; then the
    seeded shapes of SRF_WIDE_SHAPES. Returns the kernel's entry of the
    kernels line (S = 13)."""
    import torch
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels._build import load_library
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.kernels import srf
    from hyperres_torch.kernels.srf import (
        KERNEL_NAME, ROUTE_NAMES, pallas_srf_synthesize, srf_synthesize_auto,
        srf_synthesize_reference,
    )
    from hyperres_torch.spectral.srf_tables import builtin_srf

    def on_route(route, x, W, v):
        """``pallas_srf_synthesize`` with ``route`` forced by a stand-in
        rule (the rule itself is not changed); the run must count one
        launch under that route's name."""
        rule = srf.srf_route
        srf.srf_route = lambda b, s: (route, 0)
        reset_launch_counts()
        try:
            out = pallas_srf_synthesize(x, W, v)
        finally:
            srf.srf_route = rule
        if dict(launch_counts) != {ROUTE_NAMES[route]: 1}:
            fail(f"the forced {route} route should count one launch as "
                 f"{ROUTE_NAMES[route]}: {dict(launch_counts)}")
        return out

    def plan_matches_mirror(b: int, s: int) -> None:
        lib = load_library("srf_synthesize")
        for r in (2, 1):
            if lib.srf_tiled_smem_bytes(b, s, r) != srf._tiled_smem_bytes(
                    b, s, r):
                fail(f"the tiled SRF kernel plans "
                     f"{lib.srf_tiled_smem_bytes(b, s, r)} bytes of shared "
                     f"memory at B={b}, S={s}, R={r}; the wrapper "
                     f"{srf._tiled_smem_bytes(b, s, r)}")

    h, w, b = cube.shape
    valid_hw = (cube != NO_DATA_VALUE).all(dim=-1)
    flat, v = cube.reshape(-1, b), valid_hw.reshape(-1)
    n, n_valid = flat.shape[0], int(v.sum())
    entry = None
    for bands in (None, ["B2", "B3", "B4"]):
        W, names, _ = build_srf_weight_matrix(
            wavelengths, builtin_srf("S2A", bands=bands), good)
        Wt = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(
            cube.device)
        s = Wt.shape[1]
        if srf.srf_route(b, s)[0] != srf.TILED:
            fail(f"B = {b}, S = {s} should take the tiled route")
        plan_matches_mirror(b, s)
        if bands is None:
            reset_launch_counts()
            out = srf_synthesize_auto(cube, Wt, valid_hw, use_pallas=True)
            torch.cuda.synchronize()
            launches = launch_counts.get(KERNEL_NAME, 0)
            log(f"srf_synthesize_auto(use_pallas=True) on the UTM cube: "
                f"{tuple(out.shape)}, launches {dict(launch_counts)}")
            if (tuple(out.shape) != (h, w, s)
                    or dict(launch_counts) != {KERNEL_NAME: 1}):
                fail("srf_synthesize_auto(use_pallas=True) did not run the "
                     "tiled kernel once to an (H, W, S) cube")
            del out
        want = srf_synthesize_reference(flat, Wt, v)
        errs, fills = {}, {}
        for route in (srf.TILED, srf.WARP):
            got = (pallas_srf_synthesize(flat, Wt, v) if route == srf.TILED
                   else on_route(route, flat, Wt, v))
            errs[route] = float((got - want).abs().max())
            fills[route] = bool(torch.equal(got[~v], want[~v])
                                and bool((got[~v] == NO_DATA_VALUE).all()))
            del got
        del want
        err = errs[srf.TILED]
        ms = cuda_ms(lambda: pallas_srf_synthesize(flat, Wt, v), 10)
        plain_ms = cuda_ms(lambda: srf_synthesize_reference(flat, Wt, v), 3)
        library_ms = cuda_ms(lambda: torch.matmul(flat, Wt), 10)
        warp_ms = cuda_ms(lambda: on_route(srf.WARP, flat, Wt, v), 10)
        # only the valid rows need reading: an invalid row's outputs are
        # the fill
        work = bound(4.0 * (n_valid * b + b * s + n * s) + n,
                     2.0 * n_valid * b * s)
        log(f"check SRF S={s} ({','.join(names)}): max abs err {err:.3e}, "
            f"the warp kernel's {errs[srf.WARP]:.3e} "
            f"(tol {SRF_TOL:g}), fill exact {fills}; route "
            f"{srf.srf_route(b, s)}; kernel {ms:.3f} ms, the warp kernel "
            f"{warp_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms, "
            f"bound {work['bound_ms']:.3f} ms ({work['bound_by']}); "
            f"{n_valid} of {n} rows valid")
        if not (max(errs.values()) <= SRF_TOL and all(fills.values())):
            fail(f"an srf_synthesize route disagrees with the plain version "
                 f"at S={s}")
        if entry is None:
            entry = {"name": KERNEL_NAME, "route": "cuda",
                     "source": SRF_SOURCE, "replaces": SRF_REPLACES,
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, **work}
        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    rng = np.random.default_rng(5)
    for bw, sw, route in SRF_WIDE_SHAPES:
        x = torch.from_numpy(rng.random((SRF_WIDE_ROWS, bw),
                                        dtype=np.float32)).to(cube.device)
        Ww = torch.from_numpy(rng.random((bw, sw),
                                         dtype=np.float32)).to(cube.device)
        vw = torch.from_numpy(rng.random(SRF_WIDE_ROWS) > 0.1).to(cube.device)
        if srf.srf_route(bw, sw)[0] != route:
            fail(f"B = {bw}, S = {sw} should take the {route} route, not "
                 f"{srf.srf_route(bw, sw)}")
        if route == srf.TILED:
            plan_matches_mirror(bw, sw)
        reset_launch_counts()
        got = pallas_srf_synthesize(x, Ww, vw)
        counts = dict(launch_counts)
        want = srf_synthesize_reference(x, Ww, vw)
        err = float((got - want).abs().max())
        scale = float(want[vw].abs().max())
        fill_ok = bool((got[~vw] == NO_DATA_VALUE).all())
        ms = cuda_ms(lambda: pallas_srf_synthesize(x, Ww, vw), 10)
        plain_ms = cuda_ms(lambda: srf_synthesize_reference(x, Ww, vw), 3)
        library_ms = cuda_ms(lambda: torch.matmul(x, Ww), 10)
        n_ok = int(vw.sum())
        work = bound(4.0 * (n_ok * bw + bw * sw + SRF_WIDE_ROWS * sw)
                     + SRF_WIDE_ROWS, 2.0 * n_ok * bw * sw)
        log(f"check SRF B={bw} S={sw} ({SRF_WIDE_ROWS} seeded rows), route "
            f"{srf.srf_route(bw, sw)}: max abs err {err:.3e} = "
            f"{err / scale:.3e} of the largest output (tol "
            f"{SRF_WIDE_RTOL:g}), fill exact {fill_ok}, launches "
            f"{counts}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"torch.matmul {library_ms:.3f} ms, bound "
            f"{work['bound_ms']:.3f} ms ({work['bound_by']})")
        if not (err <= SRF_WIDE_RTOL * scale and fill_ok
                and counts == {ROUTE_NAMES[route]: 1}):
            fail(f"srf_synthesize disagrees with its plain version at "
                 f"B={bw}, S={sw}, or launched {counts}")
        if route == srf.WARP:
            # what these rows would cost without the warp route
            gen = on_route(srf.GENERIC, x, Ww, vw)
            gen_err = float((gen - want).abs().max())
            gen_ms = cuda_ms(lambda: on_route(srf.GENERIC, x, Ww, vw), 10)
            log(f"SRF B={bw} S={sw}: the generic kernel on the same rows "
                f"{gen_ms:.3f} ms (the warp route {ms:.3f} ms), max abs "
                f"err {gen_err / scale:.3e} of the largest output")
            if not (gen_err <= SRF_WIDE_RTOL * scale
                    and bool((gen[~vw] == NO_DATA_VALUE).all())):
                fail(f"the generic SRF kernel disagrees with the plain "
                     f"version at B={bw}, S={sw}")
            del gen
        del x, Ww, vw, got, want
    return entry


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
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    from hyperres_torch.kernels import _build
    from hyperres_torch.kernels.banded import DENSE_KERNEL_NAME
    from hyperres_torch.kernels.warp import orthowarp_src_ext
    from hyperres_torch.testing.bench_scene import generate_scene

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_libraries(["scanline_warp", "sr_predict", "sinkhorn_duals",
                           "quantize_u16", "srf_synthesize"])
    log(f"build: all kernels in {time.perf_counter() - t0:.3f} s")
    for name, info in _build.build_info.items():
        log(f"build: {name}: nvcc {info['seconds']:.3f} s")
        log(info["ptxas"])

    # -- 2a. the ingest's two hazards ----------------------------------------
    prefetch_phase(dev)

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
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})

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
        "plain_ms": dense["pass1_plain_ms"] + dense["pass2_plain_ms"],
        "bound_ms": dense["bound_ms"], "bound_by": "bytes",
        "library_ms": None})

    # -- 5b. Sinkhorn at 5000 x 5000 on the plan's OT samples ------------
    utm_cube = plan.warp(raw)
    samples = plan.ot_samples(utm_cube, s2, plan.generator(0))
    kernels.append(sinkhorn_phase(*samples, plan.statics.ot))
    long_rows = [sinkhorn_long_rows_phase(dev, plan.statics.ot, n, m)
                 for n, m in SINKHORN_LONG_ROWS_SHAPES]
    sinkhorn_fragile_stop(dev, plan.statics.ot)
    kernels.append(long_rows[0])
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

    kernels.extend(sr_phases(dev))
    torch.cuda.empty_cache()

    # -- 9-11. the ortho export path and its two kernels ------------------
    with tempfile.TemporaryDirectory() as d:
        ortho = ortho_phase(dev, Path(d))
    kernels.append(quantize_phase(ortho["cube"],
                                  ortho["counts"][QUANT_NAME]))
    kernels.append(srf_phase(ortho["cube"], ortho["wavelengths"],
                             ortho["good"]))
    del ortho
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    # again, beside the numbers: a caller may keep only the output's end
    log(card_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

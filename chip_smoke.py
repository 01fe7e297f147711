#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device: needs ``torch.cuda.is_available()``; prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the seven kernels (``csrc/scanline_warp.cu``,
   ``csrc/sr_predict.cu``, ``csrc/sinkhorn_duals.cu``,
   ``csrc/quantize_u16.cu``, ``csrc/srf_synthesize.cu``,
   ``csrc/upsample_apply.cu``, ``csrc/deshift_warp.cu``) with nvcc for
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
4. Main path: ``bench_torch.build_workload`` at full scale (1.0): the
   bench scene, generated and cached under ``.scenecache/`` (phase 19
   reads it), and the port's ``FusedOrthoFusionPlan`` on the card; runs
   it once to warm up and N_RUNS times as ``bench_torch.timed_runs``
   times them (CUDA events), checks the output shapes and that every run
   launched each pass of the kernel once. Then times the kernel against
   its plain version at the main path's shapes, and the 10 m apply
   kernel (launched once a run) against the eager chain it replaces on
   the plan's own stretched 60 m RGB and fit: bit-equal, NaN in the same
   places.
5. Accuracy gates of ``bench.py`` (``bench_torch.accuracy_metrics`` and
   ``bench_torch.GATES``) against the plan's own ``s2_reference_10m``:
   finite fraction > 0.3, max <= 1, pipeline PSNR >= 45 dB, SAM <= 0.01
   rad, method PSNR >= 28 dB.
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
5d. ``fuse_pair`` (``hyperres_torch.pipeline``) on the full-scale scene's
   UTM cube and S2 stack: ``engine="fused"`` for ``ot_poly``,
   ``ot_affine``, ``linear`` and ``histogram``, ``engine="phases"`` for
   ``ot_poly``, ``linear`` and ``histogram``, and ``ot_poly`` with
   ``synth_method="box"``; the fused engine once to warm up and N_RUNS
   times, the phase-wise engine (host-bound, 10-30 s a call, nothing to
   warm) FUSE_PHASES_RUNS time, host clock around a synchronise, with
   peak device memory. Every product:
   shape, finite fraction > 0.3, max <= 1; the parametric methods the
   pipeline PSNR / SAM gates of phase 5 against the default plan's
   ``s2_reference_10m``. The fused and the phase-wise product of one
   method (``ot_poly``, ``linear``, ``histogram``): PSNR >=
   FUSED_PSNR_GATE (the reference's ``fused_psnr_gate``).
5e. The ``warp_kernel="taploop"`` plan (``orthowarp_taploop``) at full
   scale beside the default plan: its ``utm_cube`` against the default
   plan's by ``cube_psnr_sam(erode=2)``: PSNR >= TAPLOOP_PSNR_GATE, mask
   agreement > TAPLOOP_MASK_AGREEMENT; phase 5's gates. Then
   ``warp_two_pass`` with a nodata value (one validity channel per band,
   570 channels through both passes) through ``resample_to_grid``'s
   ``kernel="auto"`` rule on the scene's GLT-gathered geographic cube
   onto the UTM grid (1523 x 1550 x 285, cross-CRS): each scanline pass
   must launch once; both passes of the kernel at these 570 channels
   must agree with their plain version on the warp's own source and
   positions, over every pixel, within KERNEL_TOL; and, as a further
   reading, the result must lie within TWO_PASS_GATHER_TOL of the gather
   kernels' where every tap of both reads a valid source (the valid
   weight mass is 1), 2 px inside that area's edge.
6. Spectral-SR fit and entry: fits the product ridge model (degree 3,
   10 -> 32 bands) on the card on 200k seeded pixels
   (``scripts/torch_bench_sr_granule.py``'s ``training_data``) and checks its
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
8. SR main path at full scale, through
   ``scripts/torch_bench_sr_granule.py``'s ``granule_cube`` and
   ``product_legs``: ``predict_cube_u16`` on a (10, 9140, 9309) cube
   whose first 5 % of pixels are a nodata stripe, once to warm up and
   once under CUDA events (upload and both calls timed); checks the
   (32, 9140, 9309) u16 product, that the stripe and nothing else is
   65535, that both calls launched the kernel, and the kernel against
   its plain version at that shape; times both. The bound counts the contraction
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

12. ``verify_granule`` (``hyperres_torch.verify``) on phase 9's granule
   and the S2 stack GeoTIFF ``make_scene`` wrote beside it (VERIFY_S2_SIZE
   px of 10 m, which covers the swath): the shipped route (two-pass warp,
   fused engine) beside the exact one (tap-loop warp, phase-wise engine),
   at the default gates; prints the three PSNRs, ``coeffs_max_abs_delta``,
   ``total_seconds``, the launch counts and peak memory. ``passed`` must
   be true. The scene is ``make_scene``'s of seed VERIFY_SCENE_SEED: the
   fused product's gate compares two draws of 5000 OT samples (the fused
   engine's from the card's generator, the phase-wise engine's from
   NumPy's), and over scene seeds its reading spreads across the default
   40 dB (``scripts/torch_verify_gate_spread.py`` takes it apart). Each
   scanline pass must have launched once per chunk of the shipped ortho
   run and never for the exact one.
13. ``run_pair_pipeline`` (``hyperres_torch.pipeline``) on phase 9's
   granule with ``coregister=True`` and ``predict_sr_cube=True``, on the
   default device, with ``OrthoConfig()``, ``PolyFusionConfig()``,
   ``TilingConfig()``, ``RidgeSRConfig()`` and ``CoregConfig()``, and
   ``max_tiles=PAIRS_MAX_TILES`` (the one cut: the tile writes are host
   deflate). Its S2 stack (``shifted_s2_stack``, made after phase 11 from
   the ortho phase's UTM cube on the stack's 9600 px grid) is shifted by
   PAIRS_SHIFT px of 10 m. Prints the seconds of each stage and in all,
   peak device memory, the launches and the card line. Fails unless the
   coregistration succeeded within PAIRS_SHIFT_TOL px of the shift, the
   fused product is finite on > PAIRS_FINITE_MIN of its pixels with
   values in [0, 1], at least one tile was written with a record each
   and the manifest, the SR fit's ``r2_mean`` > PAIRS_R2_MIN,
   ``emit_sr_10m.tif`` decodes with one band per SR band on the fused
   product's grid, ``report.md`` has every section, each scanline pass
   launched at least ORTHO_CHUNKS times, quantize at least once, and the
   SR kernel and the deshift kernel exactly once.
13a. The coregistration's deshift kernel (``csrc/deshift_warp.cu``) at
   the coregistration cell's shapes (its launches: phase 13's run's): a
   seeded (10, 9140, 9309) u16 stack whose first 5 % of pixels are
   nodata (65535), deshifted cubically by DESHIFT_AFFINE (a translation of 5.3 / -3.8 px and a centred linear
   term of up to 1.5 px across the footprint); its u16 product must equal
   the eager chain's (``coreg.local.deshift_hwb`` and the cast) bit for
   bit; the kernel timed against its byte bound and that chain.
14. Multi-device (``hyperres_torch.parallel``) on meshes of logical
   shards on the card, each op timed (host clock around a synchronise,
   peak memory) beside its single-device counterpart on the same inputs:
   on phase 9's granule, ``sharded_orthowarp_two_pass`` (n shards, n the
   first of PAR_SHARDS dividing the GLT grid's and the UTM grid's
   heights, else the first dividing the UTM grid's with the GLT padded by
   invalid scanlines to a multiple of it, for both warps; the smallest halo that passes; Ho, the pad, n and the
   halo printed) against ``orthowarp_two_pass``, n launches of each pass;
   ``sharded_orthowarp_srf_2d`` on an n x PAR_BAND_SHARDS mesh against
   that warp times the S2A SRF weights (``torch.matmul``), within
   PAR_SRF_TOL of max(|v|, 1); ``sharded_streamed_orthowarp`` (u16,
   PAR_CHUNK_BANDS-band chunks) against the ortho path's single-device
   fold of the same granule; both warps within PAR_WARP_TOL (expected
   bit-equal). Then ``sharded_sr_predict_u16(engine="pallas")`` on
   PAR_SR_SHARDS shards of the SR product's (85,084,260, 10) pixels
   (seeded, a nodata stripe) with the product's model: one SR kernel
   launch per shard, the codes bit-equal to one row-major kernel call;
   ``sharded_histogram_percentile`` at PAR_QS on one 10 m band of the
   bench scene (PAR_STAT_SHARDS shards) within 2 * range / 2048 of the
   exact ``masked_percentile``; ``data_parallel_ridge_fit`` on
   PAR_FIT_PX seeded pixels (PAR_STAT_SHARDS shards), W within
   PAR_FIT_TOL of ``RidgeSpectralSR.fit``'s.
15. ``BatchPairDriver.run(jobs, devices=[cuda:0] * BATCH_WORKERS)`` on
   three ``make_scene`` pairs cut to BATCH_RAW x 285 bands (S2 BATCH_S2
   px; each job is ``run_pair_pipeline``, which phase 13 runs at full
   width): every pair ``done`` on the card, two pipelines overlapping in
   wall clock, each scanline pass launched for every pair; a second run
   runs nothing (resume); with a fourth job whose granule is missing,
   that one ``failed`` after two recorded attempts, the rest ``done``.
16. ``python -m hyperres_torch`` in subprocesses on the card: ``scene``
   (CLI_SCENE), then ``ortho``, ``fuse``, ``batch``, ``verify-granule``,
   ``info`` and ``quicklook`` in parallel: each exits 0 (or
   ``verify-granule`` 1 with ``passed`` false), ``scene`` to
   ``verify-granule`` print JSON that parses, ``info`` names the raster,
   ``quicklook`` prints the viewer it wrote.
17. The granule toolkit and pair discovery. (a) ``ortho.toolkit`` on
   phase 9's granule and a second full-width ``make_scene`` granule
   (seed TOOLKIT_SEED, its swath centre TOOLKIT_SHIFT_M metres away, so
   the footprints overlap in part): ``merge_emit`` on the card, cold
   then warm (host seconds around a synchronise, peak memory, the
   mosaic's shape, GB, valid share and the share the second granule
   filled; it launches no hand-written kernel: the GLT gather and the
   nearest placement are tensor ops), two runs equal, and the mosaic
   ``array_equal`` to ``merge_emit(device="cpu")`` with the same grid;
   ``spatial_subset`` of the first granule over a box of about half its
   footprint, whose ortho on the card must equal the full ortho's crop
   on every valid cell; ``ortho_browse`` of a u8 RGB, equal to the
   card's gather. (b) ``catalog.discover_pairs`` on the host over
   canned responses written to disk: CATALOG_DATES dates of EMIT
   granules (two a date, UMM polygons of the first granule's swath),
   Sentinel-2 items on the MGRS tile grid that holds the swath (whole
   tile every 5 days, partial strips from two other orbits), each
   full-tile acquisition with a 5490 x 5490 u8 SCL raster (tiled
   CATALOG_BLOCK px, deflate); every fetch through the clients' injected
   ``fetch_json`` / ``download`` and ``open_remote_scl``'s
   ``fetch_range``, reading those files (no ``requests``, no socket).
   The pairs kept must be those that whole-file ``TiffReader`` counts of
   each SCL over the overlap say (counted in a thread beside the call),
   and each ranged read must equal the whole read; prints the seconds
   and the bytes fetched against the files' sizes.
18. The card test suite: ``python -m pytest tests_gpu`` in a subprocess
   from the repository root (kernels loaded from the builds of phase 2),
   with a junit XML report. ``tests_gpu/`` imports no JAX: each kernel's
   edge cases against its plain version (both interpolation methods,
   the dense route, the SRF routes at B = 400 / 401, the SR layouts and
   the streamed route, the Sinkhorn routes, the prefetcher's buffer
   lifetime, the ``engine=`` argument) and the four torch demos
   (``examples/torch_demo_*.py --device cuda``, each with the launch
   counts set to 0 before it and read after, recorded in the report).
   Fails unless the subprocess exits 0 within CARD_SUITE_TIMEOUT s, no
   case failed or erred, and every case passed but TWO_CARD_TEST, which
   may skip on a machine with one card; a suite that skips because it
   sees no card fails. Prints each demo's seconds and launches.
19. The port's full-scale programs (each run's launch counts set to 0
   before it and read after): ``python bench_torch.py`` in a subprocess
   at scale 1.0 from phase 4's scene cache, with no other
   HYPERRES_BENCH_* variable (BENCH_TIMEOUT s): it must exit 0 with one
   stdout line, a JSON object that meets ``bench.py``'s gates and shows
   ``bench_torch.DEFAULT_RUNS`` launches of each scanline pass. Then in
   this process: ``scripts/torch_bench_throughput.py`` at
   PROGRAMS_SCALE with PROGRAMS_GRANULES granules (each pass launched
   for the warm-up and every granule), ``torch_validate_fullscale.py``
   and ``torch_validate_fused_parity.py`` at PROGRAMS_SCALE (each prints
   ``PASS``; each pass launched), and
   ``torch_run_production_fullscale.run`` on a PROD_RAW granule with a
   PROD_S2 px stack in a temporary directory (each pass and quantize
   launched; the fused product finite on > 0.3 of its pixels, a report).
20. The port's host analyses on the card, each ``main`` in this process
   with the launch counts set to 0 before it and read after (logged;
   neither path reaches a hand-written kernel, so they read zero):
   ``scripts/torch_calibrate_coreg_reliability.py`` at CALIB_PER_CELL
   windows per cell must cover CALIB_WINDOWS windows and find a tau within
   CALIB_TAU_TOL of the port's ``RELIABILITY_TAU``;
   ``scripts/torch_srf_sensitivity.py`` at its default 96 x 128 must run
   SRF_SENS_PERTURBATIONS perturbations, read a worst band delta within
   SRF_SENS_BAND_TOL of SRF_SENS_WORST_BAND and a worst fused PSNR of at
   least SRF_SENS_PSNR_MIN_DB against its baseline. Prints snr*, tau,
   the three worst cases and each analysis's seconds.

Prints the seconds of each phase (``clock.spans``), then the kernels'
JSON line (the two banded passes, the dense route,
``sinkhorn_duals`` (one pass), ``sinkhorn_duals_long_rows``,
``sr_predict_u16``, ``sr_predict_u16_streamed``, ``quantize_u16``,
``srf_synthesize``; each with its launches, error, times, its bound on
this card and a library call's time where one PyTorch call computes the
same function), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import bench_torch

T_START = time.perf_counter()

MAIN_SCALE = 1.0
CHECK_SCALE = 0.25
N_RUNS = 3
#: kernel vs plain, max abs error: both evaluate the same <= 4 taps in
#: f32, in the same order; they differ only by FMA contraction in the
#: weights and the accumulation (a few ulp of values <= ~1)
KERNEL_TOL = 1e-5
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
#: card fit vs CPU fit, predictions: the Gram sums run in another order
#: on the card (measured 9.7e-6 on an H100 when they were f32; the fit
#: sums and solves in f64 now, the monomials stay f32)
SR_FIT_TOL = 1e-4
SR_SOURCE = "hyperres_torch/csrc/sr_predict.cu"
SR_REPLACES = ("hyperres/kernels/pallas_ops.py:828 "
               "(pallas_sr_predict_u16_cmajor); "
               "hyperres/kernels/pallas_ops.py:725 (pallas_sr_predict_u16)")
#: the ortho export path: an EMIT granule at its real raw size, every band
ORTHO_RAW = (1242, 1280)
ORTHO_BANDS = 285
#: the S2 stack that make_scene writes beside the granule: VERIFY_S2_SIZE px
#: of 10 m (96 km; the 1242 x 1280 swath of 60 m pixels, turned by 13
#: degrees, spans 91.6 x 89.9 km), read by the verify phase. The ortho
#: phase passes a grid instead: a full S2 tile (10980 px of 10 m, the
#: stack's own 60 m lattice) centred on the swath. Either way the UTM grid
#: is the swath's.
VERIFY_S2_SIZE = 9600
S2_TILE_PX = 10980
#: fuse_pair's fused product against its phase-wise product of the same
#: method (the reference's fused_psnr_gate), and the tap-loop plan's UTM
#: cube against the two-pass plan's (tests/test_verify_granule.py)
FUSED_PSNR_GATE = 40.0
TAPLOOP_PSNR_GATE = 40.0
TAPLOOP_MASK_AGREEMENT = 0.999
#: the generic two-pass warp against the gather kernels away from holes:
#: the scanline-sheared kernel against the axis-aligned one
#: (tests/test_torch_resample.py states it for the "auto" rule)
TWO_PASS_GATHER_TOL = 2e-3
#: make_scene's seed for the granule and the S2 stack of phases 9-12.
#: verify_granule's fused gate compares two draws of OT samples, and on an
#: H100 it reads 35.52, 41.38 and 45.67 dB on the scenes of seeds 0, 1 and
#: 2 (scripts/torch_verify_gate_spread.py): this is the seed with the
#: widest margin over the default 40 dB
VERIFY_SCENE_SEED = 2
#: timed calls of fuse_pair's phase-wise engine (no warm-up call)
FUSE_PHASES_RUNS = 1
#: fuse_pair's runs: (fusion_method, engine, synth_method)
FUSE_RUNS = (("ot_poly", "fused", "srf"), ("ot_affine", "fused", "srf"),
             ("linear", "fused", "srf"), ("histogram", "fused", "srf"),
             ("ot_poly", "phases", "srf"), ("linear", "phases", "srf"),
             ("histogram", "phases", "srf"), ("ot_poly", "fused", "box"))
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
APPLY_SOURCE = "hyperres_torch/csrc/upsample_apply.cu"
DESHIFT_SOURCE = "hyperres_torch/csrc/deshift_warp.cu"
#: no TPU kernel: the reference's deshift calls its plain warp
DESHIFT_REPLACES = ("none (hyperres/coreg/local.py:356, the plain "
                    "warp_interpolate, left to XLA)")
#: the coregistration cell's stack and a shift model of its kind (px):
#: dy = 5.3 + 1.5 (r / H - 1/2) - 0.7 (c / W - 1/2), dx likewise
DESHIFT_STACK = (10, 9140, 9309)
DESHIFT_AFFINE = ((1.5 / 9140, -0.7 / 9309, 5.3 - 0.75 + 0.35),
                  (0.4 / 9140, 0.9 / 9309, -3.8 - 0.2 - 0.45))
#: no TPU kernel: the reference leaves phase 4 to XLA's fusion
APPLY_REPLACES = ("none (hyperres/fusion/fused.py:233-275, phase 4, "
                  "left to XLA's fusion)")
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
#: the pairs phase (13): the shift of its S2 stack in 10 m px (rows,
#: columns; two and three 60 m px), the bound on the recovered shift
#: (tests/test_pipeline_e2e.py:99: the EMIT reference carries the GLT's
#: nearest-neighbour quantization, +-0.5 raw px), the tiles written (the
#: phase's one cut: host deflate, the card's work is the same) and the
#: checks of its products
PAIRS_SHIFT = (12, -18)
PAIRS_SHIFT_TOL = 1.5
PAIRS_MAX_TILES = 32
PAIRS_R2_MIN = 0.8
PAIRS_FINITE_MIN = 0.3
PAIRS_SECTIONS = ("Orthorectification", "Coregistration",
                  "Fusion (OT + poly)", "Tiles", "Spectral SR (ridge)",
                  "Spectral SR 10 m product", "Timing")
#: the multi-device phase (14), every mesh of logical shards on the one
#: card: the two-pass warps' shard count is the first of PAR_SHARDS that
#: divides both the GLT grid's and the destination's heights; if none
#: divides the GLT grid's, the first that divides the destination's, and
#: the GLT grid's scanlines are padded with invalid ones to a multiple of
#: it (for the sharded and the single-device warp alike). The 2-D mesh adds PAR_BAND_SHARDS band shards (285 = 5 x 57).
PAR_SHARDS = (3, 2, 4, 6)
PAR_BAND_SHARDS = 5
PAR_SR_SHARDS = 3
PAR_STAT_SHARDS = 4
PAR_CHUNK_BANDS = 32
#: sharded vs single-device warps (the shards do the same f32 arithmetic:
#: expected 0); the 2-D mesh's SRF product, whose band psum adds in
#: another order, relative to max(|v|, 1) (renormalised values beside the
#: swath's edge exceed 1); the data-parallel fit's W (f64 terms)
PAR_WARP_TOL = 1e-5
PAR_SRF_TOL = 1e-4
PAR_FIT_TOL = 1e-6
PAR_FIT_PX = 1_600_000
PAR_QS = (2.0, 50.0, 98.0)
#: the batch phase (15): three make_scene pairs cut to this raw size, all
#: 285 bands, on two worker threads on the card; tiles of 32 px
BATCH_RAW = (192, 200)
BATCH_S2 = 1200
BATCH_WORKERS = 2
BATCH_TILE = 32
#: the CLI phase (16): the scene subcommand's defaults (make_scene's demo
#: size), then the other subcommands in parallel processes
CLI_SCENE = ("--raw", "96", "112", "--bands", "64", "--s2-size", "420")
CLI_TIMEOUT = 300
#: the toolkit phase (17a): a second full-width make_scene granule, its
#: swath centre TOOLKIT_SHIFT_M (x, y) metres from phase 9's (about half a
#: scene along the track, as consecutive EMIT scenes overlap), its own
#: small S2 stack (unused); the subset polygon's half sides, as fractions
#: of the ortho grid's extent; the CPU run that the card's mosaic is held
#: to, at full width while it takes at most TOOLKIT_CPU_LIMIT_S
TOOLKIT_SEED = 3
TOOLKIT_SHIFT_M = (9000.0, -42000.0)
TOOLKIT_S2_PX = 120
TOOLKIT_SUBSET_HALF = 0.29
TOOLKIT_CPU_LIMIT_S = 90.0
#: the catalog phase (17b): CATALOG_DATES dates of EMIT granules, two a
#: date, over phase 9's scene; Sentinel-2 L2A items on the 20 m MGRS tile
#: grid that holds it (5490 x 5490 SCL rasters, tiled 512 px, deflate):
#: the whole tile every 5 days, partial strips of the tile from two other
#: orbits (each in two processing baselines) between; S2 at 10:00 UTC; on
#: CATALOG_MATCH_DAYS the least cloudy EMIT granule lies within the
#: time-of-day window (each such day costs one SCL count per full-tile
#: acquisition within the days window, ~23 s each on the card's host, so
#: one day with two), and CATALOG_CLOUD sets the cloud share of each
#: full-tile acquisition's SCL
CATALOG_DATES = 30
CATALOG_TILE = (399960.0, 5800020.0, 20.0, 5490)
CATALOG_MATCH_DAYS = (13,)
CATALOG_CLOUD = {0: 0.2, 5: 0.45, 10: 0.62, 15: 0.31, 20: 0.15, 25: 0.74,
                 30: 0.56}
CATALOG_BLOCK = 512
# -- phase 18: the card test suite ------------------------------------------
#: seconds the card suite's subprocess may take (it took 24 s on an H100)
CARD_SUITE_TIMEOUT = 300
#: the one case of the suite that may skip, and only with one card
TWO_CARD_TEST = "test_kernels_launch_on_the_tensors_card"


# -- phase 19: the port's full-scale programs -------------------------------
#: seconds ``python bench_torch.py`` may take at scale 1.0 from the scene
#: cache (its nvcc build already done by phase 2)
BENCH_TIMEOUT = 300
#: the scale of the throughput program and of both validations
PROGRAMS_SCALE = 0.25
PROGRAMS_GRANULES = 2
#: the production run's raw granule (rows, columns) and S2 stack (px)
PROD_RAW = (256, 256)
PROD_S2 = 2048

# -- phase 20: the port's host analyses -------------------------------------
#: windows per cell of the reliability calibration: 40 gives the 1440
#: windows the constant RELIABILITY_TAU rests on
CALIB_PER_CELL = 40
CALIB_WINDOWS = 1440
#: the JAX script reads tau 20.845 on the CPU against the constant 20.8;
#: 0.3 in tau is about 0.27 in snr*, three steps of its 0.1 grid
CALIB_TAU_TOL = 0.3
SRF_SENS_PERTURBATIONS = 26
#: the JAX script's worst band delta at 96 x 128 (docs/PARITY.md); the
#: synthesis deltas are NumPy on the host in both scripts
SRF_SENS_WORST_BAND = 0.00575
SRF_SENS_BAND_TOL = 1e-5
#: JAX reads 48.8 dB on the CPU; the margin covers the port's other OT
#: draw (the plan's torch.Generator, not JAX's PRNG)
SRF_SENS_PSNR_MIN_DB = 45.0

#: lines printed once more at the end of the run, just before the
#: ``kernels`` line (a caller may keep only the end of the output)
SUMMARY = []


def log(msg: str, keep: bool = False) -> None:
    print(msg, flush=True)
    if keep:
        SUMMARY.append(msg)


class PhaseClock:
    """Seconds of each phase of the run, by the host clock: ``mark(name)``
    closes the span since the last mark."""

    def __init__(self):
        self.spans = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.spans[name] = round(self.spans.get(name, 0.0)
                                 + now - self._last, 1)
        self._last = now


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


def script(name: str):
    """The module of ``scripts/<name>.py``, one of the port's full-scale
    programs, whose workloads the phases run."""
    import importlib

    scripts = str(Path(__file__).resolve().parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


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
    Xt, Yt = script("torch_bench_sr_granule").training_data(rng)
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
    training_data = script("torch_bench_sr_granule").training_data
    Xb, Yb = training_data(np.random.default_rng(3), 50_000, SR_STREAM_BX)
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
    Xw, Yw = training_data(np.random.default_rng(4), 50_000, SR_XLA_BX)
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

    # -- 8. main SR path at full scale: torch_bench_sr_granule's legs -------
    sr_bench = script("torch_bench_sr_granule")
    t0 = time.perf_counter()
    cube = sr_bench.granule_cube(rng, *SR_SHAPE[1:])
    n_px = SR_SHAPE[1] * SR_SHAPE[2]
    stripe = n_px // 20
    log(f"SR cube {SR_SHAPE} f32 ({cube.nbytes / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.1f} s; nodata stripe: the first "
        f"{stripe} px")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    legs, X, out, _ = sr_bench.product_legs(model, cube, readback=False)
    del cube
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    t_dev = legs["device_program_s"]
    log(f"SR main path (torch_bench_sr_granule legs): upload "
        f"{legs['upload_s']:.3f} s, warm-up {legs['compile_s']:.3f} s, "
        f"device program {t_dev:.5f} s, {n_px / t_dev / 1e6:.1f} Mpx/s; "
        f"peak memory {peak_gb:.2f} GB; launches {counts}", keep=True)
    expect = (SR_BY,) + SR_SHAPE[1:]
    if tuple(out.shape) != expect or out.dtype != torch.uint16:
        fail(f"SR product {tuple(out.shape)} {out.dtype}, expected {expect} "
             f"uint16")
    if counts.get(KERNEL_NAME, 0) != 2:
        fail(f"{KERNEL_NAME} launched {counts.get(KERNEL_NAME, 0)} times in "
             f"the 2 calls of the SR main path")
    for band in out:
        nod = band.reshape(-1).to(torch.int32) == 65535
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


def run_plan(plan, raw, s2, label: str):
    """Counts set to 0, one warm-up call and N_RUNS calls timed as
    ``bench_torch.py`` times them, counts read. Returns (last output,
    run seconds, counts)."""
    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats(raw.device)
    reset_launch_counts()
    out = plan(raw, s2, generator=plan.generator(0))
    torch.cuda.synchronize()
    del out
    times, out = bench_torch.timed_runs(plan, raw, s2, N_RUNS)
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(raw.device) / 1e9
    log(f"{label} runs (s): {[round(t, 4) for t in times]}; median "
        f"{statistics.median(times):.4f} s, min {min(times):.4f} s; peak "
        f"memory {peak_gb:.2f} GB")
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
    """Phase 5's accuracy metrics of one plan output
    (``bench_torch.accuracy_metrics``); ``gated`` fails below bench.py's
    gates, otherwise only finite fraction and max are checked (bench.py
    gates no other method than ot_poly)."""
    target = plan.s2_reference_10m(out["utm_cube"], s2)
    acc = bench_torch.accuracy_metrics(out["fused_10m"], target,
                                       out["coeffs"], method)
    finite_frac, fmax, psnr_db, method_psnr_db, sam_rad = acc
    log(f"{label} accuracy: pipeline PSNR {psnr_db:.3f} dB, SAM "
        f"{sam_rad:.6f} rad, method PSNR {method_psnr_db:.3f} dB, finite "
        f"frac {finite_frac:.4f}, max {fmax:.4f}; n_valid_60m "
        f"{int(out['n_valid_60m'])}; coeffs "
        f"{np.round(out['coeffs'].cpu().numpy(), 4).tolist()}")
    if not bench_torch.gates_met(acc, parametric=gated):
        fail(f"{label}: accuracy gates {bench_torch.GATES} not met")


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


def fuse_phase(dev, scene: dict, utm_cube, target) -> None:
    """Phase 5d (see the module docstring): ``fuse_pair`` by both engines
    on the scene's UTM cube (``utm_cube``, on the card) and S2 stack;
    ``target`` is the default plan's ``s2_reference_10m`` of them."""
    import warnings

    import torch
    from hyperres_torch.pipeline import fuse_pair

    products = {}
    for method, engine, synth in FUSE_RUNS:
        label = f"fuse_pair {method} engine={engine} synth={synth}"
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        warm = int(engine == "fused")
        for i in range(warm + (N_RUNS if warm else FUSE_PHASES_RUNS)):
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                # no measured SRF table is imported here: the resolver
                # says that it takes the parametric model
                warnings.filterwarnings("ignore", message=".*PARAMETRIC.*")
                res = fuse_pair(
                    utm_cube, scene["wavelengths"], scene["utm60"],
                    scene["s2_dn"], scene["s2_grid"],
                    good_mask=scene["good_mask"], s2_scale=1e-4,
                    s2_nodata=65535.0, fusion_method=method, engine=engine,
                    synth_method=synth)
            torch.cuda.synchronize()
            if i >= warm:
                times.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if res.info["engine"] != engine:
            fail(f"{label}: ran engine {res.info['engine']!r}")
        fused = torch.from_numpy(res.fused_10m).to(dev)
        coeffs = torch.from_numpy(res.coeffs.astype(np.float32)).to(dev)
        if tuple(fused.shape) != EXPECT_FUSED:
            fail(f"{label}: fused_10m {tuple(fused.shape)}, expected "
                 f"{EXPECT_FUSED}")
        parametric = method != "histogram"
        if parametric:
            finite_frac, fmax, psnr_db, method_psnr_db, sam_rad = (
                bench_torch.accuracy_metrics(fused, target, coeffs, method))
            acc = (f"pipeline PSNR {psnr_db:.3f} dB, SAM {sam_rad:.6f} rad, "
                   f"method PSNR {method_psnr_db:.3f} dB")
        else:
            vf = torch.isfinite(fused).all(dim=-1)
            finite_frac = float(vf.to(torch.float32).mean())
            fmax = float(torch.nan_to_num(fused, nan=-1.0).max())
            acc = "no parametric map (pipeline PSNR does not apply)"
        log(f"{label}: runs (s) {[round(t, 3) for t in times]}, median "
            f"{statistics.median(times):.3f} s; peak memory {peak_gb:.2f} GB "
            f"({base_gb:.2f} GB held before the call); {acc}; finite frac "
            f"{finite_frac:.4f}, max {fmax:.4f}; n_valid_60m "
            f"{res.info['n_valid_60m']}; stages {res.info['stages']}",
            keep=True)
        gates = bench_torch.GATES
        ok = finite_frac > gates["finite_frac_min"] and fmax <= gates["max_le"]
        if parametric:
            ok = (ok and psnr_db >= gates["psnr_db_min"]
                  and sam_rad <= gates["sam_rad_max"])
        if not ok:
            fail(f"{label}: accuracy gates {gates} not met")
        if synth == "srf":
            products[(method, engine)] = fused
        del fused, res
    def psnr_between(a, b) -> float:
        both = torch.isfinite(a).all(dim=-1) & torch.isfinite(b).all(dim=-1)
        d = torch.where(both[..., None], a - b, torch.zeros((), device=dev))
        mse = float(torch.sum(d.double() ** 2) / (both.sum() * 3))
        return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)

    for method in ("ot_poly", "linear", "histogram"):
        a, b = products[(method, "fused")], products[(method, "phases")]
        same_mask = float((torch.isfinite(a).all(dim=-1)
                           == torch.isfinite(b).all(dim=-1))
                          .to(torch.float32).mean())
        psnr_db = psnr_between(a, b)
        log(f"fuse_pair {method}: fused vs phases PSNR {psnr_db:.3f} dB "
            f"(gate {FUSED_PSNR_GATE}), mask agreement {same_mask:.6f}",
            keep=True)
        if not psnr_db >= FUSED_PSNR_GATE:
            fail(f"fuse_pair {method}: the fused and the phase-wise product "
                 f"disagree")


def taploop_phase(dev, scene: dict, raw, s2, base_utm, base_times) -> None:
    """Phase 5e (see the module docstring): the tap-loop plan beside the
    default plan (``base_utm`` its UTM cube, ``base_times`` its run
    seconds), then the generic two-pass warp with a nodata value against
    the gather kernels."""
    import torch
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.banded import KERNEL_NAMES
    from hyperres_torch.kernels.glt import glt_gather
    from hyperres_torch.kernels.host import scanline_cstar, source_index_field
    from hyperres_torch.kernels.stats import cube_psnr_sam, erode_mask
    from hyperres_torch.kernels.warp import (
        resample_tensor_to_grid, two_pass_src_ext, warp_interpolate,
        warp_interpolate_chunked, warp_two_pass,
    )

    tplan = bench_torch.build_plan(scene, dev, warp_kernel="taploop")
    out, times, counts = run_plan(tplan, raw, s2, "warp_kernel='taploop' plan")
    if any(name in counts for name in KERNEL_NAMES.values()):
        fail(f"the tap-loop plan launched the scanline kernel: {counts}")
    check_gates(tplan, out, s2, "warp_kernel='taploop' plan")
    warp_ms = {"taploop": cuda_ms(lambda: tplan.warp(raw), 2)}
    utm = out["utm_cube"]
    del out
    vf, p_db, s_rad = (float(v) for v in cube_psnr_sam(
        base_utm, utm, fill=NO_DATA_VALUE, erode=2))
    agree = float(((base_utm[..., 0] != NO_DATA_VALUE)
                   == (utm[..., 0] != NO_DATA_VALUE))
                  .to(torch.float32).mean())
    log(f"two-pass plan's utm_cube vs the tap-loop plan's: PSNR {p_db:.2f} "
        f"dB (gate {TAPLOOP_PSNR_GATE}), SAM {s_rad:.5f} rad, mask "
        f"agreement {agree:.6f} (> {TAPLOOP_MASK_AGREEMENT}), valid frac "
        f"{vf:.4f}; plan seconds: tap-loop median "
        f"{statistics.median(times):.4f}, two-pass median "
        f"{statistics.median(base_times):.4f}; the warp alone: tap-loop "
        f"{warp_ms['taploop']:.2f} ms ({tplan.warp_statics.row_chunks} row "
        f"chunks)", keep=True)
    if not (p_db >= TAPLOOP_PSNR_GATE and agree > TAPLOOP_MASK_AGREEMENT):
        fail("the two-pass plan's utm_cube departs from the tap-loop plan's")
    del utm

    # the generic two-pass warp with one validity channel per band
    ortho = glt_gather(raw, tplan._flat_idx, tplan._valid)
    del tplan
    grids = (scene["ortho_grid"], scene["utm60"])
    kw = dict(method="cubic", nodata=NO_DATA_VALUE, fill=NO_DATA_VALUE)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    got = resample_tensor_to_grid(ortho, *grids, **kw)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if counts != {name: 1 for name in KERNEL_NAMES.values()}:
        fail(f"resample_to_grid's auto rule should take warp_two_pass here "
             f"and launch each scanline pass once: {counts}")
    # both warps again on fields made once (the host's index fields and
    # scanline inversion are not the warps' time)
    rows_np, cols_np = source_index_field(*grids)
    rows, cols, cstar = (torch.from_numpy(a).to(dev) for a in (
        rows_np, cols_np, scanline_cstar(rows_np, cols_np, grids[0].height)))
    # the scanline kernel at this channel count against its plain version
    # on the warp's own inputs, both passes, every pixel
    src_ext = two_pass_src_ext(ortho, NO_DATA_VALUE)
    wide = compare_passes(src_ext, cstar, rows, "cubic", timed=False)
    for name, r in wide.items():
        log(f"{name} at {src_ext.shape[-1]} channels (src "
            f"{tuple(src_ext.shape)}, cubic) vs plain: max abs err "
            f"{r['max_abs_err']:.3e} (tol {KERNEL_TOL:g})", keep=True)
        if not r["max_abs_err"] <= KERNEL_TOL:
            fail(f"{name} disagrees with its plain version at "
                 f"{src_ext.shape[-1]} channels: {r['max_abs_err']:.3e}")
    del src_ext, wide
    ms = cuda_ms(lambda: warp_two_pass(ortho, rows, cols, cstar,
                                       nodata=NO_DATA_VALUE), 3)
    want = warp_interpolate_chunked(ortho, rows, cols, nodata=NO_DATA_VALUE,
                                    method="cubic", band_chunk=32)
    gather_ms = cuda_ms(lambda: warp_interpolate_chunked(
        ortho, rows, cols, nodata=NO_DATA_VALUE, method="cubic",
        band_chunk=32), 1)
    valid = (got != NO_DATA_VALUE).all(dim=-1) & (want != NO_DATA_VALUE).all(
        dim=-1)
    # where every tap of both warps reads a valid source the valid weight
    # mass is 1: the validity plane warped as data, 2 px inside its edge
    # (beside the swath's edge the signed cubic weights leave a small mass
    # to divide by, another one in each warp, and the quotients part)
    vplane = (ortho[..., :1] != NO_DATA_VALUE).to(torch.float32)
    mass = warp_interpolate(vplane, rows, cols, method="cubic",
                            fill=0.0)[..., 0]
    inner = erode_mask(((mass - 1.0).abs() <= 1e-6) & valid, 2)
    diff = (got - want).abs()
    err_in = float(diff[inner].max())
    err_all = float(diff[valid].max())
    fill_agree = float(((got == NO_DATA_VALUE) == (want == NO_DATA_VALUE))
                       .to(torch.float32).mean())
    log(f"warp_two_pass with nodata ({tuple(ortho.shape)} geographic -> "
        f"{tuple(got.shape)} UTM, {2 * ortho.shape[-1]} channels): launches "
        f"{counts}; vs the gather kernels where every tap is valid, 2 px "
        f"inside ({int(inner.sum())} of {int(valid.sum())} valid px) max abs "
        f"err {err_in:.3e} (tol {TWO_PASS_GATHER_TOL:g}), on all jointly "
        f"valid px {err_all:.3e}, "
        f"fill agreement {fill_agree:.6f}; {ms:.2f} ms against {gather_ms:.2f} "
        f"ms for the gather kernels in 32-band chunks; peak memory "
        f"{peak_gb:.2f} GB", keep=True)
    if not (err_in <= TWO_PASS_GATHER_TOL and int(inner.sum()) > 10 ** 6):
        fail("warp_two_pass with a nodata value departs from the gather "
             "kernels")


def verify_phase(dev, scene, out_dir) -> None:
    """Phase 12 (see the module docstring): ``verify_granule`` on the
    ortho phase's granule and S2 stack, on the default device."""
    import warnings

    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.banded import KERNEL_NAMES
    from hyperres_torch.verify import verify_granule

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*PARAMETRIC.*")
        res = verify_granule(scene.emit_nc_path, scene.s2_tif_path, out_dir)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(launch_counts)
    m = res.metrics
    log(f"verify_granule: {secs:.2f} s (total_seconds {m['total_seconds']}); "
        f"passed {res.passed}; cube shipped vs exact "
        f"{m['cube_shipped_vs_exact']}; fused shipped vs exact "
        f"{m['fused_shipped_vs_exact']}; pipeline audit "
        f"{m['pipeline_audit']}; method audit {m['method_audit']}; "
        f"coeffs_max_abs_delta {m['coeffs_max_abs_delta']}; shipped backend "
        f"{m['ortho_shipped_backend']}; launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", keep=True)
    log(f"verify_granule gates: {m['gates']}", keep=True)
    if not (res.json_path.exists() and res.report_path.exists()):
        fail("verify_granule wrote no report")
    if not res.passed:
        fail(f"verify_granule: passed is False at the default gates: "
             f"{m['gates']}")
    # the shipped ortho run folds ORTHO_CHUNKS chunks through both passes;
    # the exact run and both fusions launch no scanline kernel
    for name in KERNEL_NAMES.values():
        if counts.get(name, 0) != ORTHO_CHUNKS:
            fail(f"verify_granule: {name} launched {counts.get(name, 0)} "
                 f"times, expected {ORTHO_CHUNKS}")


def shifted_s2_stack(dev, cube, utm_grid, wavelengths, good, s2_tif,
                     out_tif) -> Path:
    """The pairs phase's S2 stack, made as tests/test_coreg.py:280 makes
    the stack of the reference's coregistration check at its calibrated
    default ``min_reliability``: the EMIT UTM cube (ortho phase)
    SRF-synthesized to the stack's 10 bands at 60 m and bilinearly
    upsampled to the stack's 10 m grid (``s2_tif``'s grid, descriptions,
    nodata 65535), 0 outside the swath; rolled by PAIRS_SHIFT (tgt(r, c)
    = src(r - dy, c - dx)) with nodata on the rolled-in edges; u16 x 1e4,
    written uncompressed.

    Why not the stack ``make_scene`` wrote: its world is smooth at the
    matching windows' 5 km, so no tie point passes CoregConfig()'s
    reliability gate; the EMIT-derived bands carry the granule's own 60 m
    texture. Why 0 outside the swath, as in the reference's check: the
    deshift's cubic weights beside nodata divide by a small mass and
    write codes near 65534 there, which the SR fit would take for valid
    inputs. The cube's fill and its cubic overshoot beside the swath's
    edge (values past [0, 1]) are left out of the upsample."""
    import torch
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.io.tiff import TiffReader, write_geotiff
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.kernels.warp import resample_tensor_to_grid
    from hyperres_torch.spectral.srf_tables import builtin_srf
    from hyperres_torch.testing.scenes import S2_CODE_TO_SHORT

    t0 = time.perf_counter()
    with TiffReader(s2_tif) as r:
        grid, descs = r.grid, r.descriptions
    srf = builtin_srf("S2A")
    shorts = [S2_CODE_TO_SHORT[str(d).split("_")[0]] for d in descs]
    W, _, _ = build_srf_weight_matrix(wavelengths, srf, good, bands=shorts)
    synth = cube @ torch.from_numpy(W).to(dev)
    bad = ((cube[..., 0] == NO_DATA_VALUE) | (synth < 0.0).any(dim=-1)
           | (synth > 1.0).any(dim=-1))
    synth[bad] = NO_DATA_VALUE
    x = resample_tensor_to_grid(synth, utm_grid, grid, method="bilinear",
                                nodata=NO_DATA_VALUE, fill=0.0)
    del synth
    dy, dx = PAIRS_SHIFT
    x = torch.roll(x, shifts=(dy, dx), dims=(0, 1))
    rows = slice(None, dy) if dy > 0 else slice(dy, None)
    cols = slice(None, dx) if dx > 0 else slice(dx, None)
    if dy:
        x[rows] = float("nan")
    if dx:
        x[:, cols] = float("nan")
    q = torch.clamp(torch.round(x * 10000.0), 0.0, 65534.0)
    q = torch.where(torch.isfinite(x), q.to(torch.int32), 65535)
    data = q.to(torch.uint16).permute(2, 0, 1).contiguous().cpu().numpy()
    del x, q
    write_geotiff(out_tif, data, grid, nodata=65535, descriptions=descs,
                  compress=None)
    log(f"pairs: S2 stack {data.shape} u16 from the UTM cube, shifted by "
        f"{PAIRS_SHIFT} px, {np.mean(data[0] != 65535):.3f} valid, written "
        f"uncompressed ({Path(out_tif).stat().st_size / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return Path(out_tif)


def pairs_phase(dev, scene, s2_tif, out_dir, card_line: str) -> dict:
    """Phase 13 (see the module docstring): ``run_pair_pipeline`` on
    phase 9's granule and the shifted S2 stack, coregistration and the SR
    product on, on the default device. Returns the run's launch counts."""
    import torch
    from hyperres_torch.core.config import (
        CoregConfig, OrthoConfig, PolyFusionConfig, RidgeSRConfig,
        TilingConfig,
    )
    from hyperres_torch.core.grid import Window
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.io.tiff import TiffReader
    from hyperres_torch.kernels.banded import KERNEL_NAMES
    from hyperres_torch.kernels.deshift_warp import \
        KERNEL_NAME as DESHIFT_NAME
    from hyperres_torch.kernels.sr_predict import KERNEL_NAME as SR_NAME
    from hyperres_torch.pipeline import run_pair_pipeline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_pair_pipeline(
        scene.emit_nc_path, s2_tif, out_dir, ortho_config=OrthoConfig(),
        fusion_config=PolyFusionConfig(), tiling_config=TilingConfig(),
        sr_config=RidgeSRConfig(), coreg_config=CoregConfig(),
        coregister=True, max_tiles=PAIRS_MAX_TILES, train_sr=True,
        predict_sr_cube=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    final = res.info["coreg"]["final"]
    log(f"run_pair_pipeline: {secs:.2f} s (total_seconds "
        f"{res.info['total_seconds']:.2f}); the one cut: max_tiles="
        f"{PAIRS_MAX_TILES}", keep=True)
    log(f"run_pair_pipeline stages (s): {res.info['stages']}", keep=True)
    log(f"run_pair_pipeline: peak memory {peak_gb:.2f} GB; launches "
        f"{counts}; {card_line}", keep=True)
    log(f"run_pair_pipeline coreg: {final}; attempts "
        f"{len(res.info['coreg']['attempts'])}", keep=True)
    if not final.get("success"):
        fail(f"run_pair_pipeline: coregistration failed: "
             f"{res.info['coreg']}")
    err = [abs(a - b) for a, b in zip(final["mean_shift_px"], PAIRS_SHIFT)]
    if not max(err) < PAIRS_SHIFT_TOL:
        fail(f"run_pair_pipeline: recovered shift {final['mean_shift_px']}, "
             f"injected {PAIRS_SHIFT} (tol {PAIRS_SHIFT_TOL} px)")
    fused = res.fusion.fused_10m
    ok = np.isfinite(fused).all(axis=-1)
    vals = fused[ok]
    log(f"run_pair_pipeline fusion: {fused.shape}, finite "
        f"{ok.mean():.4f}, range [{vals.min():.4f}, {vals.max():.4f}], "
        f"engine {res.fusion.info['engine']}, stages "
        f"{res.fusion.info['stages']}", keep=True)
    if not (ok.mean() > PAIRS_FINITE_MIN and vals.min() >= 0.0
            and vals.max() <= 1.0):
        fail("run_pair_pipeline: the fused product fails its checks")
    m = res.sr_metrics
    log(f"run_pair_pipeline tiles: {len(res.tiles)} written "
        f"({len(res.tile_records)} records); SR r2_mean {m['r2_mean']:.4f}, "
        f"rmse_mean {m['rmse_mean']:.5f}, {m['n_train_pixels']} train px, "
        f"predict {m['sr_predict_seconds']} s "
        f"({m['sr_predict_px_per_s']} px/s)", keep=True)
    if not (res.tiles and len(res.tile_records) == len(res.tiles)
            and res.run.local_manifest_csv.exists()):
        fail("run_pair_pipeline: no tiles, or records / manifest missing")
    if not m["r2_mean"] > PAIRS_R2_MIN:
        fail(f"run_pair_pipeline: SR r2_mean {m['r2_mean']} <= "
             f"{PAIRS_R2_MIN}")
    n_sr = len(m["band_indices"])
    with TiffReader(m["sr_cube_tif"]) as r:
        corner = r.read(window=Window(0, 0, min(512, r.width),
                                      min(512, r.height)))
        shape = (r.count, r.height, r.width)
    if not (shape[0] == n_sr and corner.dtype == np.uint16
            and shape[1:] == fused.shape[:2]):
        fail(f"emit_sr_10m.tif: {shape} {corner.dtype}, expected "
             f"({n_sr}, {fused.shape[0]}, {fused.shape[1]}) u16")
    text = res.report_path.read_text()
    missing = [h for h in PAIRS_SECTIONS if f"## {h}\n" not in text]
    if missing:
        fail(f"report.md lacks the sections {missing}")
    for name in KERNEL_NAMES.values():
        if counts.get(name, 0) < ORTHO_CHUNKS:
            fail(f"run_pair_pipeline: {name} launched {counts.get(name, 0)} "
                 f"times, expected >= {ORTHO_CHUNKS}")
    if counts.get(QUANT_NAME, 0) < 1:
        fail(f"run_pair_pipeline: {QUANT_NAME} never launched")
    if counts.get(SR_NAME, 0) != 1:
        fail(f"run_pair_pipeline: {SR_NAME} launched "
             f"{counts.get(SR_NAME, 0)} times, expected 1")
    if counts.get(DESHIFT_NAME, 0) != 1:
        fail(f"run_pair_pipeline: {DESHIFT_NAME} launched "
             f"{counts.get(DESHIFT_NAME, 0)} times, expected 1")
    return counts


def timed(dev, fn, warm: bool = True):
    """(result, host seconds around ``fn()`` and a synchronise, peak
    device GB during it); with ``warm`` after one untimed call (the
    first call of an op grows the allocator's pool)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(dev) / 1e9)


def counted(dev, fn, warm: bool = True):
    """``timed`` with the launch counts of the timed call: (result,
    seconds, peak GB, counts)."""
    from hyperres_torch.device import launch_counts, reset_launch_counts

    if warm:
        fn()
    reset_launch_counts()
    out, secs, peak = timed(dev, fn, warm=False)
    return out, secs, peak, dict(launch_counts)


def parallel_phase(dev, scene, utm_grid, s2_band, card_line: str) -> None:
    """Phase 14 (see the module docstring): the sharded ops of
    ``hyperres_torch.parallel`` on meshes of logical shards on the card,
    each against its single-device counterpart on the same inputs, both
    timed after a warm-up call (the streamed folds, host-bound, once)."""
    import torch
    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.io.ingest import stream_cube_fold
    from hyperres_torch.kernels import sr_predict as sp
    from hyperres_torch.kernels.banded import KERNEL_NAMES
    from hyperres_torch.kernels.host import (
        build_srf_weight_matrix, prepare_glt, scanline_cstar,
        source_index_field,
    )
    from hyperres_torch.kernels.stats import masked_percentile
    from hyperres_torch.kernels.warp import orthowarp_two_pass
    from hyperres_torch.ortho.pipeline import _warp_chunk_update
    from hyperres_torch.parallel import (
        data_parallel_ridge_fit, make_mesh, sharded_histogram_percentile,
        sharded_orthowarp_srf_2d, sharded_orthowarp_two_pass,
        sharded_streamed_orthowarp,
    )
    from hyperres_torch.parallel.ops import (
        min_two_pass_halo, sharded_sr_predict_u16,
    )
    from hyperres_torch.spectral.srf_tables import builtin_srf

    p1, p2 = KERNEL_NAMES[1], KERNEL_NAMES[0]

    def mesh(*shape, names=("data",)):
        return make_mesh(shape, names, devices=[dev] * int(np.prod(shape)))

    def report(label, secs, peak, single_s, extra=""):
        log(f"{label}: sharded {secs:.3f} s (peak {peak:.2f} GB), single "
            f"device {single_s:.3f} s{extra}; {card_line}", keep=True)

    def expect(label, counts, want):
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")

    g = EmitGranule(scene.emit_nc_path)
    shape = (g.raw_height, g.raw_width, g.n_bands)
    raw = torch.from_numpy(g.read_cube()).to(dev)
    flat, valid = prepare_glt(g.glt, shape[:2])
    rows, cols = source_index_field(g.ortho_grid, utm_grid)
    ho, hd = flat.shape[0], rows.shape[0]
    n = next((k for k in PAR_SHARDS if ho % k == 0 and hd % k == 0), None)
    pad = 0
    if n is None:
        n = next(k for k in PAR_SHARDS if hd % k == 0)
        pad = -ho % n
        flat = np.pad(flat, ((0, pad), (0, 0)))
        valid = np.pad(valid, ((0, pad), (0, 0)))
    ho_p = ho + pad
    halo = min_two_pass_halo(rows, ho_p, n)
    cstar = scanline_cstar(rows, cols, ho_p)
    flat, valid, rows, cols, cstar = (torch.from_numpy(a).to(dev) for a in
                                      (flat, valid, rows, cols, cstar))
    log(f"parallel: GLT grid Ho = {ho} ({ho_p} after {pad} invalid "
        f"scanlines), destination {hd}x{rows.shape[1]}, n = {n} shards, the "
        f"smallest halo that passes {halo}", keep=True)

    # the two-pass warp, one shot
    m1 = mesh(n)
    got, secs, peak, counts = counted(dev, lambda: sharded_orthowarp_two_pass(
        raw, flat, valid, rows, cols, cstar, m1, halo=halo))
    expect("sharded_orthowarp_two_pass", counts, {p1: n, p2: n})
    want, single_s, _ = timed(dev, lambda: orthowarp_two_pass(
        raw, flat, valid, rows, cols, cstar))
    err = float((got - want).abs().max())
    report(f"sharded_orthowarp_two_pass {tuple(got.shape)}", secs, peak,
           single_s, f", max abs diff {err:.3e} (tol {PAR_WARP_TOL:g}), "
           f"bit-equal {bool(torch.equal(got, want))}, launches {counts}")
    if not err <= PAR_WARP_TOL:
        fail("the sharded two-pass warp departs from the single-device one")
    del got

    # the 2-D (row x band) mesh: the warp and the SRF product
    W, _, _ = build_srf_weight_matrix(np.asarray(g.wavelengths),
                                      builtin_srf("S2A"), g.good_wavelengths)
    Wt = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(dev)
    m2 = mesh(n, PAR_BAND_SHARDS, names=("row", "band"))
    got, secs, peak, counts = counted(dev, lambda: sharded_orthowarp_srf_2d(
        raw, flat, valid, rows, cols, cstar, Wt, m2, halo=halo))
    k = n * PAR_BAND_SHARDS
    expect("sharded_orthowarp_srf_2d", counts, {p1: k, p2: k})
    ref, single_s, _ = timed(dev, lambda: (orthowarp_two_pass(
        raw, flat, valid, rows, cols, cstar).reshape(-1, shape[2]) @ Wt)
        .reshape(got.shape))
    d = (got - ref).abs()
    rel = float((d / ref.abs().clamp(min=1.0)).max())
    report(f"sharded_orthowarp_srf_2d {n}x{PAR_BAND_SHARDS} -> "
           f"{tuple(got.shape)}", secs, peak, single_s,
           f" (the warp and torch.matmul), max abs diff "
           f"{float(d.max()):.3e}, {rel:.3e} of max(|v|, 1) (tol "
           f"{PAR_SRF_TOL:g}), launches {counts}")
    if not rel <= PAR_SRF_TOL:
        fail("the 2-D mesh's synthesis departs from warp + matmul")
    del got, ref, d, want, raw
    torch.cuda.empty_cache()

    # the streamed fold (u16), sharded and on one device
    got, secs, peak, counts = counted(dev, lambda: sharded_streamed_orthowarp(
        g.read_bands, shape, flat, valid, rows, cols, cstar, m1, halo=halo,
        transfer="u16", chunk_bands=PAR_CHUNK_BANDS, depth=3), warm=False)
    chunks = -(-shape[2] // PAR_CHUNK_BANDS)
    expect("sharded_streamed_orthowarp", counts,
           {p1: n * chunks, p2: n * chunks})

    def single_fold():
        utm0 = torch.full(tuple(rows.shape) + (shape[2],), NO_DATA_VALUE,
                          dtype=torch.float32, device=dev)
        return stream_cube_fold(
            g.read_bands, shape, lambda u, p, b0: _warp_chunk_update(
                u, p, b0, flat, valid, rows, cols, cstar, "cubic", "u16",
                "auto"), utm0, transfer="u16", chunk_bands=PAR_CHUNK_BANDS,
            depth=3, payload_mode=True, device=dev)

    want, single_s, _ = timed(dev, single_fold, warm=False)
    err = float((got - want).abs().max())
    report(f"sharded_streamed_orthowarp (u16, {chunks} chunks)", secs, peak,
           single_s, f", max abs diff {err:.3e} (tol {PAR_WARP_TOL:g}), "
           f"bit-equal {bool(torch.equal(got, want))}, launches {counts}")
    if not err <= PAR_WARP_TOL:
        fail("the sharded streamed fold departs from the single-device one")
    del got, want, flat, valid, rows, cols, cstar
    g.close()
    torch.cuda.empty_cache()

    # SR serving on the product's model: 3 shards, one kernel launch each
    training_data = script("torch_bench_sr_granule").training_data
    Xt, Yt = training_data(np.random.default_rng(0))
    model = RidgeSpectralSR(SR_BX, SR_BY, RidgeSRConfig(degree=SR_DEGREE),
                            device=dev).fit(Xt, Yt)
    n_px = SR_SHAPE[1] * SR_SHAPE[2]
    gen = torch.Generator(device=dev).manual_seed(9)
    X = torch.rand((n_px, SR_BX), generator=gen, device=dev)
    ok = torch.ones(n_px, dtype=torch.bool, device=dev)
    ok[:n_px // 20] = False
    m3 = mesh(PAR_SR_SHARDS)
    got, secs, peak, counts = counted(dev, lambda: sharded_sr_predict_u16(
        model, X, ok, m3, engine="pallas"))
    expect("sharded_sr_predict_u16", counts, {sp.KERNEL_NAME: PAR_SR_SHARDS})
    want, single_s, _ = timed(dev, lambda: sp.sr_predict_u16(
        X, model.x_mean, model.x_std, model.W, model.intercept,
        model.factors, layout="rowmajor", valid=ok))
    bad = n_differ(got, want)
    report(f"sharded_sr_predict_u16 (engine='pallas', {n_px} px x "
           f"{SR_BX} -> {SR_BY})", secs, peak, single_s,
           f", {bad} codes differ (bit-equal required), launches {counts}")
    if bad:
        fail("the sharded SR codes differ from one kernel call's")
    del got, want, X, ok, model

    # the distributed percentile on one 10 m S2 band
    x = torch.from_numpy(s2_band.astype(np.float32)).to(dev)
    mask = x > 0
    m4 = mesh(PAR_STAT_SHARDS)
    got, secs, peak = timed(dev, lambda: sharded_histogram_percentile(
        x, mask, PAR_QS, m4))
    want, single_s, _ = timed(dev, lambda: masked_percentile(x, mask,
                                                             PAR_QS))
    span = float(x[mask].max() - x[mask].min())
    err = float((got.cpu() - want.cpu()).abs().max())
    report(f"sharded_histogram_percentile q {PAR_QS} on {tuple(x.shape)} "
           f"u16 px", secs, peak, single_s,
           f" (exact masked_percentile), {got.tolist()} vs {want.tolist()}, "
           f"max abs err {err:.4f} (bound 2 * range / 2048 = "
           f"{2 * span / 2048:.4f})")
    if not err < 2 * span / 2048:
        fail("the sharded percentile misses its bound")
    del x, mask

    # the data-parallel fit against the single-device fit
    Xf, Yf = training_data(np.random.default_rng(1), PAR_FIT_PX)
    cfg = RidgeSRConfig(degree=SR_DEGREE)
    multi, secs, peak = timed(dev, lambda: data_parallel_ridge_fit(
        RidgeSpectralSR(SR_BX, SR_BY, cfg, device=dev), Xf, Yf, m4))
    single, single_s, _ = timed(dev, lambda: RidgeSpectralSR(
        SR_BX, SR_BY, cfg, device=dev).fit(Xf, Yf))
    err = float((multi.W - single.W).abs().max())
    report(f"data_parallel_ridge_fit ({PAR_FIT_PX} px, {PAR_STAT_SHARDS} "
           f"shards, F = {single.n_features})", secs, peak, single_s,
           f", W max abs diff {err:.3e} (tol {PAR_FIT_TOL:g})")
    if not err <= PAR_FIT_TOL:
        fail("the data-parallel fit departs from the single-device fit")


def batch_phase(dev, workdir: Path, card_line: str) -> None:
    """Phase 15 (see the module docstring): ``BatchPairDriver`` over three
    reduced ``make_scene`` pairs on two worker threads on the card."""
    import torch
    from hyperres_torch.batch import BatchPairDriver, PairJob
    from hyperres_torch.core.config import TilingConfig
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.banded import KERNEL_NAMES
    from hyperres_torch.testing.scenes import make_scene

    t0 = time.perf_counter()
    scenes = [make_scene(workdir / f"scene{i}", raw_shape=BATCH_RAW,
                         n_bands=ORTHO_BANDS, s2_size=BATCH_S2, seed=i,
                         compress_granule=False) for i in range(3)]
    log(f"batch: 3 scenes {BATCH_RAW + (ORTHO_BANDS,)}, S2 {BATCH_S2} px, "
        f"made in {time.perf_counter() - t0:.1f} s")
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
    devices = [dev] * BATCH_WORKERS
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    manifest = driver.run(jobs, devices=devices)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(launch_counts)
    ids = sorted(spans)
    overlap = max([min(spans[a][1], spans[b][1]) - max(spans[a][0],
                                                       spans[b][0])
                   for i, a in enumerate(ids) for b in ids[i + 1:]],
                  default=0.0)
    status = {k: v["status"] for k, v in manifest.items()}
    used = {a["device"] for v in manifest.values() for a in v["attempts"]}
    log(f"batch: {len(jobs)} pairs on {BATCH_WORKERS} workers in {secs:.2f} "
        f"s; pipeline seconds {[round(s[1] - s[0], 2) for s in spans.values()]}"
        f"; longest overlap of two {overlap:.2f} s; statuses {status}; "
        f"devices {sorted(used)}; launches {counts}; {card_line}", keep=True)
    if set(status.values()) != {"done"} or overlap <= 0.0:
        fail("batch: a pair is not done, or no two pipelines overlapped")
    if used != {str(dev)}:
        fail(f"batch: attempts recorded devices {used}, expected {dev}")
    for name in KERNEL_NAMES.values():
        if counts.get(name, 0) < len(jobs):
            fail(f"batch: {name} launched {counts.get(name, 0)} times for "
                 f"{len(jobs)} pairs")
    # resume: nothing runs again
    calls = []
    driver.runner = lambda job, d: calls.append(job.pair_id) or {}
    driver.run(jobs, devices=devices)
    # a job whose granule is missing fails after its retries, the rest stay
    missing = PairJob("missing", str(workdir / "nope.nc"),
                      str(scenes[0].s2_tif_path))
    driver.runner = base
    manifest = driver.run(jobs + [missing], devices=devices)
    status = {k: v["status"] for k, v in manifest.items()}
    tries = [a["attempt"] for a in manifest["missing"]["attempts"]]
    log(f"batch: resume ran {calls}; with a missing granule: statuses "
        f"{status}, its attempts {tries}, error "
        f"{manifest['missing']['attempts'][-1]['error']!r}", keep=True)
    if calls or status != {"pair0": "done", "pair1": "done", "pair2": "done",
                           "missing": "failed"} or tries != [1, 2]:
        fail("batch: resume ran a pair again, or the missing granule was not "
             "recorded as failed after two attempts")


def cli_phase(workdir: Path, card_line: str) -> None:
    """Phase 16 (see the module docstring): ``python -m hyperres_torch``
    subcommands in subprocesses on the card."""
    import os

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))

    def start(*argv):
        return subprocess.Popen(
            [sys.executable, "-m", "hyperres_torch", *argv], cwd=repo,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def finish(name, proc):
        try:
            out, err = proc.communicate(timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"cli {name}: no exit within {CLI_TIMEOUT} s")
        return proc.returncode, out, err

    t0 = time.perf_counter()
    sc = workdir / "scene"
    rc, out, err = finish("scene", start("scene", str(sc), *CLI_SCENE))
    if rc != 0:
        fail(f"cli scene: exit {rc}: {err[-2000:]}")
    doc = json.loads(out)
    nc, s2 = doc["emit_nc"], doc["s2_tif"]
    jobs = workdir / "jobs.json"
    jobs.write_text(json.dumps([{"pair_id": "p1", "emit_nc_path": nc,
                                 "s2_stack_tif": s2}]))
    procs = {
        "ortho": start("ortho", nc, str(workdir / "ortho"), "--s2", s2),
        "fuse": start("fuse", nc, s2, str(workdir / "fuse"), "--tile-size",
                      "16", "--max-tiles", "2"),
        "batch": start("batch", str(jobs), str(workdir / "batch")),
        "verify-granule": start("verify-granule", nc, s2,
                                str(workdir / "verify")),
        "info": start("info", s2),
        "quicklook": start("quicklook", nc, str(workdir / "q.html")),
    }
    results = {name: finish(name, p) for name, p in procs.items()}
    secs = time.perf_counter() - t0
    for name, (rc, out, err) in results.items():
        if name == "info":
            ok = rc == 0 and Path(s2).name in out
        elif name == "quicklook":
            ok = rc == 0 and Path(out.strip()).exists()
        else:
            try:
                doc = json.loads(out)
            except json.JSONDecodeError:
                fail(f"cli {name}: stdout is not JSON (exit {rc}): "
                     f"{out[-500:]} {err[-2000:]}")
            ok = rc == 0 or (name == "verify-granule" and rc == 1
                             and doc["passed"] is False)
        log(f"cli {name}: exit {rc}", keep=False)
        if not ok:
            fail(f"cli {name}: exit {rc}: {out[-500:]} {err[-2000:]}")
    log(f"cli: scene, then ortho, fuse, batch, verify-granule, info and "
        f"quicklook in parallel processes on the card: {secs:.1f} s, exit "
        f"codes {[r[0] for r in results.values()]}; {card_line}", keep=True)


def toolkit_phase(dev, scene, workdir: Path, card_line: str) -> None:
    """Phase 17a (see the module docstring): the granule toolkit at full
    width on phase 9's granule and a second, partly overlapping one."""
    import dataclasses

    import torch
    from hyperres_torch.catalog.geometry import LonLatPolygon
    from hyperres_torch.core.constants import GLT_NODATA_VALUE, NO_DATA_VALUE
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.kernels.glt import orthorectify
    from hyperres_torch.kernels.warp import resample_tensor_to_grid
    from hyperres_torch.ortho.toolkit import (
        merge_emit, ortho_browse, spatial_subset,
    )
    from hyperres_torch.testing.scenes import make_scene

    t0 = time.perf_counter()
    cx, cy = scene.swath_center_utm
    half = TOOLKIT_S2_PX * 10.0 / 2.0
    scene2 = make_scene(
        workdir / "scene2", raw_shape=ORTHO_RAW, n_bands=ORTHO_BANDS,
        compress_granule=False, s2_size=TOOLKIT_S2_PX, seed=TOOLKIT_SEED,
        s2_origin=(cx + TOOLKIT_SHIFT_M[0] - half,
                   cy + TOOLKIT_SHIFT_M[1] + half))
    log(f"toolkit: second granule {ORTHO_RAW + (ORTHO_BANDS,)} (seed "
        f"{TOOLKIT_SEED}, swath centre {TOOLKIT_SHIFT_M} m from the first) "
        f"made in {time.perf_counter() - t0:.1f} s")
    with EmitGranule(scene.emit_nc_path) as g1, \
            EmitGranule(scene2.emit_nc_path) as g2:
        gs = [g1, g2]
        # -- merge_emit on the card, cold then warm --------------------------
        torch.cuda.empty_cache()
        reset_launch_counts()
        (mosaic, grid), cold, _ = timed(dev, lambda: merge_emit(gs),
                                        warm=False)
        (again, _), warm, peak = timed(dev, lambda: merge_emit(gs),
                                       warm=False)
        counts = dict(launch_counts)
        valid = mosaic[..., 0] != NO_DATA_VALUE
        # the first granule's cells, placed as merge_emit places them:
        # the mosaic's other valid cells are the second granule's
        band0 = orthorectify(g1.read_bands(0, 1), g1.glt, device=dev)
        first = (resample_tensor_to_grid(
            band0, g1.ortho_grid, grid, method="nearest",
            nodata=NO_DATA_VALUE, fill=NO_DATA_VALUE)[..., 0]
            != NO_DATA_VALUE).cpu().numpy()
        del band0
        share2 = float((valid & ~first).mean())
        log(f"toolkit: merge_emit of 2 granules on the card: cold "
            f"{cold:.3f} s, warm {warm:.3f} s (host reads included; "
            f"synchronised), peak {peak:.2f} GB; mosaic {mosaic.shape} "
            f"{mosaic.dtype} ({mosaic.nbytes / 1e9:.2f} GB) at "
            f"{grid.dx:.3e} x {grid.dy:.3e} deg; valid {valid.mean():.4f}, "
            f"filled by the second granule {share2:.4f}; launches "
            f"{counts}; {card_line}", keep=True)
        if not np.array_equal(mosaic, again):
            fail("toolkit: two merge_emit runs on the card differ")
        del again
        if mosaic.shape != (grid.height, grid.width, ORTHO_BANDS) or not (
                valid.mean() > 0.3 and share2 > 0.05):
            fail("toolkit: the mosaic's shape or coverage is wrong")
        t0 = time.perf_counter()
        cpu, cgrid = merge_emit(gs, device="cpu")
        secs = time.perf_counter() - t0
        same = bool(np.array_equal(mosaic, cpu))
        log(f"toolkit: merge_emit(device='cpu') on the same granules "
            f"{secs:.3f} s; array_equal to the card's {same}, same grid "
            f"{dataclasses.astuple(cgrid) == dataclasses.astuple(grid)}",
            keep=True)
        if secs > TOOLKIT_CPU_LIMIT_S:
            log(f"toolkit: the CPU run took over {TOOLKIT_CPU_LIMIT_S} s")
        if not same or dataclasses.astuple(cgrid) != dataclasses.astuple(
                grid):
            fail("toolkit: the card's mosaic differs from the CPU run's")
        del cpu, mosaic, valid, first

        # -- spatial_subset over about half the footprint --------------------
        og = g1.ortho_grid
        le, b, r, t = og.bounds
        mx, my = (le + r) / 2, (b + t) / 2
        hx, hy = (r - le) * TOOLKIT_SUBSET_HALF, (t - b) * TOOLKIT_SUBSET_HALF
        poly = LonLatPolygon.from_bounds(mx - hx, my - hy, mx + hx, my + hy)
        t0 = time.perf_counter()
        sub = spatial_subset(g1, poly)
        t_sub = time.perf_counter() - t0
        xs, ys = og.pixel_center_coords()
        lon, lat = np.meshgrid(xs, ys)
        gvalid = np.all(g1.glt != GLT_NODATA_VALUE, axis=-1)
        share = float((gvalid & poly.contains_points(lon, lat)).sum()
                      / gvalid.sum())
        full = orthorectify(g1.read_cube(), g1.glt, device=dev)
        t0 = time.perf_counter()
        so = orthorectify(sub.data, sub.glt, device=dev)
        torch.cuda.synchronize()
        t_so = time.perf_counter() - t0
        oy0 = round((og.y0 - sub.ortho_grid.y0) / og.dy)
        ox0 = round((sub.ortho_grid.x0 - og.x0) / og.dx)
        crop = full[oy0:oy0 + sub.ortho_grid.height,
                    ox0:ox0 + sub.ortho_grid.width]
        ok = so[..., 0] != NO_DATA_VALUE
        equal = bool(torch.equal(so[ok], crop[ok]))
        log(f"toolkit: spatial_subset over {share:.4f} of the footprint: "
            f"{t_sub:.3f} s, raw window {sub.raw_window}, data "
            f"{sub.data.shape}, ortho grid {sub.ortho_grid.height}x"
            f"{sub.ortho_grid.width}; its ortho on the card {t_so:.3f} s "
            f"equals the full ortho's crop on all {int(ok.sum())} valid "
            f"cells: {equal}", keep=True)
        if not (equal and 0.3 < share < 0.7 and int(ok.sum()) > 0):
            fail("toolkit: the subset's ortho differs from the full ortho's "
                 "crop, or the polygon misses half the footprint")
        del full, so, crop, ok, sub

        # -- ortho_browse of a u8 RGB ----------------------------------------
        wl = np.asarray(g1.wavelengths)
        idx = [int(np.argmin(np.abs(wl - w))) for w in (650.0, 560.0, 470.0)]
        rgb = np.concatenate([g1.read_bands(i, i + 1) for i in idx], axis=-1)
        rgb = np.clip(rgb / 0.4 * 255.0, 0, 255).astype(np.uint8)
        t0 = time.perf_counter()
        browse = ortho_browse(rgb, g1.glt)
        t_b = time.perf_counter() - t0
        want = orthorectify(rgb.astype(np.float32), g1.glt, fill_value=0.0,
                            device=dev).clamp(0, 255).to(torch.uint8)
        same = bool(np.array_equal(browse, want.cpu().numpy()))
        log(f"toolkit: ortho_browse of a u8 RGB {rgb.shape}: {t_b:.3f} s, "
            f"{browse.shape} {browse.dtype}, equal to the card's gather "
            f"{same}")
        if not same or browse.dtype != np.uint8:
            fail("toolkit: ortho_browse differs from the card's gather")
    torch.cuda.empty_cache()


def catalog_setup(scene, workdir: Path) -> dict:
    """Phase 17b's set-up (see the module docstring), host only: the
    canned CMR pages and STAC items, the SCL rasters, and what the
    whole-file counts say of each SCL. ``main`` runs it in a thread
    beside phase 17a; ``catalog_phase`` takes its result."""
    import datetime as dt

    from hyperres_torch.catalog import (
        LonLatPolygon, emit_geom_wgs84_from_umm, overlap_emit_fraction,
    )
    from hyperres_torch.core.constants import SCL_CLOUD_CLASSES
    from hyperres_torch.core.grid import Grid
    from hyperres_torch.io.tiff import TiffReader, write_geotiff

    t_all = time.perf_counter()
    utm = scene.utm_crs
    x0, y0, res, n = CATALOG_TILE
    tile = Grid(utm, x0, y0, res, res, n, n)
    t0_day = dt.datetime(2023, 6, 1, tzinfo=dt.timezone.utc)

    def iso(d):
        return d.isoformat().replace("+00:00", "Z")

    def lonlat(xs, ys):
        lon, lat = utm.to_geographic(np.asarray(xs), np.asarray(ys))
        return [[float(a), float(b)] for a, b in zip(lon, lat)]

    # EMIT footprint: the raw swath's corners, as a UMM GPolygon
    h, w = ORTHO_RAW
    rx, ry = scene.raw_pixel_utm(np.array([0, 0, h - 1, h - 1]),
                                 np.array([0, w - 1, w - 1, 0]))
    ring = lonlat(rx, ry)
    ring.append(ring[0])
    umm_geo = {"HorizontalSpatialDomain": {"Geometry": {"GPolygons": [{
        "Boundary": {"Points": [{"Longitude": a, "Latitude": b}
                                for a, b in ring]}}]}}}
    rng = np.random.default_rng(17)
    emit_items = []
    for day in range(1, CATALOG_DATES + 1):
        for k in range(2):
            if day in CATALOG_MATCH_DAYS and k == 0:
                hour = 9.0 + rng.random()          # in the ToD window
            else:
                hour = 12.5 + 8.0 * rng.random()   # out of it
            begin = t0_day + dt.timedelta(days=day, hours=hour)
            emit_items.append({
                "meta": {"native-id": f"EMIT_{day:02d}_{k}"},
                "umm": {"GranuleUR": f"EMIT_{day:02d}_{k}",
                        "CloudCover": float(10 + 40 * k + rng.integers(0, 9)),
                        "TemporalExtent": {"RangeDateTime": {
                            "BeginningDateTime": iso(begin)}},
                        "SpatialExtent": umm_geo}})

    def tile_item(item_id, day, xa, xb, scl_day):
        xs = [x0 + xa * n * res, x0 + xb * n * res]
        c = lonlat([xs[0], xs[1], xs[1], xs[0]],
                   [y0, y0, y0 - n * res, y0 - n * res])
        lons, lats = [p[0] for p in c], [p[1] for p in c]
        return {"id": item_id,
                "properties": {"datetime": iso(t0_day + dt.timedelta(
                    days=day, hours=10)), "eo:cloud_cover": 30.0},
                "bbox": [min(lons), min(lats), max(lons), max(lats)],
                "geometry": {"type": "Polygon", "coordinates": [c + [c[0]]]},
                "assets": {"scl": {"href": f"canned://scl/{scl_day:02d}.tif"},
                           "scl-jp2": {"href": f"canned://jp2/{item_id}"}}}

    s2_items = []
    for day in range(0, CATALOG_DATES + 4):
        if day % 5 == 0:
            s2_items.append(tile_item(f"S2_T33_{day:02d}_full", day, 0.0,
                                      1.0, day))
        elif day % 5 in (2, 4):   # partial strips, two baselines each
            xa, xb = (0.0, 0.4) if day % 5 == 2 else (0.6, 1.0)
            for base in (0, 1):
                s2_items.append(tile_item(f"S2_T33_{day:02d}_strip_{base}",
                                          day, xa, xb, 5 * (day // 5)))
    cat = workdir / "canned"
    (cat / "cmr").mkdir(parents=True)
    (cat / "scl").mkdir()
    (cat / "cmr" / "page_1.json").write_text(json.dumps(
        {"items": emit_items}))
    (cat / "stac_items.json").write_text(json.dumps(s2_items))

    # SCL rasters of the full-tile acquisitions: land classes per pixel,
    # clouds in 640 m cells at each acquisition's share, a nodata corner
    t0 = time.perf_counter()
    cells = -(-n // 32)
    land_of = np.repeat(np.array([4, 5, 6, 7], np.uint8), [55, 25, 10, 10])
    ii = np.arange(n)
    corner = (ii[:, None] + (n - ii)[None, :]) < n // 8
    scl_paths = {}
    for day, frac in CATALOG_CLOUD.items():
        r = np.random.default_rng(day)
        cloud = np.where(r.random((cells, cells)) < frac,
                         r.integers(8, 11, (cells, cells), dtype=np.uint8), 0)
        cloud = np.repeat(np.repeat(cloud, 32, 0), 32, 1)[:n, :n]
        scl = np.where(cloud > 0, cloud,
                       land_of[r.integers(0, 100, (n, n), dtype=np.uint8)])
        scl[corner] = 0
        scl_paths[day] = write_geotiff(
            cat / "scl" / f"{day:02d}.tif", scl[None], tile, nodata=0,
            tiled=True, blockxsize=CATALOG_BLOCK, blockysize=CATALOG_BLOCK)
    t_scl = time.perf_counter() - t0

    # what whole-file reads of each SCL say: the cloud share over the
    # overlap of the footprint and the tile
    emit_geom = emit_geom_wgs84_from_umm(emit_items[0]["umm"])
    _, roi = overlap_emit_fraction(
        emit_geom, LonLatPolygon.from_geojson(s2_items[0]["geometry"]))
    xs, ys = tile.pixel_center_coords()
    gx, gy = np.meshgrid(xs, ys)
    lon, lat = utm.to_geographic(gx, gy)
    mask = roi.contains_points(np.asarray(lon), np.asarray(lat))
    del gx, gy, lon, lat
    expected = {}
    for day, p in scl_paths.items():
        with TiffReader(p) as rd:
            a = rd.read()[0]
        valid = mask & (a != 0)
        clouds = int((valid & np.isin(a, SCL_CLOUD_CLASSES)).sum())
        expected[day] = clouds / int(valid.sum())
    return {"t0_day": t0_day, "iso": iso, "cat": cat, "tile": tile,
            "emit_items": emit_items, "s2_items": s2_items,
            "emit_geom": emit_geom, "scl_paths": scl_paths,
            "expected": expected, "t_scl": t_scl, "workdir": workdir,
            "seconds": time.perf_counter() - t_all}


def catalog_phase(setup: dict, card_line: str) -> None:
    """Phase 17b (see the module docstring): ``discover_pairs`` over the
    canned responses and SCL rasters of :func:`catalog_setup`, host
    only, every fetch through the clients' injected callables."""
    import datetime as dt
    import shutil

    from hyperres_torch.catalog import (
        CmrClient, StacClient, discover_pairs, open_remote_scl,
    )
    from hyperres_torch.catalog.clients import CMR_GRANULE_SEARCH
    from hyperres_torch.core.config import PairSearchConfig
    from hyperres_torch.io.tiff import TiffReader

    t_all = time.perf_counter()
    cfg = PairSearchConfig()
    cat, t0_day, iso = setup["cat"], setup["t0_day"], setup["iso"]
    scl_paths, expected = setup["scl_paths"], setup["expected"]
    sizes = {d: p.stat().st_size for d, p in scl_paths.items()}
    log(f"catalog: {len(setup['emit_items'])} EMIT granules over "
        f"{CATALOG_DATES} dates, {len(setup['s2_items'])} S2 items, "
        f"{len(scl_paths)} SCL rasters {setup['tile'].height}x"
        f"{setup['tile'].width} u8 ({sum(sizes.values()) / 1e6:.1f} MB "
        f"deflate) written in {setup['t_scl']:.1f} s; set-up with the "
        f"whole-file counts {setup['seconds']:.1f} s, beside phase 17a")

    def path_of(href):
        return scl_paths[int(href.rsplit("/", 1)[-1][:2])]

    fetched = {"json": 0, "download": [], "range_bytes": 0}

    def fetch_json(url, params=None, method="GET", body=None, **kw):
        fetched["json"] += 1
        if url == CMR_GRANULE_SEARCH:
            page = cat / "cmr" / f"page_{params['page_num']}.json"
            return json.loads(page.read_text()) if page.exists() else {
                "items": []}
        lo, hi = body["datetime"].split("/")
        bl, bb, br, bt = body["bbox"]
        keep = [it for it in json.loads((cat / "stac_items.json").read_text())
                if lo <= it["properties"]["datetime"] <= hi
                and it["bbox"][0] <= br and it["bbox"][2] >= bl
                and it["bbox"][1] <= bt and it["bbox"][3] >= bb]
        return {"features": keep, "links": []}

    def download(url, dst):
        fetched["download"].append(url)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path_of(url), dst)
        return dst

    t0 = time.perf_counter()
    pairs = discover_pairs(
        cmr=CmrClient(fetch_json=fetch_json, download=download),
        stac=StacClient(cfg.stac_api, fetch_json=fetch_json,
                        download=download),
        bbox=setup["emit_geom"].bounds(),
        temporal=(iso(t0_day), iso(t0_day + dt.timedelta(
            days=CATALOG_DATES + 1))),
        config=cfg, workdir=setup["workdir"] / "scl_cache")
    t_pairs = time.perf_counter() - t0
    n_dl = len(fetched["download"])
    picks = [(p["date"], p["s2_item"]["id"], round(p["cloud_frac"], 4))
             for p in pairs if p["s2_item"]]
    log(f"catalog: discover_pairs {t_pairs:.2f} s ({fetched['json']} JSON "
        f"fetches, {n_dl} SCL downloads counted over the overlap, "
        f"{t_pairs / max(n_dl, 1):.2f} s a download); {len(pairs)} dates, "
        f"kept {[p['date'] for p in pairs if p['kept']]}; picks {picks}",
        keep=True)

    # the pairs that the whole-file counts say discover_pairs should keep:
    # on each match day, the full-tile acquisition in the days window
    # (the S2 time, 10:00, lies past the window's end on its last day)
    # with the lowest cloud share, kept within max_s2_cloud_frac
    want = {}
    for day in CATALOG_MATCH_DAYS:
        date = (t0_day + dt.timedelta(days=day)).date().isoformat()
        cands = [d for d in expected if abs(d - day) <= cfg.days_window
                 and d != day + cfg.days_window]
        best = min(cands, key=lambda d: expected[d])
        want[date] = (f"S2_T33_{best:02d}_full", expected[best],
                      expected[best] <= cfg.max_s2_cloud_frac)
    got = {p["date"]: (p["s2_item"]["id"], p["cloud_frac"], p["kept"])
           for p in pairs if p["s2_item"] is not None}
    dates = sorted({(t0_day + dt.timedelta(days=d)).date().isoformat()
                    for d in range(1, CATALOG_DATES + 1)})
    log(f"catalog: whole-file counts "
        f"{ {d: round(f, 4) for d, f in sorted(expected.items())} }; "
        f"expected picks {want}")
    if (got != want or [p["date"] for p in pairs] != dates
            or any(p["kept"] for p in pairs if p["date"] not in want)):
        fail(f"catalog: discover_pairs kept {got}, the whole-file counts "
             f"say {want}")

    # open_remote_scl's ranged reads of the SCL rasters discover_pairs
    # counted, against whole-file reads
    def fetch_range(url, start, end):
        with open(path_of(url), "rb") as f:
            f.seek(start)
            blob = f.read(end - start + 1)
        fetched["range_bytes"] += len(blob)
        return blob

    t0 = time.perf_counter()
    for url in fetched["download"]:
        arr, grid = open_remote_scl(url, fetch_range=fetch_range)
        with TiffReader(path_of(url)) as rd:
            whole = rd.read()[0]
        if not (np.array_equal(arr, whole) and grid == rd.grid
                == setup["tile"]):
            fail(f"catalog: open_remote_scl of {url} differs from the "
                 f"whole read")
    t_rng = time.perf_counter() - t0
    size = sum(path_of(u).stat().st_size for u in fetched["download"])
    log(f"catalog: open_remote_scl of {n_dl} SCL rasters {t_rng:.2f} s, "
        f"equal to whole reads; {fetched['range_bytes']} bytes fetched for "
        f"{size} bytes of files; phase 17b {time.perf_counter() - t_all:.1f} "
        f"s after its set-up; {card_line}", keep=True)


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
    granule's wavelengths and good-band mask, the u16 run's launch
    counts, and the scene (``scene``: the granule and the S2 stack on
    disk)."""
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
                       s2_size=VERIFY_S2_SIZE, seed=VERIFY_SCENE_SEED)
    s2 = scene.s2_grid
    cx, cy = scene.swath_center_utm
    half = S2_TILE_PX * 10.0 / 2.0
    tile = Grid(s2.crs, s2.x0 + 60.0 * round((cx - half - s2.x0) / 60.0),
                s2.y0 + 60.0 * round((cy + half - s2.y0) / 60.0), 10.0,
                10.0, S2_TILE_PX, S2_TILE_PX)
    gran_gb = scene.emit_nc_path.stat().st_size / 1e9
    log(f"ortho: granule {ORTHO_RAW + (ORTHO_BANDS,)} f32 uncompressed "
        f"({gran_gb:.2f} GB) and the S2 stack ({VERIFY_S2_SIZE} px square, "
        f"10 bands u16, {scene.s2_tif_path.stat().st_size / 1e9:.2f} GB) "
        f"made in {time.perf_counter() - t0:.1f} s")

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
    return {"cube": cube32, "utm_grid": utm_grid, "wavelengths": wl,
            "good": good, "counts": runs["u16"][1], "scene": scene}


def apply_phase(plan, utm_cube, s2, coeffs, counts) -> dict:
    """The 10 m apply kernel at the main path's shapes: launched once per
    plan call, its product equal to the eager chain's bit for bit (NaN in
    the same places) on the plan's own stretched 60 m RGB and fit, and
    timed against that chain. Returns its entry of the kernels line."""
    import torch
    from hyperres_torch.fusion import fused as tfused
    from hyperres_torch.kernels.upsample_apply import (KERNEL_NAME,
                                                       upsample_apply)

    if counts.get(KERNEL_NAME, 0) != N_RUNS + 1:
        fail(f"{KERNEL_NAME} launched {counts.get(KERNEL_NAME, 0)} times in "
             f"{N_RUNS + 1} runs of the main path")
    fp = plan._fusion
    st = fp.statics
    synth, s2_60, valid60 = tfused._synth_and_valid(
        st, utm_cube, s2, *fp._matrices()[:3])
    emit_n, _ = tfused._stretch(st, synth, s2_60, valid60)
    del synth, s2_60

    def kernel():
        return upsample_apply(emit_n, valid60, *st.up_fast, coeffs)

    def eager():
        return tfused._map_10m(
            tfused._upsample_10m(st, emit_n, valid60, None, None),
            lambda x, m: tfused.apply_params(st.fusion_method, coeffs, x))

    got, want = kernel(), eager()
    nan = torch.isnan(got)
    zero = torch.zeros((), device=got.device)
    same = (torch.equal(nan, torch.isnan(want))
            and torch.equal(torch.where(nan, zero, got),
                            torch.where(nan, zero, want)))
    log(f"check {KERNEL_NAME} at {tuple(got.shape)} from "
        f"{tuple(emit_n.shape)}: bit-equal to the eager chain {same}, "
        f"NaN share {float(nan.float().mean()):.4f}")
    if not same:
        fail(f"{KERNEL_NAME} differs from the eager chain it replaces")
    del got, want
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(eager, 2)
    n_out = float(np.prod([st.up_fast[0][4], st.up_fast[1][4], 3]))
    n_src = float(valid60.numel())
    # the product written once, the 60 m RGB and validity read once;
    # ~60 operations a pixel (lerps, divides, degree-4 Horner, clamp)
    work = bound(4.0 * n_out + 13.0 * n_src, 20.0 * n_out)
    log(f"{KERNEL_NAME}: kernel {ms:.3f} ms, eager chain {plain_ms:.3f} ms, "
        f"bound {work['bound_ms']:.3f} ms ({work['bound_by']}), "
        f"{work['bound_ms'] / ms:.1%} of it", keep=True)
    return {"name": KERNEL_NAME, "route": "cuda", "source": APPLY_SOURCE,
            "replaces": APPLY_REPLACES, "launches": counts[KERNEL_NAME],
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **work}


def deshift_phase(dev, counts) -> dict:
    """Phase 13a: the deshift kernel at the coregistration cell's shapes
    against the eager chain it replaces, bit for bit, and timed; its
    launches those of phase 13's main-path run (``counts``). Returns its
    entry of the kernels line."""
    import torch
    from hyperres_torch.coreg import local as tlocal
    from hyperres_torch.kernels.deshift_warp import KERNEL_NAME, deshift_warp

    b, h, w = DESHIFT_STACK
    gen = torch.Generator(device=dev).manual_seed(20)
    stack = torch.randint(0, 20000, DESHIFT_STACK, generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint16)
    stack.view(b, -1)[:, :h * w // 20] = 65535
    res = tlocal.CoregResult(True, None, affine=np.array(DESHIFT_AFFINE))

    def kernel():
        return deshift_warp(stack, res.affine, torch.uint16, nodata=65535.0)

    def eager():
        return tlocal._cast_product(
            tlocal.deshift_hwb(stack, res, nodata=65535.0), torch.uint16,
            65535.0)

    got, want = kernel(), eager()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    err, n = int(diff.max()), int((diff > 0).sum())
    log(f"check {KERNEL_NAME} at {DESHIFT_STACK} u16, cubic: codes off the "
        f"eager chain's {n} (largest {err}), nodata share "
        f"{float((got == 65535).float().mean()):.4f}")
    if n:
        fail(f"{KERNEL_NAME} differs from the eager chain it replaces at "
             f"{n} codes")
    del diff
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(eager, 1)
    # the stack read once and the product written once, u16; a multiply
    # and two adds a tap
    n = float(b * h * w)
    work = bound(4.0 * n, 48.0 * n)
    log(f"{KERNEL_NAME}: kernel {ms:.3f} ms, eager chain {plain_ms:.3f} ms, "
        f"bound {work['bound_ms']:.3f} ms ({work['bound_by']}), "
        f"{work['bound_ms'] / ms:.1%} of it", keep=True)
    del stack
    torch.cuda.empty_cache()
    return {"name": KERNEL_NAME, "route": "cuda", "source": DESHIFT_SOURCE,
            "replaces": DESHIFT_REPLACES, "launches": counts[KERNEL_NAME],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **work}


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


def card_suite_phase(card_line: str) -> None:
    """Phase 18 (see the module docstring): ``tests_gpu/`` in a pytest
    subprocess on the card, held to its junit counts."""
    import os
    import xml.etree.ElementTree as ET

    import torch

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        report = Path(d) / "tests_gpu.xml"
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", "tests_gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={report}",
             "-o", "junit_family=xunit1"],   # keeps the cases' properties
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            out, _ = proc.communicate(timeout=CARD_SUITE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"card test suite: no exit within {CARD_SUITE_TIMEOUT} s")
        secs = time.perf_counter() - t0
        if not report.exists():
            fail(f"card test suite wrote no report (exit {proc.returncode})"
                 f": {out[-3000:]}")
        cases = list(ET.parse(report).getroot().iter("testcase"))
    outcome = []   # (name, "passed" / "failure" / "error" / "skipped")
    for case in cases:
        kinds = [c.tag for c in case
                 if c.tag in ("failure", "error", "skipped")]
        outcome.append((case.get("name"), kinds[0] if kinds else "passed"))
        props = {p.get("name"): p.get("value")
                 for p in case.iter("property")}
        if "launches" in props:
            log(f"phase 18 {case.get('name')}: {props['demo_seconds']} s "
                f"(case {float(case.get('time')):.1f} s), launches "
                f"{props['launches']}", keep=True)
    bad = [n for n, k in outcome if k in ("failure", "error")]
    skipped = [n for n, k in outcome if k == "skipped"]
    passed = sum(k == "passed" for _, k in outcome)
    allowed = [n for n in skipped if n == TWO_CARD_TEST
               and torch.cuda.device_count() < 2]
    log(f"phase 18 (card test suite): {passed} passed, {len(skipped)} "
        f"skipped, {secs:.1f} s; {card_line}", keep=True)
    if (proc.returncode != 0 or bad or not cases
            or passed != len(cases) - len(allowed)):
        fail(f"card test suite: exit {proc.returncode}, {len(cases)} cases, "
             f"{passed} passed, failed or erred {bad}, skipped "
             f"{skipped} (allowed {allowed}):\n{out[-6000:]}")


def programs_phase(workdir: Path, card_line: str) -> None:
    """Phase 19 (see the module docstring): ``bench_torch.py`` in a
    subprocess, then the full-scale scripts in this process at small
    sizes; each run's launch counts set to 0 before it and read after."""
    import os

    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.banded import KERNEL_NAMES
    from hyperres_torch.kernels.quantize import KERNEL_NAME as QUANT

    passes = sorted(KERNEL_NAMES.values())
    repo = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HYPERRES_BENCH_")}
    env.update(PYTHONPATH=str(repo), HYPERRES_BENCH_SCALE=str(MAIN_SCALE))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=repo,
                              env=env, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"bench_torch.py: no exit within {BENCH_TIMEOUT} s")
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"bench_torch.py: exit {proc.returncode}, no JSON line last: "
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    log(f"phase 19 bench_torch.py (scale {MAIN_SCALE}): exit "
        f"{proc.returncode} in {secs:.1f} s; {json.dumps(line)}", keep=True)
    gates = bench_torch.GATES
    runs = bench_torch.DEFAULT_RUNS
    if not (proc.returncode == 0 and "status" not in line
            and len(lines) == 1
            and line["psnr_db"] >= gates["psnr_db_min"]
            and line["sam_rad"] <= gates["sam_rad_max"]
            and line["method_psnr_db"] >= gates["method_psnr_db_min"]
            and all(line["launches"].get(k) == runs for k in passes)):
        fail(f"bench_torch.py: exit {proc.returncode}, its line does not "
             f"meet the gates {gates} with {runs} launches of each scanline "
             f"pass:\n{proc.stderr[-4000:]}")
    torch.cuda.empty_cache()

    def counted_run(label: str, fn, expect: dict):
        """fn() with the counts set to 0 before and read after; each count
        of ``expect`` at least its value. A SystemExit (a program's failed
        check) fails the phase."""
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = fn()
        except SystemExit as e:
            fail(f"{label}: exit {e.code}")
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        log(f"phase 19 {label}: {time.perf_counter() - t0:.1f} s, launches "
            f"{counts}", keep=True)
        short = {k: v for k, v in expect.items() if counts.get(k, 0) < v}
        if short:
            fail(f"{label}: launched {counts}, expected at least {expect}")
        torch.cuda.empty_cache()
        return res

    saved = {k: os.environ.get(k) for k in ("HYPERRES_TP_SCALE",
                                            "HYPERRES_TP_GRANULES",
                                            "HYPERRES_TP_TRANSFER")}
    os.environ.update(HYPERRES_TP_SCALE=str(PROGRAMS_SCALE),
                      HYPERRES_TP_GRANULES=str(PROGRAMS_GRANULES))
    os.environ.pop("HYPERRES_TP_TRANSFER", None)
    try:
        tp = counted_run(
            f"torch_bench_throughput (scale {PROGRAMS_SCALE}, "
            f"{PROGRAMS_GRANULES} granules)",
            lambda: script("torch_bench_throughput").main([]),
            {k: PROGRAMS_GRANULES + 1 for k in passes})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"phase 19 throughput: {json.dumps(tp)}", keep=True)
    scale = [str(PROGRAMS_SCALE)]
    full = counted_run(f"torch_validate_fullscale {PROGRAMS_SCALE}",
                       lambda: script("torch_validate_fullscale").main(scale),
                       {k: 1 for k in passes})
    par = counted_run(f"torch_validate_fused_parity {PROGRAMS_SCALE}",
                      lambda: script("torch_validate_fused_parity").main(
                          scale), {k: 1 for k in passes})
    log(f"phase 19 validations (PASS): fullscale {json.dumps(full)}; fused "
        f"parity {json.dumps(par)}", keep=True)
    res = counted_run(
        f"torch_run_production_fullscale.run (raw {PROD_RAW}, S2 "
        f"{PROD_S2} px)",
        lambda: script("torch_run_production_fullscale").run(
            workdir / "prod", raw_shape=PROD_RAW, s2_size=PROD_S2),
        {**{k: 1 for k in passes}, QUANT: 1})
    fused = res.fusion.fused_10m
    finite = float(np.isfinite(fused).all(-1).mean())
    log(f"phase 19 production run: {len(res.tiles)} tiles, fused "
        f"{fused.shape} finite {finite:.4f}, SR r2_mean "
        f"{(res.sr_metrics or {}).get('r2_mean')}; {card_line}", keep=True)
    if not (finite > bench_torch.GATES["finite_frac_min"]
            and res.report_path.exists()):
        fail("torch_run_production_fullscale: no finite product or report")


def analyses_phase(card_line: str) -> None:
    """Phase 20 (see the module docstring): the reliability calibration
    and the SRF sensitivity analysis on the card, each run's launch counts
    set to 0 before it and read after."""
    import contextlib
    import io

    import torch
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.phasecorr import RELIABILITY_TAU

    def counted_main(name: str, argv: list):
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = script(name).main(argv)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(launch_counts)

    cal, secs, counts = counted_main("torch_calibrate_coreg_reliability",
                                     [str(CALIB_PER_CELL)])
    log(f"phase 20 torch_calibrate_coreg_reliability {CALIB_PER_CELL}: "
        f"{secs:.1f} s, {cal['n_windows']} windows, err<0.5px overall "
        f"{cal['ok_rate']:.3f}, snr* {cal['snr_star']} (accepts "
        f"{cal['accept_rate']}), tau {cal['tau']} (RELIABILITY_TAU "
        f"{RELIABILITY_TAU}), launches {counts}; {card_line}", keep=True)
    if not (cal["n_windows"] == CALIB_WINDOWS and cal["tau"] is not None
            and abs(cal["tau"] - RELIABILITY_TAU) <= CALIB_TAU_TOL):
        fail(f"reliability calibration: {cal['n_windows']} windows (want "
             f"{CALIB_WINDOWS}), tau {cal['tau']} not within "
             f"{CALIB_TAU_TOL} of {RELIABILITY_TAU}: {cal['thresholds']}")
    torch.cuda.empty_cache()
    sens, secs, counts = counted_main("torch_srf_sensitivity", [])
    worst = {k: sens[k] for k in ("worst_band_abs_delta_reflectance",
                                  "worst_fused_rms_stretched",
                                  "worst_fused_psnr_db_vs_baseline")}
    log(f"phase 20 torch_srf_sensitivity (96 x 128): {secs:.1f} s, "
        f"{sens['perturbations']} perturbations, {json.dumps(worst)}, "
        f"launches {counts}; {card_line}", keep=True)
    if not (sens["perturbations"] == SRF_SENS_PERTURBATIONS
            and abs(worst["worst_band_abs_delta_reflectance"]
                    - SRF_SENS_WORST_BAND) <= SRF_SENS_BAND_TOL
            and worst["worst_fused_psnr_db_vs_baseline"]
            >= SRF_SENS_PSNR_MIN_DB):
        fail(f"SRF sensitivity: {sens['perturbations']} perturbations (want "
             f"{SRF_SENS_PERTURBATIONS}), {worst}: want the band delta "
             f"within {SRF_SENS_BAND_TOL} of {SRF_SENS_WORST_BAND} and the "
             f"fused PSNR >= {SRF_SENS_PSNR_MIN_DB} dB")
    torch.cuda.empty_cache()


def main() -> None:
    import torch

    clock = PhaseClock()
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
                           "quantize_u16", "srf_synthesize",
                           "upsample_apply", "deshift_warp"])
    log(f"build: all kernels in {time.perf_counter() - t0:.3f} s")
    for name, info in _build.build_info.items():
        log(f"build: {name}: nvcc {info['seconds']:.3f} s")
        log(info["ptxas"])

    clock.mark("build")
    # -- 2a. the ingest's two hazards ----------------------------------------
    prefetch_phase(dev)
    clock.mark("ingest hazards")

    # -- 3. kernel vs plain at the scale-0.25 bench scene ------------------
    worst = {}
    t0 = time.perf_counter()
    small = generate_scene(CHECK_SCALE, 0)
    plan = bench_torch.build_plan(small, dev)
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

    clock.mark("kernel checks, scale 0.25")
    # -- 4. main path at full scale: bench_torch.py's workload -------------
    # (its scene cached under .scenecache/, which phase 19's run of
    # bench_torch.py reads)
    t0 = time.perf_counter()
    scene = bench_torch.build_workload(MAIN_SCALE, scene_cache=True,
                                       device=dev)
    plan = scene.pop("plan")
    t_scene = time.perf_counter() - t0
    s2_band = scene["s2_dn"][0].copy()   # phase 14's percentile input
    raw = torch.from_numpy(scene["raw"]).to(dev)
    s2 = plan.prepare_s2(scene["s2_dn"])
    torch.cuda.synchronize()
    log(f"scene (scale {MAIN_SCALE}) generated and cached, plan built, in "
        f"{t_scene:.1f} s; raw {tuple(raw.shape)}, UTM grid "
        f"{scene['utm60'].height}x{scene['utm60'].width}, 10 m grid "
        f"{scene['s2_grid'].height}x{scene['s2_grid'].width}")
    out, base_times, counts = run_plan(plan, raw, s2, "main path")
    for name in REPLACES:
        if counts.get(name, 0) != N_RUNS + 1:
            fail(f"{name} launched {counts.get(name, 0)} times in "
                 f"{N_RUNS + 1} runs of the main path")

    # -- 5. accuracy gates -------------------------------------------------
    check_gates(plan, out, s2, "main path")
    base_utm = out["utm_cube"]
    coeffs = out["coeffs"]
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
    kernels.append(apply_phase(plan, base_utm, s2, coeffs, counts))
    del coeffs

    # -- 5a. the warp_kernel="pallas" plan: the dense route ---------------
    dplan = bench_torch.build_plan(scene, dev, warp_kernel="pallas")
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

    clock.mark("plans (default, dense) and scanline timings")
    # -- 5b. Sinkhorn at 5000 x 5000 on the plan's OT samples ------------
    utm_cube = plan.warp(raw)
    samples = plan.ot_samples(utm_cube, s2, plan.generator(0))
    kernels.append(sinkhorn_phase(*samples, plan.statics.ot))
    long_rows = [sinkhorn_long_rows_phase(dev, plan.statics.ot, n, m)
                 for n, m in SINKHORN_LONG_ROWS_SHAPES]
    sinkhorn_fragile_stop(dev, plan.statics.ot)
    kernels.append(long_rows[0])
    del samples, utm_cube

    clock.mark("Sinkhorn")
    # -- 5c. the ot_affine plan --------------------------------------------
    aplan = bench_torch.build_plan(scene, dev, fusion_method="ot_affine")
    out, _, _ = run_plan(aplan, raw, s2, "ot_affine plan")
    check_gates(aplan, out, s2, "ot_affine plan", method="ot_affine",
                gated=False)
    if tuple(out["coeffs"].shape) != (4, 3):
        fail(f"ot_affine params {tuple(out['coeffs'].shape)}, expected (4, 3)")
    del out, aplan

    # -- 5e. the tap-loop plan; warp_two_pass with a nodata value ---------
    utm_cube = plan.warp(raw)
    taploop_phase(dev, scene, raw, s2, utm_cube, base_times)
    del raw
    clock.mark("ot_affine and tap-loop plans, warp_two_pass")

    # -- 5d. fuse_pair, both engines ----------------------------------------
    target = plan.s2_reference_10m(utm_cube, s2)
    del s2, plan
    torch.cuda.empty_cache()
    fuse_phase(dev, scene, utm_cube, target)
    del utm_cube, target, scene
    torch.cuda.empty_cache()
    clock.mark("fuse_pair")
    kernels.extend(sr_phases(dev))
    torch.cuda.empty_cache()
    clock.mark("SR")

    # -- 9-11. the ortho export path and its two kernels ------------------
    with tempfile.TemporaryDirectory() as d:
        ortho = ortho_phase(dev, Path(d))
        kernels.append(quantize_phase(ortho["cube"],
                                      ortho["counts"][QUANT_NAME]))
        kernels.append(srf_phase(ortho["cube"], ortho["wavelengths"],
                                 ortho["good"]))
        clock.mark("ortho granule, quantize, SRF")
        scene = ortho.pop("scene")
        utm_grid = ortho["utm_grid"]
        s2_shifted = shifted_s2_stack(
            dev, ortho["cube"], ortho["utm_grid"], ortho["wavelengths"],
            ortho["good"], scene.s2_tif_path, Path(d) / "s2_shifted.tif")
        del ortho
        torch.cuda.empty_cache()
        shutil.rmtree(Path(d) / "ortho")   # ~10 GB of products, checked
        clock.mark("pairs: shifted S2 stack")
        # -- 12. verify_granule on that granule ------------------------------
        verify_phase(dev, scene, Path(d) / "verify")
        clock.mark("verify_granule")
        shutil.rmtree(Path(d) / "verify")
        # -- 13. run_pair_pipeline on that granule ---------------------------
        counts = pairs_phase(dev, scene, s2_shifted, Path(d) / "pairs",
                             card_line)
        clock.mark("run_pair_pipeline")
        shutil.rmtree(Path(d) / "pairs")
        torch.cuda.empty_cache()
        # -- 13a. the coregistration's deshift kernel ------------------------
        kernels.append(deshift_phase(dev, counts))
        torch.cuda.empty_cache()
        clock.mark("deshift")
        # -- 14. the sharded ops on meshes of logical shards ----------------
        parallel_phase(dev, scene, utm_grid, s2_band, card_line)
        del s2_band
        torch.cuda.empty_cache()
        clock.mark("multi-device")
        # -- 15. the batch driver on two worker threads ----------------------
        batch_phase(dev, Path(d) / "batch", card_line)
        clock.mark("batch")
        # -- 16. the command line --------------------------------------------
        cli_phase(Path(d) / "cli", card_line)
        clock.mark("cli")
        # -- 17. the granule toolkit and pair discovery ----------------------
        # (the catalog's host set-up runs in a thread beside the toolkit)
        t17 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            setup = pool.submit(catalog_setup, scene, Path(d) / "catalog")
            toolkit_phase(dev, scene, Path(d) / "toolkit", card_line)
            clock.mark("toolkit")
            catalog_phase(setup.result(), card_line)
        clock.mark("catalog")
        log(f"phase 17 (toolkit, catalog): {time.perf_counter() - t17:.1f} "
            f"s; {card_line}", keep=True)
    # -- 18. the card test suite (tests_gpu/, with the torch demos) ----------
    torch.cuda.empty_cache()
    card_suite_phase(card_line)
    clock.mark("card test suite")
    # -- 19. the port's full-scale programs ----------------------------------
    with tempfile.TemporaryDirectory() as d:
        programs_phase(Path(d), card_line)
    clock.mark("programs")
    # -- 20. the port's host analyses ----------------------------------------
    analyses_phase(card_line)
    clock.mark("analyses")
    log("the parity, SR, pairs, multi-device, batch, CLI, toolkit, catalog, "
        "card suite, programs and analyses paths' readings, again:")
    for line in SUMMARY:
        log(line)
    log(f"chip_smoke phases (s): {clock.spans}")
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    # again, beside the numbers
    log(card_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

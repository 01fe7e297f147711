#!/usr/bin/env python3
"""The port's card check on one NVIDIA GPU (H100), run from the
repository root as ``python3 chip_smoke.py`` (``--table``: the kernel
table alone).

It builds the eight kernels (``csrc/*.cu``, one nvcc each, in parallel;
each build's seconds and ptxas report printed), runs the card suite
(``pytest tests_gpu`` in this process: each kernel's edge cases and, in
``tests_gpu/fullscale``, every main path at its real size), then the
kernel table. The table runs each main path of ``PATHS`` once to read its
launches (reusing the inputs the suite built, ``tests_gpu/card_inputs``).
Then, for each entry of ``ROWS`` (one a hand-written kernel), it builds
the inputs at the main path's shapes, times the kernel by CUDA events,
compares it with its plain PyTorch version once (the row's tolerance) and
times that too, each timed call after SETTLE_S of idle card. A line per
row gives these readings, the SM clock after each timed call, and its
other forms' times and errors; last come the card's ``nvidia-smi`` line
and two JSON lines:

    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms"}, ...]}
    {"ok": true, "suite_exit": 0, "device": {"platform": "gpu", ...}}

``bound_ms``: the least time the card's published peaks allow for the
row's bytes and operations (``bound_by`` says which); ``library_ms``: one
PyTorch call of the same function, where there is one. A row or form
outside its tolerance, or a failing suite, exits 1 after the kernels line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np

import bench_torch

sys.path.append(str(Path(__file__).resolve().parent / "tests_gpu"))
import card_inputs  # noqa: E402  (the inputs the card suite shares)
from card_inputs import (  # noqa: E402
    KERNEL_TOL, REFL_HI_EFF, SINKHORN_LONG_ROWS_SEED, SINKHORN_P_RTOL,
    SR_BX, SR_BY, SR_CHECK_HW, SR_DEGREE, SR_NODATA, SR_SHAPE, SR_STEPS_TOL,
    SR_STREAM_BX, SR_STREAM_DEGREE, SRF_TOL, counted,
)

LIBRARIES = ("scanline_warp", "sr_predict", "sinkhorn_duals", "quantize_u16",
             "srf_synthesize", "upsample_apply", "deshift_warp", "sep_resample")
#: the long-rows row: the first of tests_gpu/fullscale's long-rows shapes
SINKHORN_LONG_ROWS = (128, 100_000)
#: the coregistration cell's stack and a shift model of its kind (px):
#: dy = 5.3 + 1.5 (r / H - 1/2) - 0.7 (c / W - 1/2), dx likewise
DESHIFT_STACK = (10, 9140, 9309)
DESHIFT_AFFINE = ((1.5 / 9140, -0.7 / 9309, 5.3 - 0.75 + 0.35),
                  (0.4 / 9140, 0.9 / 9309, -3.8 - 0.2 - 0.45))
#: the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
#: bytes/s, float32 FLOP/s outside the tensor cores and dense TF32 FLOP/s
#: on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_TC_FLOPS = 495e12
#: the SR kernel's contraction at f32 accuracy on the tensor cores: three
#: TF32 products (A_hi B_hi + A_hi B_lo + A_lo B_hi)
SR_TC_TERMS = 3
#: seconds the card idles before each timed call (kernel, plain version,
#: library call): right after another row's plain version a kernel read up
#: to 15 % slower (PERF.md §6)
SETTLE_S = 0.5

SINKHORN_REPLACES = ("hyperres/kernels/pallas_ops.py:605 "
                     "(pallas_sinkhorn_duals)")
SR_REPLACES = ("hyperres/kernels/pallas_ops.py:828 "
               "(pallas_sr_predict_u16_cmajor); "
               "hyperres/kernels/pallas_ops.py:725 (pallas_sr_predict_u16)")


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


def sr_bound(n_px: int, n_features: int, by: int, mask_bytes: float = 0.0,
             bx: int = SR_BX) -> dict:
    """The SR kernel's bound: per pixel ``bx`` f32 (and ``mask_bytes`` of
    mask) read and ``by`` u16 written; F monomials times ``by`` outputs,
    one multiply-add each, at f32 accuracy on the tensor cores (SR_TC_TERMS
    TF32 products at the dense TF32 peak)."""
    return bound(n_px * (4.0 * bx + mask_bytes + 2.0 * by),
                 SR_TC_TERMS * 2.0 * n_features * by * n_px,
                 PEAK_TF32_TC_FLOPS)


def sinkhorn_bound(n: int, m: int, sweeps: int) -> dict:
    """``sweeps`` Sinkhorn sweeps on an (n, m) Mr. A sweep updates f over
    Mr's rows, then g over its columns. The function needs one read of Mr
    per sweep (a block can keep its rows on chip, take the row update and
    add its column partials in the same pass) plus the f, g, a, b
    vectors; ~6 operations per element and update."""
    per_sweep = bound(4.0 * n * m + 8.0 * (n + m), 12.0 * n * m)
    return {"bound_ms": per_sweep["bound_ms"] * sweeps,
            "bound_by": per_sweep["bound_by"]}


# -- comparisons: (got, want) -> (max_abs_err, within the tolerance) --------

def near(tol: float):
    """Max abs error within ``tol``; tuples are compared element-wise."""
    def compare(got, want):
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        return err, err <= tol
    return compare


def bit_equal(got, want):
    """Bit for bit, NaN in the same places."""
    import torch

    nan = torch.isnan(got)
    zero = torch.zeros((), device=got.device)
    same = (torch.equal(nan, torch.isnan(want))
            and torch.equal(torch.where(nan, zero, got),
                            torch.where(nan, zero, want)))
    return 0, same


def u16_steps(tol: int):
    """u16 codes: the same 65535 mask and at most ``tol`` steps apart;
    one slice of the first axis at a time, in int32 (CUDA takes few
    operators on uint16)."""
    import torch

    def compare(got, want):
        same, worst = True, 0
        for g, w in zip(got, want):
            g, w = g.to(torch.int32), w.to(torch.int32)
            same &= bool(((g == 65535) == (w == 65535)).all())
            worst = max(worst, int((g - w).abs().max()))
        return worst, same and worst <= tol
    return compare


@dataclass
class Case:
    """A row's measurement: ``kernel()`` and ``plain()`` compute the same
    function; ``compare(kernel(), plain())``, or else ``check()``, gives
    (error, within tolerance); ``work``: the bound; ``reps``: timed calls
    of each; ``library``: a PyTorch call of the same function; ``forms``:
    label -> Case, other forms of the kernel, each timed and compared for
    the row's line."""
    kernel: Callable
    plain: Callable
    compare: Optional[Callable] = None
    work: dict = field(default_factory=dict)
    reps: tuple = (10, 2)
    check: Optional[Callable] = None
    library: Optional[Callable] = None
    forms: dict = field(default_factory=dict)


@dataclass
class Row:
    """A kernel: its launch counter's ``name``, CUDA ``source``, the TPU
    kernel it ``replaces``, ``case(inputs)`` -> Case, the ``path`` of
    ``PATHS`` whose one call gives its launches, and ``routes``: the
    wrapper's other launch counters, which the row also stands for."""
    name: str
    source: str
    replaces: str
    case: Callable
    path: str
    routes: tuple = ()


def check_cube(rng, dev, h: int, w: int, bx: int = SR_BX):
    """(bx, h * w) seeded values in [0, 1) with one NaN and one nodata
    pixel, on ``dev``."""
    import torch

    cube = rng.random((bx, h, w)).astype(np.float32)
    cube[3, h // 10, w // 5] = np.nan
    cube[7, h // 2, w // 2] = SR_NODATA
    return torch.from_numpy(cube).to(dev).reshape(bx, h * w)


def duals(X, Y, cfg, wx=None, wy=None):
    """OT samples as the duals take them, under the plan's OTConfig
    ``cfg``: log marginals and Mr = -C / reg."""
    import torch
    from hyperres_torch.kernels.sinkhorn import marginal, sqeuclidean_cdist

    return SimpleNamespace(
        cfg=cfg, X=X, Y=Y, wx=wx, wy=wy,
        la=torch.log(marginal(wx, X.shape[0], X.device)),
        lb=torch.log(marginal(wy, Y.shape[0], Y.device)),
        Mr=-sqeuclidean_cdist(X, Y) / cfg.reg)


def sr_args(m) -> tuple:
    return m.x_mean, m.x_std, m.W, m.intercept, m.factors


class Inputs:
    """The rows' inputs, each made once at first use (those the card
    suite shares from ``card_inputs``), and the launches of each main
    path's one call (:meth:`launches`)."""

    def __init__(self, dev):
        self.dev = dev
        self._launches = {}

    def launches(self, path: str) -> dict:
        """The launch counts of one call of ``PATHS[path]``."""
        import torch

        if path not in self._launches:
            self._launches[path] = PATHS[path](self)
            torch.cuda.empty_cache()
        return self._launches[path]

    @cached_property
    def bench(self):
        """The bench scene at scale 1.0: plan, raw cube, S2."""
        return card_inputs.bench(self.dev)

    @cached_property
    def warp(self):
        """The plan's scanline operands as the dense route takes them:
        extended source, c*, rows."""
        from hyperres_torch.kernels.warp import orthowarp_src_ext

        p = self.bench.plan
        return (orthowarp_src_ext(self.bench.raw, p._flat_idx, p._valid),
                p._cstar, p._wr)

    @cached_property
    def cross(self):
        """The scanline kernel's operands in the "cross-CRS resample"
        path, made as ``resample_tensor_to_grid`` makes them there: the
        plan's GLT-gathered cube with a nodata value, a validity channel
        per band (Ho, Wo, 2 B), and its c* and rows onto the UTM grid."""
        from hyperres_torch.core.constants import NO_DATA_VALUE
        from hyperres_torch.kernels import warp as twarp
        from hyperres_torch.kernels.host import (
            scanline_cstar, source_index_field,
        )

        src_grid, dst_grid = self.bench.scene["ortho_grid"], \
            self.bench.scene["utm60"]
        rows, cols = source_index_field(src_grid, dst_grid)
        cstar = scanline_cstar(rows, cols, src_grid.height)
        return (twarp.two_pass_src_ext(_gathered(self.bench), NO_DATA_VALUE),
                twarp._on(cstar, self.dev), twarp._on(rows, self.dev))

    @cached_property
    def ot(self):
        """The plan's OT samples (5000 x 5000) and slot weights."""
        b = self.bench
        utm = b.plan.warp(b.raw)
        Xs, wxs, Ys, wys = b.plan.ot_samples(utm, b.s2, b.plan.generator(0))
        return duals(Xs, Ys, b.plan.statics.ot, wxs, wys)

    @cached_property
    def long_rows(self):
        """SINKHORN_LONG_ROWS seeded RGB samples in [0, 1), uniform
        marginals."""
        import torch

        rng = np.random.default_rng(SINKHORN_LONG_ROWS_SEED)
        Xs, Ys = (torch.from_numpy(rng.random((k, 3), dtype=np.float32))
                  .to(self.dev) for k in SINKHORN_LONG_ROWS)
        return duals(Xs, Ys, self.bench.plan.statics.ot)

    @cached_property
    def sr(self):
        """The SR product's model (fitted on 200k seeded px) and footprint
        (SR_SHAPE, its first 5 % nodata), the entry's model (10 -> 285),
        the streamed route's model (50k px) and SR_CHECK_HW cubes."""
        import torch
        from hyperres_torch.core.config import RidgeSRConfig
        from hyperres_torch.entry import entry
        from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR

        bench = card_inputs.script("torch_bench_sr_granule")
        rng = np.random.default_rng(0)
        Xt, Yt = bench.training_data(rng)
        model = RidgeSpectralSR(SR_BX, SR_BY, RidgeSRConfig(degree=SR_DEGREE),
                                device=self.dev).fit(Xt, Yt)
        X = torch.from_numpy(bench.granule_cube(rng, *SR_SHAPE[1:])).to(
            self.dev)
        fwd, _ = entry(self.dev)
        Xb, Yb = bench.training_data(np.random.default_rng(3), 50_000,
                                     SR_STREAM_BX)
        big = RidgeSpectralSR(SR_STREAM_BX, SR_BY,
                              RidgeSRConfig(degree=SR_STREAM_DEGREE),
                              device=self.dev).fit(Xb, Yb)
        Xc = check_cube(rng, self.dev, *SR_CHECK_HW)
        Xs = check_cube(rng, self.dev, *SR_CHECK_HW, bx=SR_STREAM_BX)
        return SimpleNamespace(model=model, X=X, fwd=fwd, Xc=Xc, big=big,
                               Xs=Xs)

    @cached_property
    def utm_cube(self):
        """The UTM cube of the ortho path's u16 run (LOC too) on the
        full-width granule."""
        return card_inputs.ortho_run("u16").res.device_cube

    @cached_property
    def srf(self):
        """S2A's 13 bands' weights for the granule's wavelengths, and the
        UTM cube as (pixels, bands) rows with its valid-pixel mask."""
        import torch
        from hyperres_torch.core.constants import NO_DATA_VALUE
        from hyperres_torch.kernels.host import build_srf_weight_matrix
        from hyperres_torch.spectral.srf_tables import builtin_srf

        cube, sc = self.utm_cube, card_inputs.granule().scene
        W, _, _ = build_srf_weight_matrix(sc.wavelengths, builtin_srf("S2A"),
                                          sc.good_bands)
        valid = (cube != NO_DATA_VALUE).all(dim=-1)
        return SimpleNamespace(
            W=torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(
                self.dev), valid=valid, x=cube.reshape(-1, cube.shape[-1]),
            v=valid.reshape(-1))


# -- the main paths: inputs -> the launch counts of one call ---------------

def ran(fn, *args) -> dict:
    """The launch counts of one ``fn(*args)``, its arguments made first."""
    return counted(lambda: fn(*args))[1]


def _plan_call(b, plan):
    plan(b.raw, b.s2, generator=plan.generator(0))


def _ot_call(o):
    from hyperres_torch.kernels.sinkhorn import ot_barycentric_targets

    ot_barycentric_targets(o.X, o.Y, reg=o.cfg.reg, wx=o.wx, wy=o.wy,
                           num_itermax=o.cfg.num_itermax,
                           stop_thr=o.cfg.stop_thr, engine="pallas")


def _coreg_call(scene, dev):
    """``coregister_stack`` on ``card_inputs.coreg_scene`` at the settings
    of tests_gpu/test_deshift_warp.py."""
    from hyperres_torch.core.config import CoregConfig
    from hyperres_torch.coreg.granule import coregister_stack

    emit, emit_grid, stack, s2_grid = scene
    out = coregister_stack(
        {"B08": emit}, emit_grid, stack, s2_grid, CoregConfig(
            window_size=(128, 128), grid_res=150.0, min_reliability=25.0),
        s2_bandmap={"B03": 1, "B04": 2, "B08": 3},
        nodata_s2=card_inputs.S2_NODATA, device=dev)
    if not out["final"]["success"]:
        raise RuntimeError(f"coregistration failed: {out['attempts']}")


def _gathered(b):
    """The plan's GLT gather of the bench scene's raw cube (Ho, Wo, B)."""
    from hyperres_torch.kernels.glt import glt_gather

    return glt_gather(b.raw, b.plan._flat_idx, b.plan._valid)


def _two_pass_call(b):
    """``resample_tensor_to_grid``'s cross-CRS route (``warp_two_pass``,
    the scanline kernel's two passes) on the plan's GLT-gathered cube
    onto the UTM grid, with a nodata value, as
    tests_gpu/fullscale/test_plans.py runs it."""
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.kernels.warp import resample_tensor_to_grid

    ortho = _gathered(b)
    return ran(lambda: resample_tensor_to_grid(
        ortho, b.scene["ortho_grid"], b.scene["utm60"], method="cubic",
        nodata=NO_DATA_VALUE, fill=NO_DATA_VALUE))


def _srf_call(cube, s):
    from hyperres_torch.kernels.srf import srf_synthesize_auto

    srf_synthesize_auto(cube, s.W, s.valid, use_pallas=True)


def _sr_call(model, X):
    model.predict_cube_u16(X, nodata=SR_NODATA)


PATHS = {
    "plan": lambda i: ran(_plan_call, i.bench, i.bench.plan),
    "cross-CRS resample": lambda i: _two_pass_call(i.bench),
    "dense plan": lambda i: ran(_plan_call, i.bench, bench_torch.build_plan(
        i.bench.scene, i.dev, warp_kernel="pallas")),
    "OT stage": lambda i: ran(_ot_call, i.ot),
    "long-rows OT stage": lambda i: ran(_ot_call, i.long_rows),
    "SR product": lambda i: ran(_sr_call, i.sr.model, i.sr.X),
    "streamed SR product": lambda i: ran(
        _sr_call, i.sr.big, i.sr.Xs.reshape(SR_STREAM_BX, *SR_CHECK_HW)),
    "srf_synthesize_auto": lambda i: ran(_srf_call, i.utm_cube, i.srf),
    # the run is card_inputs' (shared with the suite), counted there
    "orthorectify_granule": lambda i: card_inputs.ortho_run("u16").counts,
    "coregister_stack": lambda i: ran(
        _coreg_call, card_inputs.coreg_scene(i.dev), i.dev),
}


# -- the rows' cases -------------------------------------------------------

def _pass_case(axis: int):
    def case(inp):
        from hyperres_torch.kernels.banded import (
            scanline_resample, scanline_resample_reference,
        )

        src, cstar, rows = inp.cross
        if axis == 0:   # pass 2 reads the kernel's pass-1 output
            src, pos = scanline_resample(src, cstar, 1), rows
        else:
            pos = cstar
        out = scanline_resample(src, pos, axis).shape
        return Case(lambda: scanline_resample(src, pos, axis),
                    lambda: scanline_resample_reference(src, pos, axis),
                    near(KERNEL_TOL), scanline_bound(src, pos, out),
                    reps=(10, 3))
    return case


def _orthowarp_case(n: int):
    """Pass ``n`` of the plan's fused ortho warp against the eager chain
    it replaces there, on the same source (pass 2 on the kernel's pass-1
    output): pass 1 against ``orthowarp_src_ext`` and the scanline
    kernel's pass 1; pass 2 against the scanline kernel's pass 2 and
    ``_renormalise``. Bit for bit."""
    def case(inp):
        import torch
        from hyperres_torch.kernels import orthowarp as ow
        from hyperres_torch.kernels import warp as twarp
        from hyperres_torch.kernels.banded import scanline_resample

        p, raw = inp.bench.plan, inp.bench.raw
        flat, cstar, rows, cols = p._flat_idx, p._cstar, p._wr, p._wc
        valid_f = p._valid.to(torch.float32)
        (h, w, b), (ho, wo), wd = raw.shape, flat.shape, cstar.shape[1]
        if n == 1:
            # the raw cube, GLT and validity read once, c* once, the
            # (Ho, Wd, B + 1) intermediate written once
            work = bound(4.0 * (h * w * b + 2 * ho * wo + ho * wd
                                + ho * wd * (b + 1)), 8.0 * ho * wd * (b + 1))
            return Case(lambda: ow.pass1(raw, flat, valid_f, cstar),
                        lambda: scanline_resample(twarp.orthowarp_src_ext(
                            raw, flat, p._valid), cstar, 1),
                        bit_equal, work, reps=(10, 3))
        mid = ow.pass1(raw, flat, valid_f, cstar)
        hd = rows.shape[0]
        keep = twarp._centre_in(rows, cols, ho, wo)

        def plain():
            out_ext = scanline_resample(mid, rows, 0)
            return twarp._renormalise(out_ext[..., :b], out_ext[..., b:],
                                      keep, -9999.0)
        # the intermediate read once, rows and cols once, the result
        # written once
        work = bound(4.0 * (ho * wd * (b + 1) + 2 * hd * wd + hd * wd * b),
                     8.0 * hd * wd * (b + 1))
        return Case(lambda: ow.pass2(mid, rows, cols, wo), plain, bit_equal,
                    work, reps=(10, 3))
    return case


def _dense_case(inp):
    """Both dense passes as ``orthowarp_two_pass(backend="pallas")`` runs
    them, each on the same source for kernel and plain (pass 2 on the
    kernel's pass-1 output)."""
    from hyperres_torch.kernels.banded import (
        scanline_resample_dense as dense,
        scanline_resample_dense_reference as dense_ref,
    )

    src, cstar, rows = inp.warp
    h = dense(src, cstar, "cubic", axis=1)
    out = dense(h, rows, "cubic", axis=0).shape
    work = {"bound_ms": scanline_bound(src, cstar, h.shape)["bound_ms"]
            + scanline_bound(h, rows, out)["bound_ms"], "bound_by": "bytes"}
    return Case(lambda: (dense(src, cstar, "cubic", axis=1),
                         dense(h, rows, "cubic", axis=0)),
                lambda: (dense_ref(src, cstar, "cubic", axis=1),
                         dense_ref(h, rows, "cubic", axis=0)),
                near(KERNEL_TOL), work, reps=(10, 2))


def _apply_case(inp):
    """The 10 m apply on the plan's own stretched 60 m RGB and fit,
    against the eager chain it replaces."""
    from hyperres_torch.fusion import fused as tfused
    from hyperres_torch.kernels.upsample_apply import upsample_apply

    b = inp.bench
    out = b.plan(b.raw, b.s2, generator=b.plan.generator(0))
    utm, coeffs = out["utm_cube"], out["coeffs"]
    del out
    fp = b.plan._fusion
    st = fp.statics
    synth, s2_60, valid60 = tfused._synth_and_valid(st, utm, b.s2,
                                                    *fp._matrices()[:3])
    emit_n, _ = tfused._stretch(st, synth, s2_60, valid60)
    del synth, s2_60, utm
    n_out = float(np.prod([st.up_fast[0][4], st.up_fast[1][4], 3]))
    # the product written once, the 60 m RGB and validity read once;
    # ~60 operations a pixel (lerps, divides, degree-4 Horner, clamp)
    return Case(
        lambda: upsample_apply(emit_n, valid60, *st.up_fast, coeffs),
        lambda: tfused._map_10m(
            tfused._upsample_10m(st, emit_n, valid60, None, None),
            lambda x, m: tfused.apply_params(st.fusion_method, coeffs, x)),
        bit_equal, bound(4.0 * n_out + 13.0 * float(valid60.numel()),
                         20.0 * n_out))


def _sinkhorn_case(which: str):
    def case(inp):
        import torch
        from hyperres_torch.kernels import sinkhorn_duals as sd

        o = getattr(inp, which)
        la, lb, Mr, cfg = o.la, o.lb, o.Mr, o.cfg
        rule = (cfg.num_itermax, cfg.stop_thr, 10)
        fixed = (cfg.num_itermax, 0.0)

        def check():
            """P = exp(Mr + f + g) at a fixed sweep count."""
            f, g, _ = sd.sinkhorn_duals(la, lb, Mr, *fixed)
            rf, rg, _ = sd.sinkhorn_duals_reference(la, lb, Mr, *fixed)
            P = torch.exp(Mr + f[:, None] + g[None, :])
            err = float((P - torch.exp(Mr + rf[:, None] + rg[None, :]))
                        .abs().max())
            return err, err <= SINKHORN_P_RTOL * float(P.max())

        *_, sweeps = sd.sinkhorn_duals(la, lb, Mr, *rule, return_sweeps=True)
        return Case(lambda: sd.sinkhorn_duals(la, lb, Mr, *rule),
                    lambda: sd.sinkhorn_duals_reference(la, lb, Mr, *rule),
                    work=sinkhorn_bound(*Mr.shape, sweeps), reps=(5, 2),
                    check=check)
    return case


def _sr_case(inp):
    """The product, and the row-major serving form at By = 285 (the
    entry's model) as a form."""
    from hyperres_torch.kernels.sr_predict import (
        sr_predict_u16, sr_predict_u16_reference, valid_pixels,
    )

    s = inp.sr
    X2, args = s.X.reshape(SR_BX, -1), sr_args(s.model)
    Xr = s.Xc.T.contiguous()
    kw = {"valid": valid_pixels(Xr, SR_NODATA), "layout": "rowmajor"}
    n, steps = Xr.shape[0], u16_steps(SR_STEPS_TOL)
    row = Case(lambda: sr_predict_u16(Xr, *sr_args(s.fwd), **kw),
               lambda: sr_predict_u16_reference(Xr, *sr_args(s.fwd), **kw),
               lambda g, w: steps(g.T, w.T),  # (pixels, 285): by band
               work=sr_bound(n, s.fwd.n_features, s.fwd.n_outputs, 1.0))
    return Case(lambda: sr_predict_u16(X2, *args, nodata=SR_NODATA),
                lambda: sr_predict_u16_reference(X2, *args,
                                                 nodata=SR_NODATA),
                u16_steps(SR_STEPS_TOL),
                sr_bound(X2.shape[1], s.model.n_features, SR_BY), reps=(5, 1),
                forms={f"rowmajor ({n}, {SR_BX}) -> ({n}, "
                       f"{s.fwd.n_outputs})": row})


def _sr_streamed_case(inp):
    from hyperres_torch.kernels.sr_predict import (
        sr_predict_u16, sr_predict_u16_reference,
    )

    s = inp.sr
    args = sr_args(s.big)
    return Case(lambda: sr_predict_u16(s.Xs, *args, nodata=SR_NODATA),
                lambda: sr_predict_u16_reference(s.Xs, *args,
                                                 nodata=SR_NODATA),
                u16_steps(SR_STEPS_TOL),
                sr_bound(s.Xs.shape[1], s.big.n_features, SR_BY,
                         bx=SR_STREAM_BX))


def _quantize_case(inp):
    """The reflectance form (validity in the kernel, sentinel 65535) on
    the ortho path's UTM cube."""
    from hyperres_torch.core.constants import NO_DATA_VALUE
    from hyperres_torch.kernels.quantize import (
        quantize_u16, quantize_u16_reference,
    )

    cube = inp.utm_cube
    args = (cube, 0.0, REFL_HI_EFF, None, 65535)
    n = float(cube.numel())
    return Case(lambda: quantize_u16(*args, nodata_src=NO_DATA_VALUE),
                lambda: quantize_u16_reference(*args,
                                               nodata_src=NO_DATA_VALUE),
                u16_steps(0), bound(n * (4.0 + 2.0), 6.0 * n))  # f32 -> u16


def _srf_case(inp):
    """The tiled route at S = 13 on the UTM cube with its valid-pixel
    mask."""
    import torch
    from hyperres_torch.kernels import srf

    s = inp.srf
    x, W, v = s.x, s.W, s.v
    n, b = x.shape
    n_valid, n_out = int(v.sum()), W.shape[1]
    # only the valid rows need reading: an invalid row's outputs are the
    # fill
    return Case(lambda: srf.pallas_srf_synthesize(x, W, v),
                lambda: srf.srf_synthesize_reference(x, W, v),
                near(SRF_TOL), bound(4.0 * (n_valid * b + b * n_out
                                            + n * n_out) + n,
                                     2.0 * n_valid * b * n_out),
                reps=(10, 3), library=lambda: torch.matmul(x, W))


def _deshift_case(inp):
    """A seeded DESHIFT_STACK u16 stack, its first 5 % nodata, deshifted
    cubically by DESHIFT_AFFINE, against the eager chain it replaces
    (``coreg.local.deshift_hwb`` and the cast)."""
    import torch
    from hyperres_torch.coreg import local as tlocal
    from hyperres_torch.kernels.deshift_warp import deshift_warp

    b, h, w = DESHIFT_STACK
    gen = torch.Generator(device=inp.dev).manual_seed(20)
    stack = torch.randint(0, 20000, DESHIFT_STACK, generator=gen,
                          device=inp.dev, dtype=torch.int32).to(torch.uint16)
    stack.view(b, -1)[:, :h * w // 20] = 65535
    res = tlocal.CoregResult(True, None, affine=np.array(DESHIFT_AFFINE))
    n = float(b * h * w)
    # the stack read once and the product written once, u16; a multiply
    # and two adds a tap
    return Case(lambda: deshift_warp(stack, res.affine, torch.uint16,
                                     nodata=65535.0),
                lambda: tlocal._cast_product(tlocal.deshift_hwb(
                    stack, res, nodata=65535.0), torch.uint16, 65535.0),
                u16_steps(0), bound(4.0 * n, 48.0 * n), reps=(10, 1))


def _resample_case(inp):
    """``card_inputs``' seeded RESAMPLE_SRC band (nodata over two
    off-swath corners and scattered, NaN) resampled cubically onto
    RESAMPLE_DST: the launch on taps made once, against the dense route
    it replaces on the card (``warp._interp_matrix`` and
    ``separable_resample_matmul``); its form "per call" is the wrapper,
    which builds and uploads the taps each call."""
    from hyperres_torch.kernels import sep_resample as sr
    from hyperres_torch.kernels import warp as twarp
    from hyperres_torch.kernels.host import separable_index_axes

    src, dst = card_inputs.RESAMPLE_SRC, card_inputs.RESAMPLE_DST
    (hs, ws, _), (hd, wd, _, _) = src, dst
    nodata = card_inputs.EMIT_NODATA
    x = card_inputs.resample_source(np.random.default_rng(22), hs, ws, 1,
                                    nodata, inp.dev)
    sg, dg = card_inputs.resample_grids(src, dst)
    idx_r, idx_c = separable_index_axes(sg, dg)
    taps = sr.device_taps(idx_r, idx_c, x.shape, "cubic", inp.dev)

    def plain():
        Wr = twarp._interp_matrix(idx_r, hs, "cubic", inp.dev)
        Wc = twarp._interp_matrix(idx_c, ws, "cubic", inp.dev)
        return twarp.separable_resample_matmul(x, Wr, Wc, nodata=nodata,
                                               fill=np.nan)
    # the band read once and the f32 result written once; two 4-tap
    # passes of a multiply-add each, values and mass
    work = bound(4.0 * (hs * ws + hd * wd),
                 2.0 * 2.0 * 4.0 * (hd * ws + hd * wd))
    per_call = Case(lambda: sr.sep_resample(x, idx_r, idx_c, "cubic",
                                            nodata=nodata, fill=np.nan),
                    plain, bit_equal, work, reps=(20, 0))
    return Case(lambda: sr.launch(x, taps, nodata=nodata, fill=np.nan),
                plain, bit_equal, work, reps=(20, 2),
                forms={"per call": per_call})


ROWS = [
    Row("scanline_resample_pass1", "hyperres_torch/csrc/scanline_warp.cu",
        "hyperres/kernels/pallas_ops.py:390", _pass_case(1),
        "cross-CRS resample"),
    Row("scanline_resample_pass2", "hyperres_torch/csrc/scanline_warp.cu",
        "hyperres/kernels/pallas_ops.py:467", _pass_case(0),
        "cross-CRS resample"),
    Row("orthowarp_pass1", "hyperres_torch/csrc/scanline_warp.cu",
        "hyperres/kernels/pallas_ops.py:390 with the GLT gather "
        "(hyperres/kernels/warp.py:880-884) folded in", _orthowarp_case(1),
        "plan"),
    Row("orthowarp_pass2", "hyperres_torch/csrc/scanline_warp.cu",
        "hyperres/kernels/pallas_ops.py:467 with the renormalisation "
        "(hyperres/kernels/warp.py:921-929) folded in", _orthowarp_case(2),
        "plan"),
    Row("upsample_apply", "hyperres_torch/csrc/upsample_apply.cu",
        "none (hyperres/fusion/fused.py:233-275, phase 4, left to XLA's "
        "fusion)", _apply_case, "plan"),
    Row("scanline_resample_dense", "hyperres_torch/csrc/scanline_warp.cu",
        "hyperres/kernels/pallas_ops.py:189 (pallas_scanline_resample)",
        _dense_case, "dense plan"),
    Row("sinkhorn_duals", "hyperres_torch/csrc/sinkhorn_duals.cu",
        SINKHORN_REPLACES, _sinkhorn_case("ot"), "OT stage",
        ("sinkhorn_duals_two_read",)),
    Row("sinkhorn_duals_long_rows", "hyperres_torch/csrc/sinkhorn_duals.cu",
        SINKHORN_REPLACES, _sinkhorn_case("long_rows"), "long-rows OT stage"),
    Row("sr_predict_u16", "hyperres_torch/csrc/sr_predict.cu", SR_REPLACES,
        _sr_case, "SR product"),
    Row("sr_predict_u16_streamed", "hyperres_torch/csrc/sr_predict.cu",
        SR_REPLACES, _sr_streamed_case, "streamed SR product"),
    Row("quantize_u16", "hyperres_torch/csrc/quantize_u16.cu",
        "hyperres/kernels/pallas_ops.py:122 (pallas_quantize_u16)",
        _quantize_case, "orthorectify_granule"),
    Row("srf_synthesize", "hyperres_torch/csrc/srf_synthesize.cu",
        "hyperres/kernels/pallas_ops.py:70 (pallas_srf_synthesize)",
        _srf_case, "srf_synthesize_auto",
        ("srf_synthesize_warp", "srf_synthesize_generic")),
    Row("deshift_warp", "hyperres_torch/csrc/deshift_warp.cu",
        "none (hyperres/coreg/local.py:356, the plain warp_interpolate, "
        "left to XLA)", _deshift_case, "coregister_stack"),
    Row("sep_resample", "hyperres_torch/csrc/sep_resample.cu",
        "none (hyperres/kernels/warp.py:1155, the same-CRS transfer left to "
        "two XLA dots)", _resample_case, "coregister_stack"),
]


def sm_mhz() -> int:
    """The card's SM clock (MHz) as nvidia-smi reads it now."""
    return int(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def timed(fn, reps: int) -> tuple:
    """(``cuda_ms(fn, reps)`` after SETTLE_S of idle card, the SM clock
    read right after it)."""
    import torch

    torch.cuda.synchronize()
    time.sleep(SETTLE_S)
    return cuda_ms(fn, reps), sm_mhz()


def measure(case: Case) -> dict:
    """The case's kernel timed, its comparison made, then its plain
    version and library call timed, each call on a settled card
    (``timed``); ``sm_mhz``: the clock after each."""
    import torch

    k, p = case.reps
    ms, mhz = timed(case.kernel, k)
    if case.check is not None:
        err, ok = case.check()
    else:
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        err, ok = case.compare(got, want)
        del got, want
    torch.cuda.empty_cache()
    plain, mhz_p = timed(case.plain, p) if p else (None, None)
    lib, mhz_l = timed(case.library, k) if case.library else (None, None)
    return {"max_abs_err": err, "ok": ok, "ms": ms, "plain_ms": plain,
            **case.work, "library_ms": lib,
            "sm_mhz": {"kernel": mhz, "plain": mhz_p, "library": mhz_l}}


def walk(inp: Inputs) -> tuple:
    """Every row of ROWS: (kernels line entries, names of rows or forms
    outside their tolerance). Every main path runs first, so that the
    rows are timed one after the other, not after the paths' host work."""
    import torch

    entries, failed = [], []
    for row in ROWS:
        inp.launches(row.path)
    for row in ROWS:
        t0 = time.perf_counter()
        launches = inp.launches(row.path)
        case = row.case(inp)
        e = measure(case)
        forms = {label: measure(f) for label, f in case.forms.items()}
        del case
        torch.cuda.empty_cache()
        failed += [f"{row.name} {label}" for label, f in forms.items()
                   if not f["ok"]] + ([row.name] if not e.pop("ok") else [])
        mhz = e.pop("sm_mhz")
        shown = {k: (round(f["ms"], 3), f["max_abs_err"], f["sm_mhz"])
                 for k, f in forms.items()}
        e = {"name": row.name, "route": "cuda", "source": row.source,
             "replaces": row.replaces, "launches": launches.get(row.name, 0),
             **e}
        entries.append(e)
        print(f"{row.name}: {e['launches']} launches in one call of the "
              f"{row.path} ({launches}); max_abs_err {e['max_abs_err']}; "
              f"kernel {e['ms']:.3f} ms, plain {e['plain_ms']} ms, library "
              f"{e['library_ms']} ms; SM MHz {mhz}; bound "
              f"{e['bound_ms']:.3f} ms ({e['bound_by']}), "
              f"{e['bound_ms'] / e['ms']:.1%} of it; other forms (ms, "
              f"max_abs_err, SM MHz) {shown}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return entries, failed


def main() -> None:
    """The card suite (``pytest tests_gpu``, in this process, unless
    ``--table``), then the kernel table; exit 1 if either failed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the table "
              "needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    from hyperres_torch.kernels import _build

    _build.load_libraries(LIBRARIES)
    for name, info in _build.build_info.items():
        print(f"build: {name}: nvcc {info['seconds']:.3f} s\n{info['ptxas']}",
              flush=True)
    suite = None
    if "--table" not in sys.argv[1:]:
        import pytest

        t0 = time.perf_counter()
        suite = int(pytest.main([str(Path(__file__).resolve().parent
                                     / "tests_gpu"), "-q", "--durations=15",
                                 "-p", "no:cacheprovider"]))
        print(f"tests_gpu: exit {suite} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entries, failed = walk(Inputs(torch.device("cuda", 0)))
    print(f"table: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    if failed or suite:
        print(f"chip_smoke FAILED: outside their tolerance: {failed}; "
              f"tests_gpu exit {suite}", file=sys.stderr, flush=True)
        raise SystemExit(1)
    print(json.dumps({"ok": True, "suite_exit": suite, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

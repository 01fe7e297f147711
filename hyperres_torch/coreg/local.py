# Port-owned copy of hyperres/coreg/local.py: the host parts verbatim
# (TiePoint, CoregResult, _tie_point_grid :88, tps_fit_residuals :226,
# tps_evaluate :251, shift_field :268 (its NumPy form), coregister_local's
# filters) but ransac_affine_filter :51, whose loop runs as one stacked
# solve over the same seeded picks;
# the window cut, the phase correlation, the shift field and the deshift
# warp run on the device.
"""Local coregistration: tie-point grid phase correlation + deshift.

Framework-native equivalent of AROSICS ``COREG_LOCAL`` +
``correct_shifts`` as parameterised by the reference
(s2_emit/arosics_coreg.py:135-163): tie-point grid with ``grid_res``
spacing capped at ``max_points``, matching windows of ``window_size``,
shifts bounded by ``max_shift``, reliability threshold
``min_reliability``, tie-point filter levels 1-3, cubic deshift onto the
target grid. The matching itself is the batched FFT phase-correlation
kernel; the deshift warp reuses the resampling kernel with a smooth
(affine + optional residual-IDW) shift field fit to the surviving tie
points. Behavioural — not bitwise — parity with AROSICS, validated by
shift recovery on synthetically displaced scenes (SURVEY.md section 7
hard part #2).

In the port, ``coregister_local`` and ``deshift`` take NumPy arrays or
tensors and run one path for both, on ``device`` (default: a tensor's
own device, else the current CUDA device; ``"cpu"`` for the CPU):

- ``coregister_local`` cuts every candidate window pair in one batched
  gather, fills each window's holes with the mean of its valid pixels
  (float64 sums, as ``nanmean``), tests the >50 % bad share and runs the
  batched phase correlation over all candidates; one host read brings
  back (dy, dx, reliability) and the kept-window mask. The filters
  (reliability, max shift, MAD, the seeded RANSAC) and the affine least
  squares stay on the host, in float64, as in the reference.
- ``deshift`` (:func:`deshift_product`) runs on the device. On the
  card, a uint16 or float32 stack deshifted cubically or bilinearly takes
  one kernel (``kernels/deshift_warp.py``) from the stack to the
  product; everything else takes the eager chain (:func:`deshift_hwb`):
  the shift field (``shift_field`` with a ``device``: the affine in
  float64 as NumPy promotes it, the IDW / TPS residuals in the NumPy
  form's precision) and
  :func:`~hyperres_torch.kernels.warp.warp_interpolate_chunked`. The two
  give the same product, bit for bit; the stack never leaves the
  device, and a tensor input gets a tensor back.

Spans (``utils/profiling.py``): ``coreg.match`` (the cut, the fill, the
transforms, the peak and the read; counter ``coreg.windows``, the
windows matched) and ``coreg.filter`` (the host filters and the affine
fit; counter ``coreg.tiepoints``, the points used); ``deshift_product``
counts ``deshift.kernel`` once a launch of the kernel in the open span.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import CoregConfig
from ..device import resolve_device
from ..kernels.deshift_warp import (DESHIFT_COUNTER, deshift_warp,
                                   takes_kernel)
from ..kernels.phasecorr import phase_correlate_batch
from ..kernels.warp import warp_interpolate_chunked
from ..utils.profiling import count, span

#: the counters of a match: windows matched, tie points used
WINDOWS_COUNTER = "coreg.windows"
TIEPOINTS_COUNTER = "coreg.tiepoints"


@dataclass
class TiePoint:
    col: int
    row: int
    dy: float
    dx: float
    reliability: float
    used: bool = True
    reject_reason: Optional[str] = None


@dataclass
class CoregResult:
    success: bool
    shifted: Optional[np.ndarray]  # (B, H, W) deshifted target, or None
    tie_points: List[TiePoint] = field(default_factory=list)
    mean_shift_px: Tuple[float, float] = (0.0, 0.0)
    affine: Optional[np.ndarray] = None  # (2, 3): [dy; dx] = A @ [r, c, 1]
    info: Dict = field(default_factory=dict)


@functools.lru_cache(maxsize=16)
def _ransac_picks(n: int, n_iter: int, seed: int) -> np.ndarray:
    """The (n_iter, 3) index triples that ``n_iter`` successive
    ``choice(n, 3, replace=False)`` draws of ``default_rng(seed)`` give:
    the reference's picks, which depend on ``n`` alone, so drawn once
    (read-only)."""
    rng = np.random.default_rng(seed)
    picks = np.stack([rng.choice(n, size=3, replace=False)
                      for _ in range(n_iter)])
    picks.setflags(write=False)
    return picks


def _lstsq_stack(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.linalg.lstsq(a[i], b[i], rcond=None)[0]`` for a stack of
    float64 systems (S, m, n), (S, m, k) at once: the minimum-norm
    solution through the SVD, singular values at or below
    eps * max(m, n) * s_max taken as zero (LAPACK gelsd's rule)."""
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    keep = s > np.finfo(np.float64).eps * max(a.shape[1:]) * s[:, :1]
    s_inv = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
    return np.swapaxes(vt, 1, 2) @ (s_inv[:, :, None]
                                    * (np.swapaxes(u, 1, 2) @ b))


def ransac_affine_filter(tps: List[TiePoint], thresh_px: float = 3.0,
                         n_iter: int = 200, seed: int = 0) -> None:
    """AROSICS tie-point filter level 3: RANSAC consensus on the affine
    shift model [dy, dx](r, c) = A @ [r, c, 1] (arosics_coreg.py:92-112
    parameterises ``tieP_filter_level=3``; AROSICS implements it as a
    RANSAC over the shift field). Marks non-consensus points
    ``used=False`` with reason "ransac". Deterministic (seeded).
    Engages only with enough points for a meaningful consensus (>= 8);
    with fewer, the MAD stage is the better-conditioned filter.

    The reference's loop at once: its seeded triples
    (:func:`_ransac_picks`), every triple's least squares in one stacked
    SVD (:func:`_lstsq_stack`), every model scored in one product, and
    the first model with the most inliers kept, as the loop keeps it."""
    used = [t for t in tps if t.used]
    if len(used) < 8:
        return
    G = np.array([[t.row, t.col, 1.0] for t in used])
    D = np.array([[t.dy, t.dx] for t in used])
    picks = _ransac_picks(len(used), n_iter, seed)
    A = _lstsq_stack(G[picks], D[picks])
    inliers = np.linalg.norm(G @ A - D, axis=2) < thresh_px
    best_inliers = inliers[np.argmax(inliers.sum(axis=1))]
    if best_inliers.sum() < 3:
        return
    # refit on the consensus set and re-score all points against it
    A, *_ = np.linalg.lstsq(G[best_inliers], D[best_inliers], rcond=None)
    resid = np.linalg.norm(G @ A - D, axis=1)
    for t, r in zip(used, resid):
        if r >= thresh_px:
            t.used = False
            t.reject_reason = "ransac"


def _tie_point_grid(h: int, w: int, grid_res: float, win: Tuple[int, int],
                    max_points: Optional[int]) -> List[Tuple[int, int]]:
    wy, wx = win
    step = float(grid_res)
    if step <= 0:
        raise ValueError(f"grid_res must be > 0, got {grid_res}")
    rows = np.unique(np.arange(wy // 2, h - wy // 2, step).round()
                     .astype(int))
    cols = np.unique(np.arange(wx // 2, w - wx // 2, step).round()
                     .astype(int))
    pts = [(int(r), int(c)) for r in rows for c in cols]
    if max_points is not None and len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).round().astype(int)
        pts = [pts[i] for i in np.unique(idx)]
    return pts


def _device_of(x, device) -> torch.device:
    """``device`` resolved, or a tensor's own device where none is given."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _as_tensor(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """An array or tensor on ``dev`` (in ``dtype`` where given, else its
    own)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, dtype) if dtype is not None else x.to(dev)


def _cut_windows(img: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                wy: int, wx: int, nodata: Optional[float] = None):
    """The (N, wy, wx) windows of ``img`` (H, W) float32 at top-left
    corners ``r0`` / ``c0`` (N,) in one gather, each hole (not finite,
    or ``nodata``) filled with the mean of the window's valid pixels
    (summed in float64; 0 where none is valid), and whether more than
    half of each window is holes (N,) bool."""
    rows = r0[:, None] + torch.arange(wy, device=img.device)
    cols = c0[:, None] + torch.arange(wx, device=img.device)
    win = img[rows[:, :, None], cols[:, None, :]]
    bad = ~torch.isfinite(win)
    if nodata is not None:
        bad |= win == nodata
    n_bad = bad.sum(dim=(1, 2))
    total = torch.where(bad, 0.0, win).sum(dim=(1, 2), dtype=torch.float64)
    n_good = wy * wx - n_bad
    mean = torch.where(n_good > 0, total / n_good.clamp(min=1), 0.0)
    win = torch.where(bad, mean.to(torch.float32)[:, None, None], win)
    return win, 2 * n_bad > wy * wx


def coregister_local(
    ref_img,
    tgt_img,
    config: CoregConfig = CoregConfig(),
    ref_nodata: Optional[float] = None,
    tgt_nodata: Optional[float] = None,
    lowpass_frac: float = 1.0,
    device=None,
) -> CoregResult:
    """Estimate the local shift field of ``tgt_img`` relative to
    ``ref_img`` (both single-band (H, W) on the SAME grid; NumPy arrays
    or tensors) and return the fitted affine shift model + tie points.
    Use ``deshift`` to apply. The windows are cut, filled and matched on
    ``device`` (module docstring); the filters run on the host."""
    cfg = config
    dev = _device_of(tgt_img, device)
    h, w = tgt_img.shape
    wy, wx = int(cfg.window_size[1]), int(cfg.window_size[0])
    wy = min(wy, h)
    wx = min(wx, w)
    # FFT-friendly even sizes
    wy -= wy % 2
    wx -= wx % 2
    if wy < 16 or wx < 16:
        return CoregResult(False, None,
                           info={"error": "image too small for matching"})

    pts = _tie_point_grid(h, w, cfg.grid_res, (wy, wx), cfg.max_points)
    if not pts:
        # single central window fallback
        pts = [(h // 2, w // 2)]

    with span("coreg.match", dev):
        rc = np.array(pts, dtype=np.int64).reshape(-1, 2)
        r0 = torch.from_numpy(np.clip(rc[:, 0] - wy // 2, 0, h - wy)).to(dev)
        c0 = torch.from_numpy(np.clip(rc[:, 1] - wx // 2, 0, w - wx)).to(dev)
        ref_w, ref_over = _cut_windows(
            _as_tensor(ref_img, dev, torch.float32), r0, c0, wy, wx,
            ref_nodata)
        tgt_w, tgt_over = _cut_windows(
            _as_tensor(tgt_img, dev, torch.float32), r0, c0, wy, wx,
            tgt_nodata)
        dy, dx, rel = phase_correlate_batch(ref_w, tgt_w,
                                            lowpass_frac=float(lowpass_frac),
                                            device=dev)
        del ref_w, tgt_w
        # the one read of the match: shifts, reliabilities, kept windows
        dy, dx, rel, kept = torch.stack(
            [dy, dx, rel, (~(ref_over | tgt_over)).to(torch.float32)]
        ).cpu().numpy()
        keep = [i for i in range(len(pts)) if kept[i]]
        count(WINDOWS_COUNTER, len(keep))

    if not keep:
        return CoregResult(False, None,
                           info={"error": "no usable matching windows"})

    with span("coreg.filter", dev):
        return _filter_and_fit(cfg, pts, keep, dy, dx, rel, [wx, wy])


def _filter_and_fit(cfg: CoregConfig, pts, keep, dy, dx, rel,
                    window) -> CoregResult:
    """The reference's tie-point filters (levels 1-3) and affine fit over
    the kept windows ``keep`` (indices into ``pts``), on the host."""
    tps: List[TiePoint] = []
    for i in keep:
        r, c = pts[i]
        tp = TiePoint(col=c, row=r, dy=float(dy[i]), dx=float(dx[i]),
                      reliability=float(rel[i]))
        # filter level 1: reliability (arosics tieP_filter_level >= 1)
        if cfg.tie_point_filter_level >= 1 and tp.reliability < cfg.min_reliability:
            tp.used = False
            tp.reject_reason = "reliability"
        # filter level 2: max shift
        if (tp.used and cfg.tie_point_filter_level >= 2
                and (abs(tp.dy) > cfg.max_shift or abs(tp.dx) > cfg.max_shift)):
            tp.used = False
            tp.reject_reason = "max_shift"
        tps.append(tp)

    # filter level 3: robust MAD outlier rejection on the shift field
    if cfg.tie_point_filter_level >= 3:
        used = [t for t in tps if t.used]
        if len(used) >= 4:
            for comp in ("dy", "dx"):
                live = [t for t in tps if t.used]
                vals = np.array([getattr(t, comp) for t in live])
                med = np.median(vals)
                mad = np.median(np.abs(vals - med)) + 1e-9
                out = np.abs(vals - med) > 4.0 * 1.4826 * mad
                for t in itertools.compress(live, out):
                    t.used = False
                    t.reject_reason = "mad_outlier"

    # filter level 3 (continued): RANSAC consensus on the affine shift
    # model — the AROSICS level-3 mechanism; the MAD stage above covers
    # the small-n regime where RANSAC is ill-posed
    if cfg.tie_point_filter_level >= 3:
        ransac_affine_filter(tps, thresh_px=getattr(
            cfg, "ransac_thresh_px", 3.0))

    used = [t for t in tps if t.used]
    if not used:
        return CoregResult(False, None, tie_points=tps,
                           info={"error": "all tie points rejected"})

    # affine shift model [dy, dx](r, c) = A @ [r, c, 1]
    if len(used) >= 3:
        G = np.array([[t.row, t.col, 1.0] for t in used])
        D = np.array([[t.dy, t.dx] for t in used])
        A, *_ = np.linalg.lstsq(G, D, rcond=None)
        affine = A.T  # (2, 3)
    else:
        mdy = float(np.mean([t.dy for t in used]))
        mdx = float(np.mean([t.dx for t in used]))
        affine = np.array([[0.0, 0.0, mdy], [0.0, 0.0, mdx]])

    mean_shift = (float(np.mean([t.dy for t in used])),
                  float(np.mean([t.dx for t in used])))
    count(TIEPOINTS_COUNTER, len(used))
    return CoregResult(
        True, None, tie_points=tps, mean_shift_px=mean_shift,
        affine=affine,
        info={"n_candidates": len(pts), "n_matched": len(keep),
              "n_used": len(used),
              "window": window, "grid_res": cfg.grid_res})


def tps_fit_residuals(points_rc: np.ndarray, residuals: np.ndarray,
                      smoothing: float = 0.0):
    """Fit a thin-plate spline to tie-point residuals (n, 2) -> (n, 2).

    Classic TPS normal system [[K + λI, P], [Pᵀ, 0]] with the radial
    kernel U(d) = d² log d, solved per component in f64 on the host.
    Returns (weights (n, 2), affine_part (3, 2)) for
    :func:`tps_evaluate`."""
    pts = np.asarray(points_rc, dtype=np.float64)
    vals = np.asarray(residuals, dtype=np.float64)
    n = len(pts)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    K = 0.5 * d2 * np.log(np.maximum(d2, 1e-20))
    K[np.diag_indices(n)] = smoothing * n
    P = np.concatenate([np.ones((n, 1)), pts], axis=1)
    L = np.zeros((n + 3, n + 3))
    L[:n, :n] = K
    L[:n, n:] = P
    L[n:, :n] = P.T
    rhs = np.zeros((n + 3, 2))
    rhs[:n] = vals
    sol = np.linalg.solve(L, rhs)
    return sol[:n], sol[n:]


def tps_evaluate(points_rc: np.ndarray, weights: np.ndarray,
                 affine_part: np.ndarray, rr: np.ndarray,
                 cc: np.ndarray, chunk: int = 65536) -> np.ndarray:
    """Evaluate the fitted TPS at grid points; returns (..., 2)."""
    pts = np.asarray(points_rc, dtype=np.float64)
    q = np.stack([rr.ravel(), cc.ravel()], axis=1).astype(np.float64)
    out = np.empty((len(q), 2), dtype=np.float64)
    for i0 in range(0, len(q), chunk):
        qq = q[i0:i0 + chunk]
        d2 = ((qq[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        U = 0.5 * d2 * np.log(np.maximum(d2, 1e-20))
        out[i0:i0 + chunk] = (U @ weights
                              + affine_part[0]
                              + qq @ affine_part[1:])
    return out.reshape(rr.shape + (2,)).astype(np.float32)


def shift_field(result: CoregResult, shape_hw,
                local_residuals: bool = False,
                idw_power: float = 2.0,
                idw_radius: Optional[float] = None,
                mode: str = "idw",
                tps_smoothing: float = 0.0,
                device=None):
    """Evaluate the fitted shift model over an (H, W) grid: the affine
    component, optionally plus interpolation of the tie-point residuals
    — the non-affine local deshift corresponding to AROSICS' tie-point
    shift field. ``mode``: "idw" (inverse-distance weighting) or "tps"
    (thin-plate spline, AROSICS' smooth full-local correction).
    Returns (dy, dx) float32 (H, W): NumPy arrays, evaluated on the host
    as in the reference, where ``device`` is None; else tensors on
    ``device``, by the same formulas in the same order and precision
    (:func:`_shift_field_device`)."""
    assert result.affine is not None
    if device is not None:
        return _shift_field_device(result, shape_hw, resolve_device(device),
                                   local_residuals, idw_power, idw_radius,
                                   mode, tps_smoothing)
    h, w = shape_hw
    rr, cc = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    A = result.affine
    dy = A[0, 0] * rr + A[0, 1] * cc + A[0, 2]
    dx = A[1, 0] * rr + A[1, 1] * cc + A[1, 2]
    used = [t for t in result.tie_points if t.used]
    if local_residuals and len(used) >= 3:
        pr = np.array([t.row for t in used], dtype=np.float32)
        pc = np.array([t.col for t in used], dtype=np.float32)
        res_y = np.array([t.dy - (A[0, 0] * t.row + A[0, 1] * t.col
                                  + A[0, 2]) for t in used],
                         dtype=np.float32)
        res_x = np.array([t.dx - (A[1, 0] * t.row + A[1, 1] * t.col
                                  + A[1, 2]) for t in used],
                         dtype=np.float32)
        if mode == "tps":
            pts = np.stack([pr, pc], axis=1)
            wgt, aff = tps_fit_residuals(pts,
                                         np.stack([res_y, res_x], axis=1),
                                         smoothing=tps_smoothing)
            resid = tps_evaluate(pts, wgt, aff, rr, cc)
            dy = dy + resid[..., 0]
            dx = dx + resid[..., 1]
        else:
            # chunked evaluation: the (pixels, n_tiepoints) distance
            # temp is bounded (~chunk*n*4 B) — an unchunked granule-
            # scale grid (1e8 px x 500 points) would need hundreds of
            # GB (the TPS path bounds its temp the same way)
            rf = rr.reshape(-1)
            cf = cc.reshape(-1)
            ry = np.zeros(rf.shape[0], dtype=np.float32)
            rx = np.zeros(rf.shape[0], dtype=np.float32)
            chunk = max(1, (1 << 22) // max(1, len(used)))
            for s in range(0, rf.shape[0], chunk):
                e = min(s + chunk, rf.shape[0])
                d2 = ((rf[s:e, None] - pr) ** 2
                      + (cf[s:e, None] - pc) ** 2)
                if idw_radius is not None:
                    wgt = np.where(d2 <= idw_radius ** 2,
                                   1.0 / (d2 ** (idw_power / 2.0) + 1.0),
                                   0.0)
                else:
                    wgt = 1.0 / (d2 ** (idw_power / 2.0) + 1.0)
                wsum = wgt.sum(-1) + 1e-12
                ry[s:e] = (wgt * res_y).sum(-1) / wsum
                rx[s:e] = (wgt * res_x).sum(-1) / wsum
            dy = dy + ry.reshape(h, w)
            dx = dx + rx.reshape(h, w)
    return dy.astype(np.float32), dx.astype(np.float32)


def _residuals(result: CoregResult):
    """Row, column and affine residuals (dy, dx) of the used tie points,
    float32 (n,) each, as :func:`shift_field` computes them."""
    A = result.affine
    used = [t for t in result.tie_points if t.used]
    pr = np.array([t.row for t in used], dtype=np.float32)
    pc = np.array([t.col for t in used], dtype=np.float32)
    res_y = np.array([t.dy - (A[0, 0] * t.row + A[0, 1] * t.col + A[0, 2])
                      for t in used], dtype=np.float32)
    res_x = np.array([t.dx - (A[1, 0] * t.row + A[1, 1] * t.col + A[1, 2])
                      for t in used], dtype=np.float32)
    return pr, pc, res_y, res_x


def _shift_field_device(result: CoregResult, shape_hw, dev: torch.device,
                        local_residuals: bool, idw_power: float,
                        idw_radius: Optional[float], mode: str,
                        tps_smoothing: float):
    """:func:`shift_field` on ``dev``: the affine in float64 (NumPy
    promotes the float32 grid by the float64 coefficients), the IDW
    residuals in float32 and the TPS in float64, each over chunks of
    pixels; (dy, dx) float32 tensors (H, W)."""
    h, w = shape_hw
    A = [[float(v) for v in row] for row in result.affine]
    rr = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    cc = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    dy = A[0][0] * rr + A[0][1] * cc + A[0][2]
    dx = A[1][0] * rr + A[1][1] * cc + A[1][2]
    n_used = sum(t.used for t in result.tie_points)
    if local_residuals and n_used >= 3:
        pr, pc, res_y, res_x = _residuals(result)
        ry = torch.empty(h * w, dtype=torch.float64, device=dev)
        rx = torch.empty_like(ry)
        chunk = max(1, (1 << 24) // n_used)
        if mode == "tps":
            pts = np.stack([pr, pc], axis=1)
            wgt, aff = tps_fit_residuals(pts, np.stack([res_y, res_x], axis=1),
                                         smoothing=tps_smoothing)
            pts_t, wgt_t, aff_t = (torch.from_numpy(np.asarray(a, np.float64))
                                   .to(dev) for a in (pts, wgt, aff))
            for s in range(0, h * w, chunk):
                k = torch.arange(s, min(s + chunk, h * w), device=dev)
                qq = torch.stack([(k // w).to(torch.float64),
                                  (k % w).to(torch.float64)], dim=1)
                d2 = ((qq[:, None, :] - pts_t[None, :, :]) ** 2).sum(-1)
                U = 0.5 * d2 * torch.log(torch.clamp(d2, min=1e-20))
                out = (U @ wgt_t + aff_t[0] + qq @ aff_t[1:]).to(torch.float32)
                ry[s:s + len(k)] = out[:, 0]
                rx[s:s + len(k)] = out[:, 1]
        else:
            pr_t, pc_t, ry_t, rx_t = (torch.from_numpy(a).to(dev)
                                      for a in (pr, pc, res_y, res_x))
            for s in range(0, h * w, chunk):
                k = torch.arange(s, min(s + chunk, h * w), device=dev)
                d2 = (((k // w).to(torch.float32)[:, None] - pr_t) ** 2
                      + ((k % w).to(torch.float32)[:, None] - pc_t) ** 2)
                wgt = 1.0 / (d2 ** (idw_power / 2.0) + 1.0)
                if idw_radius is not None:
                    wgt = torch.where(d2 <= idw_radius ** 2, wgt, 0.0)
                wsum = wgt.sum(-1) + 1e-12
                ry[s:s + len(k)] = (wgt * ry_t).sum(-1) / wsum
                rx[s:s + len(k)] = (wgt * rx_t).sum(-1) / wsum
        dy = dy + ry.reshape(h, w)
        dx = dx + rx.reshape(h, w)
    return dy.to(torch.float32), dx.to(torch.float32)


def deshift_hwb(stack: torch.Tensor, result: CoregResult,
                nodata: Optional[float] = None, method: str = "cubic",
                local_residuals: bool = False,
                residual_mode: str = "idw") -> torch.Tensor:
    """:func:`deshift` of a (B, H, W) tensor of any dtype, on its device,
    returned as (H, W, B) float32 there: the shift field, the sampling
    positions (r + dy, c + dx), the stack to (H, W, B) float32 in one
    copy, the warp (``fill``: ``nodata`` in float32, else NaN)."""
    dev = stack.device
    b, h, w = stack.shape
    rows, cols = shift_field(result, (h, w), local_residuals=local_residuals,
                             mode=residual_mode, device=dev)
    rows += torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols += torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    img = torch.empty((h, w, b), dtype=torch.float32, device=dev)
    img.copy_(stack.permute(1, 2, 0))
    return warp_interpolate_chunked(
        img, rows, cols, nodata=nodata, method=method,
        fill=float(np.float32(nodata)) if nodata is not None else np.nan)


def _cast_product(out_hwb: torch.Tensor, out_dtype: torch.dtype,
                  nodata: Optional[float]) -> torch.Tensor:
    """The eager deshift's (H, W, B) float32 stack as (B, H, W) in
    ``out_dtype``: float32; or u16, as the reference writes it: NaN to
    ``nodata`` (0 without one), clipped to [0, 65535], then truncated."""
    if out_dtype == torch.float32:
        return out_hwb.permute(2, 0, 1).contiguous()
    q = out_hwb.nan_to_num_(nan=nodata if nodata is not None else 0.0)
    q = q.clamp_(0, 65535).to(torch.int32).to(torch.uint16)
    return q.permute(2, 0, 1).contiguous()


def deshift_product(stack: torch.Tensor, result: CoregResult,
                    out_dtype: torch.dtype, nodata: Optional[float] = None,
                    method: str = "cubic", local_residuals: bool = False,
                    residual_mode: str = "idw") -> torch.Tensor:
    """The deshifted (B, H, W) tensor ``stack`` as (B, H, W) in
    ``out_dtype`` (float32, or uint16 cast as :func:`_cast_product`
    casts), on the stack's device. Where
    :func:`~hyperres_torch.kernels.deshift_warp.takes_kernel` holds, one
    kernel launch (counted as ``deshift.kernel`` in the open span), with
    the local residuals' field made by :func:`shift_field`; else
    :func:`deshift_hwb` and the cast."""
    if takes_kernel(stack.device, stack.dtype, method):
        dy = dx = None
        if local_residuals:
            dy, dx = shift_field(result, stack.shape[1:],
                                 local_residuals=True, mode=residual_mode,
                                 device=stack.device)
        out = deshift_warp(stack.contiguous(), result.affine, out_dtype,
                           dy=dy, dx=dx, nodata=nodata, method=method)
        count(DESHIFT_COUNTER)
        return out
    return _cast_product(
        deshift_hwb(stack, result, nodata=nodata, method=method,
                    local_residuals=local_residuals,
                    residual_mode=residual_mode), out_dtype, nodata)


def deshift(
    tgt_stack,
    result: CoregResult,
    nodata: Optional[float] = None,
    method: str = "cubic",
    local_residuals: bool = False,
    residual_mode: str = "idw",
    device=None,
):
    """Apply the fitted shift model: resample the target at
    (r + dy(r, c), c + dx(r, c)) — the correct_shifts equivalent.
    ``local_residuals`` adds the tie-point residual field (AROSICS'
    local, non-affine deshift) interpolated by ``residual_mode``
    ("idw" or "tps"). tgt_stack (B, H, W) -> (B, H, W) float32: a NumPy
    array for an array, a tensor on ``device`` for a tensor.

    The field and the warp run on ``device`` (:func:`deshift_product`: on
    the card one kernel; the eager warp's temporaries of a 9600 x 9600 x
    10 stack stay under ~30 GB)."""
    dev = _device_of(tgt_stack, device)
    out = deshift_product(_as_tensor(tgt_stack, dev), result, torch.float32,
                          nodata=nodata, method=method,
                          local_residuals=local_residuals,
                          residual_mode=residual_mode)
    return out if isinstance(tgt_stack, torch.Tensor) else out.cpu().numpy()

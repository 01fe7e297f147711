# Port-owned copy of hyperres/coreg/local.py: the host parts verbatim
# (TiePoint, CoregResult, ransac_affine_filter :51 with its seeded
# generator, _tie_point_grid :88, tps_fit_residuals :226, tps_evaluate
# :251, shift_field :268, coregister_local's window extraction and
# filters); the phase correlation and the deshift warp run on the device.
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

In the port, ``coregister_local`` cuts the windows and fills their holes
with the window's ``nanmean`` on the host, as the reference does (the
windows are then the reference's to the bit), and runs the batched
phase correlation on ``device``; ``deshift`` evaluates the shift field
on the host (NumPy, as the reference) and warps the stack on ``device``
with :func:`~hyperres_torch.kernels.warp.warp_interpolate_chunked`.
Both take ``device`` (default the current CUDA device; ``"cpu"`` for
the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import CoregConfig
from ..device import resolve_device
from ..kernels.phasecorr import phase_correlate_batch
from ..kernels.warp import warp_interpolate_chunked


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


def ransac_affine_filter(tps: List[TiePoint], thresh_px: float = 3.0,
                         n_iter: int = 200, seed: int = 0) -> None:
    """AROSICS tie-point filter level 3: RANSAC consensus on the affine
    shift model [dy, dx](r, c) = A @ [r, c, 1] (arosics_coreg.py:92-112
    parameterises ``tieP_filter_level=3``; AROSICS implements it as a
    RANSAC over the shift field). Marks non-consensus points
    ``used=False`` with reason "ransac". Deterministic (seeded).
    Engages only with enough points for a meaningful consensus (>= 8);
    with fewer, the MAD stage is the better-conditioned filter."""
    used = [t for t in tps if t.used]
    if len(used) < 8:
        return
    G = np.stack([[t.row, t.col, 1.0] for t in used])
    D = np.stack([[t.dy, t.dx] for t in used])
    rng = np.random.default_rng(seed)
    best_inliers: Optional[np.ndarray] = None
    for _ in range(n_iter):
        pick = rng.choice(len(used), size=3, replace=False)
        try:
            A, *_ = np.linalg.lstsq(G[pick], D[pick], rcond=None)
        except np.linalg.LinAlgError:
            continue
        resid = np.linalg.norm(G @ A - D, axis=1)
        inliers = resid < thresh_px
        if best_inliers is None or inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    if best_inliers is None or best_inliers.sum() < 3:
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


def coregister_local(
    ref_img: np.ndarray,
    tgt_img: np.ndarray,
    config: CoregConfig = CoregConfig(),
    ref_nodata: Optional[float] = None,
    tgt_nodata: Optional[float] = None,
    lowpass_frac: float = 1.0,
    device=None,
) -> CoregResult:
    """Estimate the local shift field of ``tgt_img`` relative to
    ``ref_img`` (both single-band (H, W) on the SAME grid) and return the
    fitted affine shift model + tie points. Use ``deshift`` to apply.
    The windows' phase correlation runs on ``device``."""
    cfg = config
    dev = resolve_device(device)
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

    ref_wins, tgt_wins, keep = [], [], []
    for (r, c) in pts:
        r0 = min(max(r - wy // 2, 0), h - wy)
        c0 = min(max(c - wx // 2, 0), w - wx)
        rw = ref_img[r0:r0 + wy, c0:c0 + wx]
        tw = tgt_img[r0:r0 + wy, c0:c0 + wx]
        bad_r = ~np.isfinite(rw)
        bad_t = ~np.isfinite(tw)
        if ref_nodata is not None:
            bad_r |= rw == ref_nodata
        if tgt_nodata is not None:
            bad_t |= tw == tgt_nodata
        if bad_r.mean() > 0.5 or bad_t.mean() > 0.5:
            continue
        ref_wins.append(np.where(bad_r, np.nanmean(rw[~bad_r]) if
                                 (~bad_r).any() else 0.0, rw))
        tgt_wins.append(np.where(bad_t, np.nanmean(tw[~bad_t]) if
                                 (~bad_t).any() else 0.0, tw))
        keep.append((r, c))

    if not keep:
        return CoregResult(False, None,
                           info={"error": "no usable matching windows"})

    dy, dx, rel = phase_correlate_batch(
        np.stack(ref_wins).astype(np.float32),
        np.stack(tgt_wins).astype(np.float32),
        lowpass_frac=float(lowpass_frac), device=dev)
    dy = dy.cpu().numpy()
    dx = dx.cpu().numpy()
    rel = rel.cpu().numpy()

    tps: List[TiePoint] = []
    for i, (r, c) in enumerate(keep):
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
                vals = np.array([getattr(t, comp) for t in tps if t.used])
                med = np.median(vals)
                mad = np.median(np.abs(vals - med)) + 1e-9
                for t in tps:
                    if t.used and abs(getattr(t, comp) - med) > 4.0 * 1.4826 * mad:
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
        G = np.stack([[t.row, t.col, 1.0] for t in used])
        D = np.stack([[t.dy, t.dx] for t in used])
        A, *_ = np.linalg.lstsq(G, D, rcond=None)
        affine = A.T  # (2, 3)
    else:
        mdy = float(np.mean([t.dy for t in used]))
        mdx = float(np.mean([t.dx for t in used]))
        affine = np.array([[0.0, 0.0, mdy], [0.0, 0.0, mdx]])

    mean_shift = (float(np.mean([t.dy for t in used])),
                  float(np.mean([t.dx for t in used])))
    return CoregResult(
        True, None, tie_points=tps, mean_shift_px=mean_shift,
        affine=affine,
        info={"n_candidates": len(pts), "n_matched": len(keep),
              "n_used": len(used),
              "window": [wx, wy], "grid_res": cfg.grid_res})


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
                tps_smoothing: float = 0.0):
    """Evaluate the fitted shift model over an (H, W) grid: the affine
    component, optionally plus interpolation of the tie-point residuals
    — the non-affine local deshift corresponding to AROSICS' tie-point
    shift field. ``mode``: "idw" (inverse-distance weighting) or "tps"
    (thin-plate spline, AROSICS' smooth full-local correction).
    Returns (dy, dx) float32 (H, W)."""
    assert result.affine is not None
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


def deshift(
    tgt_stack: np.ndarray,
    result: CoregResult,
    nodata: Optional[float] = None,
    method: str = "cubic",
    local_residuals: bool = False,
    residual_mode: str = "idw",
    device=None,
) -> np.ndarray:
    """Apply the fitted shift model: resample the target at
    (r + dy(r, c), c + dx(r, c)) — the correct_shifts equivalent.
    ``local_residuals`` adds the tie-point residual field (AROSICS'
    local, non-affine deshift) interpolated by ``residual_mode``
    ("idw" or "tps"). tgt_stack (B, H, W) -> (B, H, W) float32.

    The field is the reference's, on the host; the warp runs on
    ``device`` over band chunks (``warp_interpolate_chunked``: the
    temporaries of a 9600 x 9600 x 10 stack stay under ~30 GB)."""
    dev = resolve_device(device)
    b, h, w = tgt_stack.shape
    dy, dx = shift_field(result, (h, w), local_residuals=local_residuals,
                         mode=residual_mode)
    # reuse the shift planes as the sampling field (broadcast aranges
    # instead of a second pair of full (H, W) meshgrid planes)
    rows = dy
    rows += np.arange(h, dtype=np.float32)[:, None]
    cols = dx
    cols += np.arange(w, dtype=np.float32)[None, :]
    # (B, H, W) up as it lies, to (H, W, B) on the device
    img = torch.from_numpy(np.ascontiguousarray(tgt_stack,
                                                dtype=np.float32))
    img = img.to(dev).permute(1, 2, 0).contiguous()
    out = warp_interpolate_chunked(
        img, torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
        nodata=nodata, method=method,
        fill=float(np.float32(nodata)) if nodata is not None else np.nan)
    del img
    return out.permute(2, 0, 1).contiguous().cpu().numpy()

"""Plain reference of S2-to-EMIT local coregistration (AROSICS
``COREG_LOCAL`` then ``correct_shifts``, as
martasumyk/hyperspectral_super-resolution ``s2_emit/arosics_coreg.py:92-184``
parameterises it), in float32 PyTorch (TF32 off) and NumPy.

1. The EMIT band onto the S2 10 m grid: a separable cubic (a = -0.5)
   transfer, each axis a dense (dst, src) matrix of the four taps at the
   destination centre's fractional source index, in float32 (taps outside the
   source dropped, rows whose centre lies outside it all zero); the
   valid mask (finite, not nodata) goes through the same products and
   renormalises, NaN where its mass is within 1e-6 of 0.
2. The tie-point grid: rows and columns from half a window in, every
   ``grid_res`` px, rounded; at most ``max_points``, taken evenly.
3. Each window pair cut in NumPy from the two images on the host; a
   window more than half holes (not finite, or nodata) is dropped, and
   the holes of the others are filled with the mean of the window's
   valid pixels (NumPy, in float64: the mean rounded once to float32).
4. Phase correlation per window, in float32 on the device: the mean
   removed, a Hann taper, rFFT2, the cross-power spectrum over its
   magnitude (+1e-12), zero beyond ``lowpass`` of Nyquist in radius,
   irFFT2; the first maximum, a three-point parabola per axis around it
   (wrapped neighbours, offset within +-0.5), shifts past half the
   window unwrapped, and negated (the target's displacement);
   reliability 100 (1 - exp(-snr / 20.8)), snr the peak over the
   surface's mean in population standard deviations.
5. Filters: level 1 reliability below ``min_reliability``; level 2 a
   shift beyond ``max_shift``; level 3 a MAD test per component (dy then
   dx, 4 x 1.4826 MAD) where >= 4 points remain, then, where >= 8
   remain, a RANSAC of the affine shift model: 200 draws of 3 points by
   NumPy's ``default_rng(0)`` ``choice(n, 3, replace=False)``, each a
   least-squares fit scored by the points within ``ransac_thresh_px``
   (the first best kept), a refit on the best set, and every point at
   or past the threshold rejected.
6. The affine model [dy, dx] = A [r, c, 1] by least squares in float64
   over the used points (their mean where fewer than 3).
7. The deshift: the field in float64, rounded to float32, added to the
   pixel indices in float32; per band, 16 taps (rows outer), each tap
   valid where inside the stack and neither nodata nor NaN, the sum
   renormalised by the valid weight mass; fill where the mass is within
   1e-6 of 0 or the position leaves [-0.5, size - 0.5]; u16 as the
   product is written: NaN to nodata, clipped to [0, 65535], truncated.

Departures from AROSICS, as the program's ``coreg/local.py`` notes its
own: the matching is whole-window phase correlation with a spectral
low-pass, not AROSICS' iterative subpixel search; the reliability is the
repository's peak prominence; level 3 is the MAD plus RANSAC pair; the
deshift is one affine field, not AROSICS' per-tie-point grid warp. The
EMIT band is matched with its holes filled, where AROSICS masks them.

Nothing here imports the program. Matrix products follow
``torch.backends.cuda.matmul.allow_tf32`` (``granule.precision``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .granule import precision

RELIABILITY_TAU = 20.8
#: the renormalisation's threshold on the valid weight mass
MASS_EPS = 1e-6


def cubic(x):
    """The cubic convolution kernel, a = -0.5, at distance ``x`` (a NumPy
    array or a tensor)."""
    a = -0.5
    xp = torch if isinstance(x, torch.Tensor) else np
    ax = xp.abs(x)
    near = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    far = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return xp.where(ax <= 1.0, near, xp.where(ax < 2.0, far, 0.0))


def axis_matrix(pos: np.ndarray, src: int) -> np.ndarray:
    """(len(pos), src) float32: the four cubic taps of each fractional
    source index ``pos`` (held in float32, as the repository's grid
    transfers state it); taps outside the source dropped, zero rows
    where the centre lies outside [-0.5, src - 0.5]."""
    pos = np.asarray(pos, dtype=np.float32).astype(np.float64)
    m = np.zeros((len(pos), src), dtype=np.float64)
    i0 = np.floor(pos).astype(np.int64)
    t = pos - i0
    inside = (pos >= -0.5) & (pos <= src - 0.5)
    d = np.arange(len(pos))
    for k in (-1, 0, 1, 2):
        j = i0 + k
        ok = inside & (j >= 0) & (j < src)
        m[d[ok], j[ok]] = cubic(t[ok] - k)
    return m.astype(np.float32)


def resample(emit: torch.Tensor, src, dst, nodata: Optional[float]
             ) -> torch.Tensor:
    """Step 1: the (src.height, src.width) band on grid ``src`` at the
    centres of grid ``dst`` (both north-up, one CRS): (H, W) float32."""
    xs = dst.x0 + (np.arange(dst.width) + 0.5) * dst.dx
    ys = dst.y0 - (np.arange(dst.height) + 0.5) * dst.dy
    dev = emit.device
    wr = torch.as_tensor(axis_matrix((src.y0 - ys) / src.dy - 0.5,
                                     src.height), device=dev)
    wc = torch.as_tensor(axis_matrix((xs - src.x0) / src.dx - 0.5,
                                     src.width), device=dev)
    ok = torch.isfinite(emit)
    if nodata is not None:
        ok &= emit != nodata
    num = wr @ torch.where(ok, emit, 0.0) @ wc.T
    den = wr @ ok.to(torch.float32) @ wc.T
    good = den.abs() > MASS_EPS
    return torch.where(good, num / torch.where(good, den, 1.0), np.nan)


def tie_point_grid(h: int, w: int, grid_res: float, wy: int, wx: int,
                   max_points: Optional[int]) -> List[Tuple[int, int]]:
    """Step 2."""
    rows = np.unique(np.round(np.arange(wy // 2, h - wy // 2, grid_res))
                     .astype(int))
    cols = np.unique(np.round(np.arange(wx // 2, w - wx // 2, grid_res))
                     .astype(int))
    pts = [(int(r), int(c)) for r in rows for c in cols]
    if max_points is not None and len(pts) > max_points:
        take = np.unique(np.round(np.linspace(0, len(pts) - 1, max_points))
                         .astype(int))
        pts = [pts[i] for i in take]
    return pts


def window(img: np.ndarray, r: int, c: int, wy: int, wx: int,
           nodata: Optional[float]) -> Optional[np.ndarray]:
    """Step 3 for one window: the filled window, or None where more than
    half of it is holes."""
    h, w = img.shape
    r0 = min(max(r - wy // 2, 0), h - wy)
    c0 = min(max(c - wx // 2, 0), w - wx)
    win = img[r0:r0 + wy, c0:c0 + wx]
    bad = ~np.isfinite(win)
    if nodata is not None:
        bad |= win == nodata
    if bad.mean() > 0.5:
        return None
    fill = np.float32(np.mean(win[~bad].astype(np.float64))) \
        if (~bad).any() else np.float32(0.0)
    return np.where(bad, fill, win).astype(np.float32)


def phase_correlate(ref: torch.Tensor, tgt: torch.Tensor, lowpass: float,
                    bf16: bool = False):
    """Step 4 on (N, h, w) float32 windows: (dy, dx, reliability) float32
    NumPy arrays. ``bf16``: the windows rounded to bfloat16 first (the
    control)."""
    if bf16:
        ref = ref.to(torch.bfloat16).to(torch.float32)
        tgt = tgt.to(torch.bfloat16).to(torch.float32)
    n, h, w = ref.shape
    dev = ref.device
    hann = torch.as_tensor(np.outer(np.hanning(h), np.hanning(w))
                           .astype(np.float32), device=dev)
    fa = torch.fft.rfft2((ref - ref.mean(dim=(1, 2), keepdim=True)) * hann)
    fb = torch.fft.rfft2((tgt - tgt.mean(dim=(1, 2), keepdim=True)) * hann)
    x = fa * torch.conj(fb)
    x = x / (torch.abs(x) + 1e-12)
    if lowpass < 1.0:
        fy = np.fft.fftfreq(h)[:, None]
        fx = np.fft.rfftfreq(w)[None, :]
        keep = np.sqrt(fy * fy + fx * fx) / 0.5 <= lowpass
        x = x * torch.as_tensor(keep, device=dev)
    corr = torch.fft.irfft2(x, s=(h, w))
    flat = corr.reshape(n, -1)
    top = torch.argmax(flat, dim=1)
    py, px = top // w, top % w
    b = torch.arange(n, device=dev)
    c0 = corr[b, py, px]

    def offset(cm, cp):
        den = cm - 2.0 * c0 + cp
        ok = torch.abs(den) > 1e-12
        return torch.clamp(torch.where(
            ok, 0.5 * (cm - cp) / torch.where(ok, den, 1.0), 0.0), -0.5, 0.5)

    dy = py.to(torch.float32) + offset(corr[b, (py - 1) % h, px],
                                       corr[b, (py + 1) % h, px])
    dx = px.to(torch.float32) + offset(corr[b, py, (px - 1) % w],
                                       corr[b, py, (px + 1) % w])
    dy = -torch.where(dy > h / 2.0, dy - h, dy)
    dx = -torch.where(dx > w / 2.0, dx - w, dx)
    snr = (c0 - flat.mean(dim=1)) / (flat.std(dim=1, correction=0) + 1e-12)
    rel = 100.0 * (1.0 - torch.exp(-snr / RELIABILITY_TAU))
    return tuple(v.cpu().numpy() for v in (dy, dx, rel))


def ransac(pts: List[dict], thresh: float, n_iter: int = 200,
           seed: int = 0) -> None:
    """Level 3's RANSAC (step 5) over the used points, in place."""
    used = [p for p in pts if p["used"]]
    if len(used) < 8:
        return
    G = np.array([[p["row"], p["col"], 1.0] for p in used])
    D = np.array([[p["dy"], p["dx"]] for p in used])
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(n_iter):
        pick = rng.choice(len(used), size=3, replace=False)
        try:
            A = np.linalg.lstsq(G[pick], D[pick], rcond=None)[0]
        except np.linalg.LinAlgError:
            continue
        inl = np.linalg.norm(G @ A - D, axis=1) < thresh
        if best is None or inl.sum() > best.sum():
            best = inl
    if best is None or best.sum() < 3:
        return
    A = np.linalg.lstsq(G[best], D[best], rcond=None)[0]
    for p, r in zip(used, np.linalg.norm(G @ A - D, axis=1)):
        if r >= thresh:
            p["used"] = False


def filters(pts: List[dict], cfg: dict) -> None:
    """Step 5, in place on the kept points' ``used``."""
    level = cfg["tie_point_filter_level"]
    for p in pts:
        if level >= 1 and p["rel"] < cfg["min_reliability"]:
            p["used"] = False
        if p["used"] and level >= 2 and max(abs(p["dy"]), abs(p["dx"])) \
                > cfg["max_shift"]:
            p["used"] = False
    if level >= 3:
        if sum(p["used"] for p in pts) >= 4:
            for k in ("dy", "dx"):
                v = np.array([p[k] for p in pts if p["used"]])
                med = np.median(v)
                mad = np.median(np.abs(v - med)) + 1e-9
                for p in pts:
                    if p["used"] and abs(p[k] - med) > 4.0 * 1.4826 * mad:
                        p["used"] = False
        ransac(pts, cfg["ransac_thresh_px"])


def affine_fit(pts: List[dict]) -> Optional[np.ndarray]:
    """Step 6: (2, 3) float64, or None where no point is used."""
    used = [p for p in pts if p["used"]]
    if not used:
        return None
    D = np.array([[p["dy"], p["dx"]] for p in used])
    if len(used) < 3:
        m = D.mean(axis=0)
        return np.array([[0.0, 0.0, m[0]], [0.0, 0.0, m[1]]])
    G = np.array([[p["row"], p["col"], 1.0] for p in used])
    return np.linalg.lstsq(G, D, rcond=None)[0].T


def field(A: np.ndarray, h: int, w: int, device):
    """Step 7's sampling positions (rows, cols), (h, w) float32."""
    A = [[float(v) for v in row] for row in A]
    r = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    c = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    rows = (A[0][0] * r + A[0][1] * c + A[0][2]).to(torch.float32)
    cols = (A[1][0] * r + A[1][1] * c + A[1][2]).to(torch.float32)
    rows += torch.arange(h, dtype=torch.float32, device=device)[:, None]
    cols += torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return rows, cols


def deshift_u16(stack: torch.Tensor, A: np.ndarray, nodata: Optional[float],
                block: int = 1024, edge_px: float = 1e-3):
    """Step 7: the (B, H, W) u16 codes of the deshifted stack, and where
    they are sure (B, H, W) bool: not within a factor 2 of the mass
    threshold, nor within ``edge_px`` of the position's bounds, where
    two float32 evaluations of one field may part."""
    b, h, w = stack.shape
    dev = stack.device
    rows, cols = field(A, h, w, dev)
    fill = float(np.float32(nodata)) if nodata is not None else float("nan")
    out = torch.empty((b, h, w), dtype=torch.uint16, device=dev)
    sure = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    for s in range(0, h, block):
        rb, cb = rows[s:s + block], cols[s:s + block]
        r0, c0 = torch.floor(rb), torch.floor(cb)
        tr, tc = rb - r0, cb - c0
        r0, c0 = r0.to(torch.int64), c0.to(torch.int64)
        taps = [(r0 + i, cubic(tr - i), c0 + j, cubic(tc - j))
                for i in (-1, 0, 1, 2) for j in (-1, 0, 1, 2)]
        inside = (rb >= -0.5) & (rb <= h - 0.5) & (cb >= -0.5) \
            & (cb <= w - 0.5)
        near_edge = torch.zeros_like(inside)
        for x, n in ((rb, h), (cb, w)):
            near_edge |= ((x + 0.5).abs() < edge_px) \
                | ((x - (n - 0.5)).abs() < edge_px)
        for k in range(b):
            plane = stack[k].to(torch.float32)
            acc = torch.zeros_like(rb)
            mass = torch.zeros_like(rb)
            for ri, wr, ci, wc in taps:
                v = plane[ri.clamp(0, h - 1), ci.clamp(0, w - 1)]
                ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w) \
                    & torch.isfinite(v)
                if nodata is not None:
                    ok &= v != nodata
                wt = torch.where(ok, wr * wc, 0.0)
                acc += torch.where(ok, v, 0.0) * wt
                mass += wt
            good = (mass.abs() > MASS_EPS) & inside
            val = torch.where(good, acc / torch.where(good, mass, 1.0), fill)
            val = torch.nan_to_num(val, nan=nodata if nodata is not None
                                   else 0.0).clamp(0, 65535)
            out[k, s:s + block] = val.to(torch.int32).to(torch.uint16)
            m = mass.abs()
            sure[k, s:s + block] = ~(near_edge | ((m > 0.5 * MASS_EPS)
                                                  & (m < 2.0 * MASS_EPS)))
    return out, sure


def coregister(emit: torch.Tensor, emit_grid, stack: torch.Tensor, s2_grid,
               cfg: dict, band: int, nodata_emit: Optional[float],
               nodata_s2: Optional[float], control: bool = False) -> Dict:
    """Steps 1-7 for one attempt (the S2 band ``band``, 0-based): the
    candidate points (``row``, ``col``; ``kept``; for the kept ``dy``,
    ``dx``, ``rel``, ``used``), the affine (None where every point is
    rejected), and the u16 product with its sure mask (None without an
    affine). ``control``: the reference one precision lower, TF32 in
    the resample's products and the windows in bfloat16."""
    with precision(control):
        ref = resample(emit, emit_grid, s2_grid, nodata_emit)
    h, w = ref.shape
    wy, wx = (min(int(v), n) for v, n in zip(cfg["window_size"][::-1],
                                             (h, w)))
    wy, wx = wy - wy % 2, wx - wx % 2
    out = {"points": [], "affine": None, "codes": None, "sure": None}
    if wy < 16 or wx < 16:
        return out
    pts = tie_point_grid(h, w, cfg["grid_res"], wy, wx, cfg["max_points"])
    ref_np = ref.cpu().numpy()
    tgt_np = stack[band].to(torch.float32).cpu().numpy()
    del ref
    points, ref_w, tgt_w = [], [], []
    for r, c in pts:
        a = window(ref_np, r, c, wy, wx, None)
        b = window(tgt_np, r, c, wy, wx, nodata_s2)
        kept = a is not None and b is not None
        points.append({"row": r, "col": c, "kept": kept})
        if kept:
            ref_w.append(a)
            tgt_w.append(b)
    kept = [p for p in points if p["kept"]]
    out["points"] = points
    if not kept:
        return out
    dev = stack.device
    dy, dx, rel = phase_correlate(
        torch.as_tensor(np.stack(ref_w), device=dev),
        torch.as_tensor(np.stack(tgt_w), device=dev),
        min(1.0, s2_grid.dx / emit_grid.dx), bf16=control)
    for p, a, b, c in zip(kept, dy, dx, rel):
        p.update(dy=float(a), dx=float(b), rel=float(c), used=True)
    filters(kept, cfg)
    out["affine"] = affine_fit(kept)
    if out["affine"] is not None:
        out["codes"], out["sure"] = deshift_u16(stack, out["affine"],
                                                nodata_s2)
    return out

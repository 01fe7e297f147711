"""Port-owned NumPy copies of the reference's host precompute helpers.

These functions are plain NumPy, but in ``hyperres`` they live in
modules that import JAX at module level, so they cannot be imported on
a machine without JAX. The copies below are verbatim (bar ``xp``
defaults); ``tests/test_torch_host.py`` holds each one
``array_equal`` to its original. Each names its source line.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.constants import GLT_NODATA_VALUE
from ..core.crs import transform as crs_transform
from ..core.grid import Grid

# {band: (lambda_nm, response)} — the reference's SRF dict contract
SRFDict = Dict[str, Tuple[np.ndarray, np.ndarray]]


# -- hyperres/kernels/glt.py:25 ----------------------------------------------

def prepare_glt(glt: np.ndarray, raw_shape_yx: Tuple[int, int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side precompute: 1-based GLT (H, W, 2) -> (flat_idx, valid).

    flat_idx is int32 (H, W) of 0-based row indices into the flattened
    (raw_h * raw_w) pixel axis (0 where invalid — masked later), valid is
    bool (H, W). Out-of-bounds entries are dropped like the reference
    (emit_proj.py:698-703)."""
    raw_h, raw_w = raw_shape_yx
    glt = np.asarray(glt)
    valid = np.all(glt != GLT_NODATA_VALUE, axis=-1)
    gx = glt[..., 0].astype(np.int64) - 1
    gy = glt[..., 1].astype(np.int64) - 1
    in_bounds = (gy >= 0) & (gy < raw_h) & (gx >= 0) & (gx < raw_w)
    valid = valid & in_bounds
    flat = np.where(valid, gy * raw_w + gx, 0).astype(np.int32)
    return flat, valid


# -- hyperres/kernels/warp.py:51 ---------------------------------------------

def source_index_field(src_grid: Grid, dst_grid: Grid
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) float32 arrays of shape dst.shape: fractional source
    pixel indices (pixel centres at integers) of each destination pixel
    centre."""
    xs, ys = dst_grid.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    sx, sy = crs_transform(dst_grid.crs, src_grid.crs, X, Y)
    cols, rows = src_grid.colrow_of(sx, sy)
    return rows.astype(np.float32), cols.astype(np.float32)


# -- hyperres/kernels/warp.py:63 ---------------------------------------------

def separable_index_axes(src_grid: Grid, dst_grid: Grid
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """When src and dst share a CRS the mapping is separable: returns
    (rows (Hd,), cols (Wd,)) or None when reprojection is required."""
    if src_grid.crs != dst_grid.crs:
        return None
    xs, ys = dst_grid.pixel_center_coords()
    cols, _ = src_grid.colrow_of(xs, src_grid.y0)
    _, rows = src_grid.colrow_of(src_grid.x0, ys)
    return rows.astype(np.float32), cols.astype(np.float32)


# -- hyperres/kernels/warp.py:75 ---------------------------------------------

def scanline_cstar(rows: np.ndarray, cols: np.ndarray,
                   src_h: int) -> np.ndarray:
    """Pass-1 column-index field for the two-pass (Catmull-Smith) warp.

    rows/cols (Hd, Wd) are the dst->src fractional index fields. For each
    destination column j, its preimage in source space is the smooth curve
    (rows[:, j], cols[:, j]); cstar[m, j] is the fractional source COLUMN
    where that curve crosses source ROW m — i.e. the horizontal resampling
    position pass 1 must evaluate on each source scanline. Computed by
    monotone interpolation of cols over rows per destination column
    (projection curves are smooth; inversion error is far below 1e-3 px).
    Outside the curve's row span the end values are held (those scanlines
    only feed edge taps, which the validity channel renormalises away).
    """
    rows = np.asarray(rows, dtype=np.float64)
    cols = np.asarray(cols, dtype=np.float64)
    hd, wd = rows.shape
    m = np.arange(src_h, dtype=np.float64)
    cstar = np.empty((src_h, wd), dtype=np.float64)
    # np.interp silently returns garbage for unsorted xp — reject
    # non-monotone preimage curves loudly (direct callers like the
    # ortho pipeline have no other monotonicity gate)
    diffs = np.diff(rows, axis=0)
    if hd >= 2 and not (np.all(diffs >= -1e-9, axis=0)
                        | np.all(diffs <= 1e-9, axis=0)).all():
        raise ValueError(
            "scanline_cstar: dst->src row field is not monotone along "
            "destination columns; the two-pass scanline warp cannot "
            "represent this geometry — use the taploop warp kernel")
    for j in range(wd):
        rj, cj = rows[:, j], cols[:, j]
        if hd >= 2 and rj[0] > rj[-1]:
            rj, cj = rj[::-1], cj[::-1]
        cstar[:, j] = np.interp(m, rj, cj)
    return cstar.astype(np.float32)


# -- hyperres/kernels/warp.py:147 --------------------------------------------

def cubic_kernel_weight(x, a: float = -0.5, xp=np):
    """GDAL's cubic-convolution kernel (a = -0.5, Catmull-Rom-style)
    at signed pixel distance ``x``. THE single definition — the gather
    kernel, the separable weight matrices, and the two-pass banded
    profiles must stay numerically identical, so they all call this
    (``xp``: np for host-side weight matrices, torch for the scanline
    resample's plain version)."""
    ax = xp.abs(x)
    w1 = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    w2 = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return xp.where(ax <= 1.0, w1, xp.where(ax < 2.0, w2, 0.0))


# -- hyperres/kernels/warp.py:246 --------------------------------------------

def separable_weight_matrix(idx_1d: np.ndarray, src_size: int,
                            method: str = "bilinear",
                            scale: Optional[float] = None) -> np.ndarray:
    """(Dst, Src) float32 interpolation-weight matrix for one axis:
    row d holds the filter taps of fractional source index idx_1d[d]
    (2 taps bilinear, 4 taps cubic a=-0.5; 'average' holds box-overlap
    weights over ``scale`` source pixels — GDAL-average semantics for a
    downsample, demo cell 73). Out-of-range taps are dropped, so
    fully-outside rows are all-zero (detected downstream via the
    weight-sum channel)."""
    idx = np.asarray(idx_1d, dtype=np.float64)
    dst = idx.shape[0]
    W = np.zeros((dst, src_size), dtype=np.float32)
    i0 = np.floor(idx).astype(np.int64)
    t = idx - i0
    if method == "average":
        # dst pixel d spans [idx[d]-s/2, idx[d]+s/2) in source index
        # coords; weight of src pixel j (spanning [j-0.5, j+0.5)) is the
        # overlap length, normalised by the covered mass downstream.
        if scale is None:
            if dst < 2:
                raise ValueError("average needs scale for a 1-row axis")
            scale = float(np.median(np.diff(idx)))
        s = abs(float(scale))
        lo = idx - s / 2.0
        hi = idx + s / 2.0
        j0 = np.floor(lo + 0.5).astype(np.int64)
        rows_d = np.arange(dst)
        centre_in = (idx >= -0.5) & (idx <= src_size - 0.5)
        for k in range(int(np.ceil(s)) + 1):
            j = j0 + k
            w = np.clip(np.minimum(hi, j + 0.5) - np.maximum(lo, j - 0.5),
                        0.0, 1.0) / s
            ok = (j >= 0) & (j < src_size) & centre_in & (w > 0)
            W[rows_d[ok], j[ok]] = w[ok].astype(np.float32)
        return W
    if method == "bilinear":
        taps = [(0, 1.0 - t), (1, t)]
    elif method == "cubic":
        k = lambda x: cubic_kernel_weight(x, xp=np)
        taps = [(-1, k(t + 1.0)), (0, k(t)), (1, k(1.0 - t)),
                (2, k(2.0 - t))]
    else:
        raise ValueError(f"Unknown method {method!r}")
    rows_d = np.arange(dst)
    centre_in = (idx >= -0.5) & (idx <= src_size - 0.5)
    for off, w in taps:
        cols_s = i0 + off
        ok = (cols_s >= 0) & (cols_s < src_size) & centre_in
        W[rows_d[ok], cols_s[ok]] = w[ok].astype(np.float32)
    return W


# -- hyperres/kernels/warp.py:364 --------------------------------------------

def separable_fast_spec(idx_1d: np.ndarray, src_size: int,
                        method: str = "bilinear",
                        scale: Optional[float] = None,
                        tol: float = 2e-3):
    """Detect integer-aligned structure in a separable index field.

    Returns a hashable spec tuple or None (caller falls back to the
    weight-matrix path).

    - ``average`` with uniform integer step f and block-aligned spans:
      ``("avg", f, j0, dst, src, cin_lo, cin_hi)`` — dst cell d covers
      source pixels ``[j0 + f*d, j0 + f*(d+1))`` with equal weights.
    - ``bilinear`` with uniform step 1/f (integer f >= 1):
      ``("bilin", f, (r0 per phase...), (t per phase...), dst, src,
      cin_lo, cin_hi)`` — out[k*f + p] lerps source ``r0[p]+k`` and
      ``r0[p]+k+1`` with constant fraction ``t[p]``.

    ``cin_lo:cin_hi`` is the destination index range whose centres lie
    inside the source extent (outside -> fill, matching the all-zero
    rows the matrix builder emits).
    """
    idx = np.asarray(idx_1d, dtype=np.float64)
    dst = idx.shape[0]
    if dst == 0:
        return None
    cin = (idx >= -0.5) & (idx <= src_size - 0.5)
    if cin.any():
        cin_lo = int(np.argmax(cin))
        cin_hi = int(dst - np.argmax(cin[::-1]))
        if not cin[cin_lo:cin_hi].all():  # non-contiguous: bail
            return None
    else:
        cin_lo = cin_hi = 0
    if method == "average":
        if dst >= 2:
            d = np.diff(idx)
            f = d[0]
            if not np.allclose(d, f, rtol=0, atol=tol):
                return None
        else:
            f = float(scale) if scale is not None else None
            if f is None:
                return None
        fi = int(round(f))
        if fi < 1 or abs(f - fi) > tol:
            return None
        if scale is not None and abs(abs(float(scale)) - fi) > tol:
            return None
        # block alignment: lo + 0.5 = idx - f/2 + 0.5 must be integer
        j0f = idx[0] - fi / 2.0 + 0.5
        j0 = int(round(j0f))
        if abs(j0f - j0) > tol:
            return None
        return ("avg", fi, j0, dst, int(src_size), cin_lo, cin_hi)
    if method == "bilinear":
        if dst >= 2:
            d = np.diff(idx)
            s = d[0]
            if s <= 0 or not np.allclose(d, s, rtol=0, atol=tol):
                return None
            f = int(round(1.0 / s))
            if f < 1 or abs(s - 1.0 / f) > tol / max(dst, 1):
                return None
        else:
            f = 1
        r0s, ts = [], []
        for p in range(min(f, dst)):
            ph = idx[p::f]
            r0 = np.floor(ph).astype(np.int64)
            t = ph - r0
            if not (np.all(np.diff(r0) == 1)
                    and np.allclose(t, t[0], rtol=0, atol=tol)):
                return None
            r0s.append(int(r0[0]))
            ts.append(float(np.median(t)))
        if len(r0s) < f:  # dst shorter than one period
            base = r0s[0] if r0s else 0
            while len(r0s) < f:
                r0s.append(base)
                ts.append(0.0)
        return ("bilin", f, tuple(r0s), tuple(ts), dst, int(src_size),
                cin_lo, cin_hi)
    return None


# -- hyperres/kernels/warp.py:625 --------------------------------------------

def integer_factor(src_grid: Grid, dst_grid: Grid) -> Optional[int]:
    """The integer ratio f >= 1 of a same-CRS ``dst_grid`` to
    ``src_grid`` when both axes share it and the dst origin lies on a
    src pixel boundary, else None (the reference's ``_integer_factor``)."""
    if src_grid.crs != dst_grid.crs:
        return None
    fx = dst_grid.dx / src_grid.dx
    fy = dst_grid.dy / src_grid.dy
    if abs(fx - round(fx)) > 1e-9 or abs(fy - round(fy)) > 1e-9:
        return None
    if round(fx) != round(fy) or round(fx) < 1:
        return None
    f = int(round(fx))
    # grids must be aligned: dst origin on src pixel boundary
    ox = (dst_grid.x0 - src_grid.x0) / src_grid.dx
    oy = (src_grid.y0 - dst_grid.y0) / src_grid.dy
    if abs(ox - round(ox)) > 1e-6 or abs(oy - round(oy)) > 1e-6:
        return None
    return f


# -- hyperres/kernels/srf.py:27 ----------------------------------------------

def trapezoid_weights(x: np.ndarray) -> np.ndarray:
    """w such that trapz(y, x) == w @ y."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.0
    w[1:] += dx / 2.0
    return w


# -- hyperres/kernels/srf.py:37 ----------------------------------------------

def build_srf_weight_matrix(
    emit_wl: np.ndarray,
    srf: SRFDict,
    good_mask: Optional[np.ndarray] = None,
    bands: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """(B, S) float32 weight matrix W with ``synth = R @ W``, matching the
    reference integral exactly (synth.py:32-43): SRF interpolated onto the
    EMIT wavelengths (0 outside support), optional good-band mask, and
    normalisation by trapz of the interpolated response. Returns
    (W, band_names, band_valid) where band_valid[s] is False when the SRF
    misses the EMIT range (the reference returns None there)."""
    emit_wl = np.asarray(emit_wl, dtype=np.float64)
    tw = trapezoid_weights(emit_wl)
    names = list(bands) if bands is not None else list(srf.keys())
    cols = []
    valid = []
    for b in names:
        lam, rsp = srf[b]
        rsp_on = np.interp(emit_wl, lam, rsp, left=0.0, right=0.0)
        if good_mask is not None:
            rsp_on = rsp_on * np.asarray(good_mask, dtype=np.float64)
        if np.all(rsp_on == 0.0):
            cols.append(np.zeros_like(emit_wl))
            valid.append(False)
            continue
        den = float(tw @ rsp_on)
        cols.append(tw * rsp_on / (den + 1e-32))
        valid.append(True)
    W = np.stack(cols, axis=1).astype(np.float32)
    return W, names, np.asarray(valid, dtype=bool)


# -- hyperres/kernels/srf.py:70 ----------------------------------------------

def build_box_weight_matrix(
    emit_wl: np.ndarray,
    box_table: Optional[Dict[str, Tuple[float, float]]] = None,
    good_mask: Optional[np.ndarray] = None,
    bands: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Weight matrix for the rectangular band-pass variant
    (demo notebook cell 58): trapz over EMIT samples inside
    [centre - bw/2, centre + bw/2], normalised by (w[-1] - w[0]). Bands
    with < 2 samples in range are invalid (reference returns None)."""
    if box_table is None:
        from ..spectral.srf_tables import S2_BOX_TABLE
        box_table = S2_BOX_TABLE
    emit_wl = np.asarray(emit_wl, dtype=np.float64)
    names = list(bands) if bands is not None else list(box_table.keys())
    gm = (np.asarray(good_mask, dtype=bool) if good_mask is not None
          else np.ones_like(emit_wl, dtype=bool))
    cols = []
    valid = []
    for b in names:
        centre, bw = box_table[b]
        m = (emit_wl >= centre - bw / 2.0) & (emit_wl <= centre + bw / 2.0) & gm
        idx = np.where(m)[0]
        col = np.zeros_like(emit_wl)
        if len(idx) < 2:
            cols.append(col)
            valid.append(False)
            continue
        sub_w = trapezoid_weights(emit_wl[idx])
        den = emit_wl[idx][-1] - emit_wl[idx][0]
        col[idx] = sub_w / den
        cols.append(col)
        valid.append(True)
    W = np.stack(cols, axis=1).astype(np.float32)
    return W, names, np.asarray(valid, dtype=bool)


# -- hyperres/kernels/lstsq.py:112 -------------------------------------------

def poly_feature_exponents(n_features: int, degree: int,
                           include_bias: bool = False) -> np.ndarray:
    """(F, n_features) exponent matrix enumerating all monomials with
    1 <= total degree <= degree (plus the constant when include_bias),
    in sklearn's ordering (degree-major, combinations with replacement)."""
    rows: List[np.ndarray] = []
    if include_bias:
        rows.append(np.zeros(n_features, dtype=np.int32))
    for d in range(1, degree + 1):
        for combo in combinations_with_replacement(range(n_features), d):
            e = np.zeros(n_features, dtype=np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    return np.stack(rows, axis=0)


# -- hyperres/kernels/lstsq.py:129 -------------------------------------------

def poly_factor_indices(n_features: int, degree: int,
                        include_bias: bool = False) -> np.ndarray:
    """(F, degree) int32: factor each monomial into exactly ``degree``
    indices into [1, x_0, ..., x_{n-1}] (index 0 is the constant-one
    column) — monomial m = prod_d X_ext[:, factor_idx[m, d]]."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    exps = poly_feature_exponents(n_features, degree, include_bias)
    factor_idx = np.zeros((exps.shape[0], degree), dtype=np.int32)
    for row, e in enumerate(exps):
        fs = []
        for i, p in enumerate(e):
            fs.extend([i + 1] * int(p))
        fs.extend([0] * (degree - len(fs)))
        factor_idx[row] = fs
    return factor_idx

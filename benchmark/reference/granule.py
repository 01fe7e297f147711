"""Plain reference of the fused granule product (raw EMIT cube + 10 m S2
RGB -> UTM 60 m cube and fused 10 m RGB), in float32 PyTorch and NumPy.

It follows the product's definition, stage by stage, from the inputs
the benchmark makes (raw cube, S2 DN, GLT, grids, wavelengths, the S2A
response) and one seed for the OT draw, and derives again everything
the program derives from them: the GLT indices, the destination index
fields and the scanline columns, the SRF weights, the grid transfers,
the stretch, the sample, the transport plan and the fit.

1. GLT gather of the raw cube onto the geographic ortho grid, with a
   validity channel; two-pass cubic (a = -0.5) scanline warp onto the
   S2-anchored UTM grid, pass 1 along each ortho row at the columns where
   each destination column's preimage crosses it, pass 2 along the
   columns, each pass a product of dense per-line weight matrices with
   the lines; the validity renormalises, -9999 where it vanishes or the
   destination centre leaves the ortho grid.
2. SRF synthesis of B2 / B3 / B4 (trapezoid integral over good bands).
3. The S2 RGB (DN x 1e-4) box-averaged 6 x 6 onto the UTM grid.
4. Valid 60 m pixels: synthesis finite and > 0 in B2, EMIT not nodata,
   S2 finite; the shared 2-98 % stretch of each channel (B4, B3, B2).
5. 5000 pixels of each side drawn by Gumbel top-k from a generator
   seeded with the request's seed, the EMIT draw first.
6. Entropic OT (log-domain Sinkhorn, reg 0.05, column-marginal stop test
   every 10 sweeps at 1e-6, at most 300), barycentric targets, a
   weighted degree-4 polynomial per channel by QR. The stop test is the
   program's: tested right after the g-update, the column marginal is b
   to rounding, so it is met at the first test and the transport is
   that of 10 sweeps. A program that tests another marginal, or runs on
   to convergence, needs this step changed with it.
7. The fit applied at 60 m (``matched_60m``) and, after a bilinear
   60 m -> 10 m transfer renormalised by the valid mask, at 10 m
   (``fused_10m``, NaN where no valid 60 m pixel contributes).

Nothing here imports the program. Matrix products follow
``torch.backends.cuda.matmul.allow_tf32``; :func:`precision` sets it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from ..harness.geometry import GridSpec, transform
from ..harness.spectra import s2a_srf, srf_weight_matrix

EMIT_NODATA = -9999.0


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (``True``) or full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- geometry

def warp_fields(glt: np.ndarray, raw_hw, ortho: GridSpec, utm: GridSpec
                ) -> Dict[str, np.ndarray]:
    """Host fields of the warp: ``flat`` (oh, ow) raw pixel index and
    ``valid``; ``rows`` / ``cols`` (Hd, Wd) float32, the fractional ortho
    index of each UTM pixel centre; ``cstar`` (oh, Wd) float32, the ortho
    column at which destination column j's preimage crosses ortho row m
    (linear interpolation of cols over rows, ends held)."""
    raw_h, raw_w = raw_hw
    gx = glt[..., 0].astype(np.int64) - 1
    gy = glt[..., 1].astype(np.int64) - 1
    valid = ((glt != 0).all(axis=-1) & (gy >= 0) & (gy < raw_h)
             & (gx >= 0) & (gx < raw_w))
    flat = np.where(valid, gy * raw_w + gx, 0)
    xs, ys = utm.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    sx, sy = transform(utm.crs, ortho.crs, X, Y)
    c, r = ortho.colrow_of(sx, sy)
    rows = r.astype(np.float32).astype(np.float64)
    cols = c.astype(np.float32).astype(np.float64)
    m = np.arange(ortho.height, dtype=np.float64)
    cstar = np.empty((ortho.height, utm.width))
    for j in range(utm.width):
        rj, cj = rows[:, j], cols[:, j]
        if rj[0] > rj[-1]:
            rj, cj = rj[::-1], cj[::-1]
        cstar[:, j] = np.interp(m, rj, cj)
    return {"flat": flat, "valid": valid, "rows": rows.astype(np.float32),
            "cols": cols.astype(np.float32),
            "cstar": cstar.astype(np.float32)}


def cubic(x: torch.Tensor) -> torch.Tensor:
    """Cubic convolution kernel, a = -0.5."""
    a = -0.5
    ax = x.abs()
    w1 = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    w2 = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, 0.0))


def _resample(src: torch.Tensor, pos: torch.Tensor, axis: int,
              block: int = 32) -> torch.Tensor:
    """out = sum_s k(pos - s) src along ``axis`` as a matrix product per
    scanline: for each line n the weights W_n[q, s] = k(pos[n, q] - s)
    over the whole source axis (k vanishes past two pixels), times the
    line's (S, C) source. Axis 1: src (P, S, C), pos (P, Q) -> (P, Q, C);
    axis 0: src (S, Q, C), pos (P, Q) -> (P, Q, C), on a transposed copy.
    ``block`` lines at a time."""
    if axis == 0:
        return _resample(src.transpose(0, 1).contiguous(), pos.T.contiguous(),
                         1, block).transpose(0, 1).contiguous()
    n, s, c = src.shape
    iota = torch.arange(s, dtype=torch.float32, device=src.device)
    out = torch.empty((n, pos.shape[1], c), dtype=torch.float32,
                      device=src.device)
    for i in range(0, n, block):
        W = cubic(pos[i:i + block, :, None] - iota)
        out[i:i + block] = torch.bmm(W, src[i:i + block])
    return out


def warp_to_utm(raw: torch.Tensor, fields: Dict[str, np.ndarray]):
    """Step 1: the (Hd, Wd, B) UTM cube and the (Hd, Wd) warped
    validity mass it was renormalised by."""
    dev = raw.device
    b = raw.shape[-1]
    flat = torch.as_tensor(fields["flat"], device=dev)
    valid = torch.as_tensor(fields["valid"], device=dev)
    rows = torch.as_tensor(fields["rows"], device=dev)
    cols = torch.as_tensor(fields["cols"], device=dev)
    cstar = torch.as_tensor(fields["cstar"], device=dev)
    v = raw.reshape(-1, b)[flat.reshape(-1)].reshape(*flat.shape, b)
    vf = valid.to(torch.float32)[..., None]
    src = torch.cat([v * vf, vf], dim=-1)
    del v
    h = _resample(src, cstar, axis=1)
    del src
    ext = _resample(h, rows, axis=0)
    del h
    ho, wo = flat.shape
    inside = ((rows >= -0.5) & (rows <= ho - 0.5)
              & (cols >= -0.5) & (cols <= wo - 0.5))[..., None]
    den = ext[..., b:]
    good = den.abs() > 1e-6
    out = ext[..., :b] / torch.where(good, den, 1.0)
    return (out.masked_fill_(~(good & inside), EMIT_NODATA),
            den[..., 0].clone())


# ------------------------------------------------------------------ fusion

def _f32(x: float) -> float:
    return float(np.float32(x))


def _box_axis(a: torch.Tensor, axis: int, off: int, f: int, n: int):
    """Sums of ``f`` source pixels from ``off + f d`` along ``axis``
    (zero outside), times f32(1 / f), d < n."""
    size = a.shape[axis]
    lo, hi = max(0, -off), max(0, off + f * n - size)
    if lo or hi:
        pads = [0, 0, 0, 0, 0, 0]
        pads[2 * (2 - axis)], pads[2 * (2 - axis) + 1] = lo, hi
        a = torch.nn.functional.pad(a, pads)
    a = a.narrow(axis, off + lo, f * n)
    shape = list(a.shape)
    shape[axis:axis + 1] = [n, f]
    return a.reshape(shape).sum(dim=axis + 1) * _f32(1.0 / f)


def _centre_in(idx: np.ndarray, size: int) -> np.ndarray:
    return (idx >= -0.5) & (idx <= size - 0.5)


def box_to_60m(s2: torch.Tensor, s2_grid: GridSpec, utm: GridSpec,
               nodata: float) -> torch.Tensor:
    """Step 3: (H10, W10, 3) -> (Hd, Wd, 3) block means of the pixels
    that are finite and not ``nodata``; NaN where none is or the
    destination centre leaves the S2 grid."""
    f = int(round(utm.dx / s2_grid.dx))
    r0 = int(round((s2_grid.y0 - utm.y0) / s2_grid.dy))
    c0 = int(round((utm.x0 - s2_grid.x0) / s2_grid.dx))
    ok = (s2 != nodata) & torch.isfinite(s2)

    def passes(a):
        return _box_axis(_box_axis(a, 0, r0, f, utm.height), 1, c0, f,
                         utm.width)

    num = passes(torch.where(ok, s2, 0.0))
    den = passes(ok.to(torch.float32))
    xs, ys = utm.pixel_center_coords()
    ci, _ = s2_grid.colrow_of(xs, s2_grid.y0)
    _, ri = s2_grid.colrow_of(s2_grid.x0, ys)
    keep = torch.as_tensor(_centre_in(ri, s2_grid.height)[:, None, None]
                           & _centre_in(ci, s2_grid.width)[None, :, None],
                           device=s2.device)
    good = den.abs() > 1e-6
    out = num / torch.where(good, den, 1.0)
    return out.masked_fill_(~(good & keep), float("nan"))


def _lerp_axis(a: torch.Tensor, axis: int, idx: np.ndarray) -> torch.Tensor:
    """Linear interpolation along ``axis`` at fractional indices ``idx``
    (zero outside the source)."""
    size = a.shape[axis]
    i0 = np.floor(idx).astype(np.int64)
    t = (idx - i0).astype(np.float32)
    lo = max(0, -int(i0.min()))
    hi = max(0, int(i0.max()) + 2 - size)
    if lo or hi:
        pads = [0, 0, 0, 0, 0, 0]
        pads[2 * (2 - axis)], pads[2 * (2 - axis) + 1] = lo, hi
        a = torch.nn.functional.pad(a, pads)
    dev = a.device
    i0t = torch.as_tensor(i0 + lo, device=dev)
    tt = torch.as_tensor(t, device=dev)
    one_t = torch.as_tensor(np.float32(1.0) - t, device=dev)
    shape = [1, 1, 1]
    shape[axis] = -1
    return (a.index_select(axis, i0t) * one_t.reshape(shape)
            + a.index_select(axis, i0t + 1) * tt.reshape(shape))


def upsample_to_10m(x60: torch.Tensor, valid60: torch.Tensor,
                    utm: GridSpec, s2_grid: GridSpec) -> torch.Tensor:
    """Step 7's transfer: bilinear 60 m -> 10 m of the valid pixels,
    renormalised by the valid mass; NaN where it vanishes or the
    destination centre leaves the UTM grid."""
    xs, ys = s2_grid.pixel_center_coords()
    ci, _ = utm.colrow_of(xs, utm.y0)
    _, ri = utm.colrow_of(utm.x0, ys)

    def passes(a):
        return _lerp_axis(_lerp_axis(a, 0, ri), 1, ci)

    ok = valid60[..., None]
    num = passes(torch.where(ok, x60, 0.0))
    den = passes(valid60.to(torch.float32)[..., None])
    keep = torch.as_tensor(_centre_in(ri, utm.height)[:, None, None]
                           & _centre_in(ci, utm.width)[None, :, None],
                           device=x60.device)
    good = den.abs() > 1e-6
    out = num / torch.where(good, den, 1.0)
    return out.masked_fill_(~(good & keep), float("nan"))


def percentiles(x: torch.Tensor, mask: torch.Tensor, qs=(2.0, 98.0)):
    """Per-channel percentiles of x (H, W, C) over ``mask``, NaN left
    out, np.percentile's linear rule in float32 ranks and a float64
    combine of the two order statistics -> (C, Q) float32."""
    c = x.shape[-1]
    flat = x.reshape(-1, c)
    m = mask.reshape(-1)
    q32 = np.asarray(qs, dtype=np.float32)
    out = np.full((c, q32.size), np.nan, np.float32)
    for ch in range(c):
        v = torch.sort(flat[:, ch][m & ~torch.isnan(flat[:, ch])]).values
        n = v.numel()
        if n == 0:
            continue
        pos = q32 * np.float32(0.01) * np.float32(n - 1)
        j = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
        jp = np.clip(np.ceil(pos).astype(np.int64), 0, n - 1)
        w = pos - np.floor(pos)
        lo = v[torch.as_tensor(j, device=v.device)].cpu().numpy()
        hi = v[torch.as_tensor(jp, device=v.device)].cpu().numpy()
        out[ch] = (lo.astype(np.float64) * (np.float32(1.0) - w)
                   + (hi * w).astype(np.float64)).astype(np.float32)
    return out


def stretch(x: torch.Tensor, mask: torch.Tensor, pmin: float, pmax: float):
    lohi = torch.as_tensor(percentiles(x, mask, (pmin, pmax)),
                           device=x.device)
    lo, hi = lohi[:, 0], lohi[:, 1]
    return torch.clamp((x - lo) / (hi - lo + 1e-12), 0.0, 1.0)


def draw(img: torch.Tensor, mask: torch.Tensor, n: int,
         generator: torch.Generator):
    """Step 5: ``n`` pixels of img (H, W, C) by Gumbel top-k among the
    valid ones, and their 0/1 weights (0 past the valid count)."""
    c = img.shape[-1]
    flat = img.reshape(-1, c)
    n = min(int(n), flat.shape[0])
    valid = mask.reshape(-1) & torch.isfinite(flat).all(dim=-1)
    u = torch.rand(flat.shape[0], generator=generator, device=img.device,
                   dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    score = torch.where(valid, -torch.log(-torch.log(u)),
                        torch.tensor(float("-inf"), device=img.device))
    idx = torch.topk(score, n).indices
    w = valid[idx].to(torch.float32)
    w = w * (torch.arange(n, device=img.device) < valid.sum())
    return flat[idx], w


def sinkhorn_targets(X, Y, wx, wy, reg: float, itermax: int, stop: float,
                     check_every: int = 10):
    """Step 6's transport: barycentric targets of the X rows."""
    X = torch.where(wx[:, None] > 0, X, 0.0)
    Y = torch.where(wy[:, None] > 0, Y, 0.0)
    a = torch.clamp(wx, min=1e-12)
    a = a / a.sum()
    b = torch.clamp(wy, min=1e-12)
    b = b / b.sum()
    M = torch.clamp((X * X).sum(1, keepdim=True) + (Y * Y).sum(1)[None, :]
                    - 2.0 * (X @ Y.T), min=0.0)
    Mr = -M / reg
    la, lb = torch.log(a), torch.log(b)
    f = torch.zeros_like(la)
    g = torch.zeros_like(lb)
    err = float("inf")
    it = 0
    while it < itermax and err > stop:
        for _ in range(check_every):
            f = f + la - torch.logsumexp(Mr + f[:, None] + g[None, :], dim=1)
            g = g + lb - torch.logsumexp(Mr + f[:, None] + g[None, :], dim=0)
        col = torch.exp(torch.logsumexp(Mr + f[:, None] + g[None, :], dim=0))
        err = float(torch.sum(torch.abs(col - b)))
        it += check_every
    P = torch.exp(Mr + f[:, None] + g[None, :])
    return (P @ Y) / (P.sum(dim=1, keepdim=True) + 1e-32)


def _power(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def polyfit(x, y, w, deg: int) -> torch.Tensor:
    V = torch.stack([_power(x, deg - k) for k in range(deg + 1)], dim=1)
    sw = torch.sqrt(w)
    Q, R = torch.linalg.qr(V * sw[:, None])
    return torch.linalg.solve_triangular(R, (Q.T @ (y * sw))[:, None],
                                         upper=True)[:, 0]


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """coeffs (C, deg + 1), highest power first; x (..., C)."""
    chans = []
    for ch in range(x.shape[-1]):
        out = torch.zeros_like(x[..., ch]) + coeffs[ch, 0]
        for c in coeffs[ch, 1:]:
            out = out * x[..., ch] + c
        chans.append(out)
    return torch.stack(chans, dim=-1)


def fuse(utm_cube: torch.Tensor, s2_dn: torch.Tensor, scene: dict,
         fusion: dict, seed: int) -> Dict[str, torch.Tensor]:
    """Steps 2-7 from the UTM cube, the (3, H10, W10) DN stack and the
    request's OT seed: ``matched_60m``, ``coeffs`` (C, deg + 1) and
    ``fused_10m``."""
    dev = utm_cube.device
    utm, s2g = scene["utm60"], scene["s2_grid"]
    b = utm_cube.shape[-1]
    W = torch.as_tensor(srf_weight_matrix(scene["wavelengths"], s2a_srf(),
                                          scene["good_mask"]), device=dev)
    synth = (utm_cube.reshape(-1, b) @ W).reshape(*utm_cube.shape[:2], 3)
    scale = _f32(fusion["s2_scale"])
    s2 = torch.stack([s2_dn[i].to(torch.float32) for i in range(3)], dim=-1)
    s2 = s2 * scale
    s2_60 = box_to_60m(s2, s2g, utm, nodata=fusion["s2_nodata"]
                       * fusion["s2_scale"])
    del s2
    valid60 = (torch.isfinite(synth).all(dim=-1) & (synth[..., 0] > 0)
               & (utm_cube[..., 0] != EMIT_NODATA)
               & torch.isfinite(s2_60).all(dim=-1))
    pmin, pmax = fusion["stretch_percentiles"]
    emit_n = stretch(synth.flip(-1), valid60, pmin, pmax)
    s2_n = stretch(s2_60.flip(-1), valid60, pmin, pmax)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    ot = fusion["ot"]
    Xs, wx = draw(emit_n, valid60, ot["n_samples"], gen)
    Ys, wy = draw(s2_n, valid60, ot["n_samples"], gen)
    Xs = torch.where(wx[:, None] > 0, Xs, 0.0)
    Ys = torch.where(wy[:, None] > 0, Ys, 0.0)
    T = sinkhorn_targets(Xs, Ys, wx, wy, ot["reg"], ot["num_itermax"],
                         ot["stop_thr"])
    deg = fusion["degree"]
    fit = torch.stack([polyfit(Xs[:, ch], T[:, ch], wx, deg)
                       for ch in range(3)])
    ident = torch.zeros_like(fit)
    ident[:, -2] = 1.0
    coeffs = torch.where(valid60.sum() >= fusion["min_pixels"], fit, ident)
    matched = torch.clamp(torch.where(valid60[..., None],
                                      polyval(coeffs, emit_n), emit_n),
                          0.0, 1.0)
    sim10 = upsample_to_10m(emit_n, valid60, utm, s2g)
    mask10 = torch.isfinite(sim10).all(dim=-1)
    mapped = torch.clamp(polyval(coeffs, torch.nan_to_num(sim10)), 0.0, 1.0)
    fused = torch.where(mask10[..., None], mapped, float("nan"))
    return {"matched_60m": matched, "coeffs": coeffs, "fused_10m": fused,
            "synth_b2": synth[..., 0]}


def granule_product(raw: torch.Tensor, s2_dn: torch.Tensor, scene: dict,
                    fusion: dict, seed: int,
                    fields: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The whole product of one request: ``utm_cube`` and :func:`fuse`'s
    three outputs. ``fields``: :func:`warp_fields` of the scene, where
    the caller already has them."""
    if fields is None:
        fields = warp_fields(scene["glt"], raw.shape[:2], scene["ortho_grid"],
                             scene["utm60"])
    utm_cube, mass = warp_to_utm(raw, fields)
    out = fuse(utm_cube, s2_dn, scene, fusion, seed)
    out["utm_cube"] = utm_cube
    out["utm_mass"] = mass
    return out


def conditioning(mass: torch.Tensor, synth_b2: torch.Tensor, utm: GridSpec,
                 s2_grid: GridSpec, margin: float = 1e-5):
    """How far rounding is amplified where the warp renormalises by a
    small validity mass m: a product value's rounding error grows as
    1 / |m|, so the comparison weighs a gap by min(1, |m|). A 60 m pixel
    whose B2 synthesis lies within ``margin`` / min(1, |m|) of 0 may be
    valid on one side and not on the other (the validity test is
    synthesis > 0), so it weighs 0. Returns the weight at 60 m (Hd, Wd)
    and at 10 m (H10, W10), the least of the (at most four) 60 m pixels
    the bilinear transfer reads."""
    w60 = torch.clamp(mass.abs(), max=1.0)
    w60 = torch.where(synth_b2.abs() * w60 < margin, 0.0, w60)
    xs, ys = s2_grid.pixel_center_coords()
    ci, _ = utm.colrow_of(xs, utm.y0)
    _, ri = utm.colrow_of(utm.x0, ys)
    dev = mass.device

    def taps(idx, size):
        i0 = np.floor(idx).astype(np.int64)
        return [torch.as_tensor(np.clip(i0 + k, 0, size - 1), device=dev)
                for k in (0, 1)]

    rows = [w60.index_select(0, r) for r in taps(ri, utm.height)]
    w10 = None
    for r in rows:
        for c in taps(ci, utm.width):
            x = r.index_select(1, c)
            w10 = x if w10 is None else torch.minimum(w10, x)
    return w60, w10

"""Grid-to-grid resampling on the device (``hyperres/kernels/warp.py``).

- :func:`orthowarp_two_pass`: fused GLT gather + two-pass scanline warp
  onto the S2-anchored UTM grid (``warp.py:837-931``), both passes in
  the hand-written scanline kernel (:mod:`.banded`), by the banded route
  or, with ``backend="pallas"``, the dense route.
- :func:`warp_two_pass`: the same two kernel passes for any grid pair
  (no GLT), with one validity channel per band when a nodata value is
  given (``warp.py:1007``).
- :func:`orthowarp_taploop`: the exact fused GLT + warp, each filter tap
  gathered through the GLT from the raw cube (``warp.py:708``);
  :func:`warp_nearest`, :func:`warp_interpolate` (and its
  ``_taploop`` / ``_chunked`` forms) and :func:`block_average`: the
  gather kernels (``warp.py:126-239``).
- :func:`resample_to_grid`: the high-level grid transfer with the
  reference's routes in the reference's order (``warp.py:1094``); on a
  CUDA device its same-CRS bilinear / cubic transfers are one kernel
  (:mod:`.sep_resample`).
- :func:`separable_resample_fast`: the integer-aligned same-CRS grid
  transfers (10 m -> 60 m box average, 60 m -> 10 m bilinear) as
  reshape block sums and phase-cycled lerps (``warp.py:449-618``), in
  the channel-minor (H, W, C) layout.
- :func:`separable_resample_matmul`: the dense weight-matrix transfer
  for grids without an integer-aligned spec (``warp.py:302``); the
  same-CRS bilinear / cubic route's plain version, which the CPU takes.

The float64 projection math and the index fields stay on the host
(:mod:`.host`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import NO_DATA_VALUE
from ..core.grid import Grid
from ..device import resolve_device
from ..utils.profiling import count

from . import sep_resample as _sep
from .banded import (
    check_precision, scanline_resample, scanline_resample_dense,
)
from .glt import glt_take
from .host import (
    cubic_kernel_weight, integer_factor, scanline_cstar,
    separable_index_axes, separable_taps, separable_weight_matrix,
    source_index_field,
)


def _renormalise(num: torch.Tensor, den: torch.Tensor, keep: torch.Tensor,
                 fill: float, inplace: bool = False) -> torch.Tensor:
    """``num / den`` where ``|den| > 1e-6`` and ``keep``, else ``fill``
    (the package-wide nodata renormalisation); ``inplace`` writes the
    result into ``num`` (no second tensor of its size)."""
    good = den.abs() > 1e-6
    safe = torch.where(good, den, torch.ones((), device=den.device))
    out = num.div_(safe) if inplace else num / safe
    return out.masked_fill_(~(good & keep), fill)


def orthowarp_src_ext(raw: torch.Tensor, glt_flat_idx: torch.Tensor,
                      glt_valid: torch.Tensor) -> torch.Tensor:
    """The warp's source: the GLT-gathered cube times its validity, with
    the validity as one extra channel, ``[v * valid, valid]``
    (``warp.py:880-884``). (Ho, Wo, B + 1) float32."""
    v = glt_take(raw, glt_flat_idx)
    valid = glt_valid.to(torch.float32)[..., None]
    return torch.cat([v * valid, valid], dim=-1)


def _centre_in(rows: torch.Tensor, cols: torch.Tensor, h: int, w: int
               ) -> torch.Tensor:
    """Destination centres that lie inside an (h, w) source, (..., 1)."""
    return ((rows >= -0.5) & (rows <= h - 0.5)
            & (cols >= -0.5) & (cols <= w - 0.5))[..., None]


#: ``orthowarp_two_pass`` backends, by the reference's names
WARP_BACKENDS = ("auto", "xla", "pallas", "pallas_banded")


def orthowarp_two_pass(raw: torch.Tensor, glt_flat_idx: torch.Tensor,
                       glt_valid: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, cstar: torch.Tensor,
                       method: str = "cubic",
                       fill: float = NO_DATA_VALUE,
                       precision: str = "high",
                       backend: str = "auto") -> torch.Tensor:
    """Two-pass (Catmull-Smith scanline) fused GLT + warp.

    raw (h, w, B) f32; glt_flat_idx/glt_valid (Ho, Wo) from
    ``prepare_glt``; rows/cols (Hd, Wd) fractional ortho-grid indices of
    the destination pixels; cstar (Ho, Wd) from ``scanline_cstar``.
    Pass 1 resamples every source scanline at ``cstar``, pass 2 resamples
    the columns of pass 1's output at ``rows``; the validity channel is
    carried through both so one division renormalises nodata, and a
    destination whose centre leaves the source is ``fill``. Returns
    (Hd, Wd, B).

    ``backend``: ``"auto"``, ``"xla"`` and ``"pallas_banded"`` take the
    banded route; ``"pallas"`` the dense route of
    ``pallas_scanline_resample`` for both passes (``warp.py:895-904``),
    whose pass 2 reads pass 1's natural layout where the reference
    transposes. Both routes make the same kernel launches, each counted
    under its route's name. ``precision`` ``"high"`` and ``"highest"``
    both compute exact f32, equal to the reference's ``"highest"`` result
    to f32 rounding; ``"default"`` is not ported."""
    if backend not in WARP_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of "
                         f"{WARP_BACKENDS})")
    check_precision(precision)
    b = raw.shape[-1]
    ho, wo = glt_flat_idx.shape
    src_ext = orthowarp_src_ext(raw, glt_flat_idx, glt_valid)
    if backend == "pallas":
        h = scanline_resample_dense(src_ext, cstar, method, precision)
        del src_ext
        out_ext = scanline_resample_dense(h, rows, method, precision, axis=0)
    else:
        h = scanline_resample(src_ext, cstar, axis=1, method=method)
        del src_ext
        out_ext = scanline_resample(h, rows, axis=0, method=method)
    del h
    return _renormalise(out_ext[..., :b], out_ext[..., b:],
                        _centre_in(rows, cols, ho, wo), fill)


def two_pass_src_ext(img: torch.Tensor, nodata: Optional[float] = None,
                     has_nodata: Optional[bool] = None) -> torch.Tensor:
    """The source :func:`warp_two_pass` gives both scanline passes: with
    a nodata value (or ``has_nodata``) the bands zeroed where they are
    nodata or not finite, then one validity channel per band (H, W, 2 B);
    without one, the bands and a single channel of ones (H, W, B + 1)."""
    h, w, _ = img.shape
    img = img.to(torch.float32)
    if has_nodata is None:
        has_nodata = nodata is not None
    if not has_nodata:
        return torch.cat(
            [img, torch.ones((h, w, 1), dtype=torch.float32,
                             device=img.device)], dim=-1)
    ok = torch.isfinite(img)
    if nodata is not None:
        ok &= img != nodata
    return torch.cat(
        [torch.where(ok, img, torch.zeros((), device=img.device)),
         ok.to(torch.float32)], dim=-1)


def warp_two_pass(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  cstar: torch.Tensor, nodata: Optional[float] = None,
                  method: str = "cubic", fill: float = NO_DATA_VALUE,
                  has_nodata: Optional[bool] = None,
                  precision: str = "high") -> torch.Tensor:
    """Generic two-pass scanline warp (no GLT, ``warp.py:1007``): the
    counterpart of :func:`warp_interpolate` for large reprojections, on
    the scanline kernel (pass 1 along axis 1 at ``cstar``, pass 2 along
    axis 0 at ``rows``). With a nodata value the source carries one
    validity channel per band (2 B channels through both passes) and
    each band is renormalised by its own warped validity; without one, a
    single channel of ones. ``rows`` must be monotone along axis 0 per
    destination column (:func:`resample_to_grid` checks before it routes
    here). img (H, W, B) -> (Hd, Wd, B)."""
    check_precision(precision)
    h, w, b = img.shape
    src_ext = two_pass_src_ext(img, nodata, has_nodata)
    mid = scanline_resample(src_ext, cstar, axis=1, method=method)
    del src_ext
    out_ext = scanline_resample(mid, rows, axis=0, method=method)
    del mid
    return _renormalise(out_ext[..., :b], out_ext[..., b:],
                        _centre_in(rows, cols, h, w), fill)


# ---------------------------------------------------------------------------
# Gather kernels (plain PyTorch: the reference computes them outside any
# Pallas kernel)
# ---------------------------------------------------------------------------

def _gather2d(img: torch.Tensor, ri: torch.Tensor, ci: torch.Tensor
              ) -> torch.Tensor:
    """img (H, W, B); ri/ci integer tensors (...,) -> (..., B). Indices
    must be clipped already (``warp.py:116``)."""
    w, b = img.shape[1], img.shape[2]
    idx = ri * w + ci
    return torch.index_select(img.reshape(-1, b), 0,
                              idx.reshape(-1)).reshape(*idx.shape, b)


def warp_nearest(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 nodata: Optional[float] = None,
                 fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """Nearest-neighbour warp (``warp.py:126``): round half to even,
    gather; ``fill`` outside the source and, with ``nodata``, where the
    source is nodata or not finite."""
    h, w, _ = img.shape
    ri = torch.round(rows).to(torch.int64)
    ci = torch.round(cols).to(torch.int64)
    inside = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
    out = _gather2d(img, ri.clamp(0, h - 1), ci.clamp(0, w - 1))
    bad = ~inside[..., None]
    if nodata is not None:
        bad = bad | (out == nodata) | ~torch.isfinite(out)
    return out.masked_fill_(bad, fill)


def _cubic_weights(t: torch.Tensor, a: float = -0.5):
    """Cubic convolution weights for offsets (-1, 0, 1, 2) relative to
    the floor sample; t in [0, 1) (``warp.py:159``)."""
    def k(x):
        return cubic_kernel_weight(x, a=a, xp=torch)
    return [k(t + 1.0), k(t), k(1.0 - t), k(2.0 - t)]


def _tap_fields(rows: torch.Tensor, cols: torch.Tensor, method: str):
    """(offsets, floor rows, floor cols, row weights, column weights) of
    the separable filter at the fractional indices ``rows`` / ``cols``."""
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    tr = rows - r0
    tc = cols - c0
    if method == "bilinear":
        offsets, wr, wc = (0, 1), [1.0 - tr, tr], [1.0 - tc, tc]
    elif method == "cubic":
        offsets = (-1, 0, 1, 2)
        wr, wc = _cubic_weights(tr), _cubic_weights(tc)
    else:
        raise ValueError(f"Unknown method {method!r}")
    return offsets, r0.to(torch.int64), c0.to(torch.int64), wr, wc


def warp_interpolate(img: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, nodata: Optional[float] = None,
                     method: str = "bilinear",
                     fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """Bilinear / cubic warp with nodata-excluded weight renormalisation
    (``warp.py:167``). img (H, W, B), rows/cols (...,) fractional indices
    -> (..., B). The taps are gathered and accumulated one at a time, in
    the reference's order (rows outer, columns inner), so one tap's
    temporary is live beside the accumulator."""
    h, w, b = img.shape
    img = img.to(torch.float32)
    offsets, r0i, c0i, wr, wc = _tap_fields(rows, cols, method)
    zero = torch.zeros((), device=img.device)
    acc = torch.zeros(rows.shape + (b,), dtype=torch.float32,
                      device=img.device)
    # with a nodata value the masking, and so the weight mass, is per band
    wacc = torch.zeros(rows.shape + (b if nodata is not None else 1,),
                       dtype=torch.float32, device=img.device)
    for i, dr in enumerate(offsets):
        ri = r0i + dr
        rin = (ri >= 0) & (ri < h)
        ric = ri.clamp(0, h - 1)
        for j, dc in enumerate(offsets):
            ci = c0i + dc
            ok = (rin & (ci >= 0) & (ci < w))[..., None]
            v = _gather2d(img, ric, ci.clamp(0, w - 1))
            if nodata is not None:
                ok = ok & (v != nodata) & torch.isfinite(v)
            wgt = torch.where(ok, (wr[i] * wc[j])[..., None], zero)
            acc.addcmul_(torch.where(ok, v, zero), wgt)
            wacc += wgt
    return _renormalise(acc, wacc, _centre_in(rows, cols, h, w), fill,
                        inplace=True)


def warp_interpolate_taploop(img: torch.Tensor, rows: torch.Tensor,
                             cols: torch.Tensor,
                             nodata: Optional[float] = None,
                             method: str = "cubic",
                             fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """The memory-bounded form of :func:`warp_interpolate`
    (``warp.py:644``). The reference needs a sequential loop over the
    taps to keep one tap's temporary live; in eager PyTorch
    :func:`warp_interpolate` already runs that loop, in the same tap
    order, so this is the same computation under the reference's name
    (with its default method, cubic)."""
    return warp_interpolate(img, rows, cols, nodata=nodata, method=method,
                            fill=fill)


def warp_interpolate_chunked(img: torch.Tensor, rows: torch.Tensor,
                             cols: torch.Tensor,
                             nodata: Optional[float] = None,
                             method: str = "bilinear",
                             fill: float = NO_DATA_VALUE,
                             band_chunk: int = 32) -> torch.Tensor:
    """:func:`warp_interpolate` over band chunks written into one output
    (``warp.py:1048``): the gathered rows are ``band_chunk`` floats wide
    and the temporaries a chunk's size."""
    b = img.shape[-1]
    if b <= band_chunk:
        return warp_interpolate(img, rows, cols, nodata=nodata,
                                method=method, fill=fill)
    out = torch.empty(rows.shape + (b,), dtype=torch.float32,
                      device=img.device)
    for b0 in range(0, b, band_chunk):
        out[..., b0:b0 + band_chunk] = warp_interpolate(
            img[..., b0:b0 + band_chunk].contiguous(), rows, cols,
            nodata=nodata, method=method, fill=fill)
    return out


def block_average(img: torch.Tensor, factor: int,
                  nodata: Optional[float] = None,
                  fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """Exact integer-factor block mean over (H, W, B), excluding nodata
    and non-finite values: GDAL 'average' for aligned grids
    (``warp.py:223``)."""
    h, w, b = img.shape
    hh, ww = h // factor, w // factor
    blocks = img[:hh * factor, :ww * factor, :].reshape(hh, factor, ww,
                                                        factor, b)
    ok = torch.isfinite(blocks)
    if nodata is not None:
        ok &= blocks != nodata
    s = torch.where(ok, blocks, torch.zeros((), device=img.device)).sum(
        dim=(1, 3))
    n = ok.sum(dim=(1, 3))
    return (s / n.clamp(min=1)).masked_fill_(n == 0, fill)


def orthowarp_taploop(raw: torch.Tensor, glt_flat_idx: torch.Tensor,
                      glt_valid: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, method: str = "cubic",
                      fill: float = NO_DATA_VALUE,
                      row_chunks: int = 4) -> torch.Tensor:
    """Fused GLT orthorectification + resampling warp, exact
    (``warp.py:708``). The GLT step is a nearest gather, so
    ``warp(ortho)[d] = sum_taps w * raw[glt[tap]]``: each filter tap
    gathers through the GLT straight from the raw swath cube, the ortho
    cube never exists, and validity is the GLT mask and the in-bounds
    test (no nodata value is tested). The weight mass is one channel.

    raw (h, w, B); glt_flat_idx / glt_valid (Ho, Wo) from
    ``prepare_glt``; rows / cols (Hd, Wd) fractional ortho-grid indices.
    The loop runs over the taps (rows outer, columns inner, the
    reference's order, so the f32 sums agree to rounding) and, inside,
    over ``row_chunks`` blocks of destination rows; each step gathers one
    block's slab and adds it into the block's rows of the accumulator in
    place, so what lives is the accumulator and one slab."""
    b = raw.shape[-1]
    raw_flat = raw.reshape(-1, b)
    ho, wo = glt_flat_idx.shape
    glt_flat = glt_flat_idx.reshape(-1).to(torch.int64)
    valid_flat = glt_valid.reshape(-1)
    hd, wd = rows.shape
    chunk = -(-hd // max(1, int(row_chunks)))
    offsets, r0i, c0i, wr, wc = _tap_fields(rows, cols, method)
    zero = torch.zeros((), device=raw.device)
    acc = torch.zeros((hd, wd, b), dtype=torch.float32, device=raw.device)
    wacc = torch.zeros((hd, wd, 1), dtype=torch.float32, device=raw.device)
    for ti, dr in enumerate(offsets):
        for tj, dc in enumerate(offsets):
            for r0 in range(0, hd, chunk):
                blk = slice(r0, r0 + chunk)
                ri = r0i[blk] + dr
                ci = c0i[blk] + dc
                inside = (ri >= 0) & (ri < ho) & (ci >= 0) & (ci < wo)
                oidx = (ri.clamp(0, ho - 1) * wo
                        + ci.clamp(0, wo - 1)).reshape(-1)
                ok = valid_flat[oidx].reshape(ri.shape) & inside
                v = torch.index_select(raw_flat, 0, glt_flat[oidx])
                wgt = torch.where(ok, wr[ti][blk] * wc[tj][blk],
                                  zero)[..., None]
                acc[blk].addcmul_(v.reshape(*ri.shape, b), wgt)
                wacc[blk] += wgt
                del v
    return _renormalise(acc, wacc, _centre_in(rows, cols, ho, wo), fill,
                        inplace=True)


def _pad_axis(arr: torch.Tensor, axis: int, lo: int, hi: int
              ) -> torch.Tensor:
    """Zero-pad axis 0 or 1 of an (H, W, C) tensor."""
    if not (lo or hi):
        return arr
    pads = [0, 0, 0, 0, 0, 0]  # (C lo, C hi, W lo, W hi, H lo, H hi)
    pads[2 * (2 - axis)] = lo
    pads[2 * (2 - axis) + 1] = hi
    return F.pad(arr, pads)


def _f32(x: float) -> float:
    """``x`` rounded to float32 (kept as a Python float, exactly)."""
    return float(np.float32(x))


def _fast_pass(arr: torch.Tensor, spec, axis: int) -> torch.Tensor:
    """One fast separable pass along ``axis`` (0 or 1) of (H, W, B)
    (``warp.py:449``). Returns the raw weighted sums (average: block-sum
    / f; bilinear: two-tap lerp). Out-of-range taps contribute zero;
    centre-in masking is applied by the caller."""
    kind, f = spec[0], spec[1]
    size = arr.shape[axis]
    if kind == "avg":
        _, _, j0, dst, _src, _lo, _hi = spec
        lo_pad = max(0, -j0)
        hi_pad = max(0, j0 + f * dst - size)
        a = _pad_axis(arr, axis, lo_pad, hi_pad)
        a = a.narrow(axis, j0 + lo_pad, f * dst)
        if axis == 0:
            a = a.reshape(dst, f, a.shape[1], a.shape[2])
        else:
            a = a.reshape(a.shape[0], dst, f, a.shape[2])
        return a.sum(dim=axis + 1) * _f32(1.0 / f)
    # bilinear
    _, _, r0s, ts, dst, _src, _lo, _hi = spec
    n_full = (dst + f - 1) // f
    lo_pad = max(0, -min(r0s))
    hi_pad = max(0, max(r0s) + n_full + 1 - size)
    a = _pad_axis(arr, axis, lo_pad, hi_pad)
    phases = []
    for p in range(f):
        s0 = r0s[p] + lo_pad
        seg0 = a.narrow(axis, s0, n_full)
        seg1 = a.narrow(axis, s0 + 1, n_full)
        t = np.float32(ts[p])
        phases.append(seg0 * float(np.float32(1.0) - t) + seg1 * float(t))
    out = torch.stack(phases, dim=axis + 1)  # (..., n_full, f, ...)
    if axis == 0:
        return out.reshape(n_full * f, out.shape[2], out.shape[3])[:dst]
    return out.reshape(out.shape[0], n_full * f, out.shape[3])[:, :dst]


def _masked_num_den(img, nodata, valid_mask, passes):
    """Numerator and weight mass of a nodata-excluded resample, with the
    reference's four cases (``warp.py:596-610``)."""
    if valid_mask is not None:
        ok = valid_mask[..., None]
        if nodata is not None:
            ok = ok & (img != nodata) & torch.isfinite(img)
            den = passes(ok.to(torch.float32))
        else:
            den = passes(valid_mask.to(torch.float32)[..., None])
        num = passes(torch.where(ok, img, torch.zeros((), device=img.device)))
    elif nodata is not None:
        ok = (img != nodata) & torch.isfinite(img)
        num = passes(torch.where(ok, img, torch.zeros((), device=img.device)))
        den = passes(ok.to(torch.float32))
    else:
        num = passes(img)
        den = None
    return num, den


def separable_resample_fast(img: torch.Tensor, spec_r, spec_c,
                            nodata: Optional[float] = None,
                            fill: float = NO_DATA_VALUE,
                            valid_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Integer-aligned separable resample of (Hs, Ws, B) to (Hd, Wd, B)
    (``warp.py:582``): nodata-excluded renormalisation, ``fill`` where
    the covered mass vanishes or the centre leaves the source. ``spec_r``
    / ``spec_c`` come from ``separable_fast_spec``; ``valid_mask``
    (Hs, Ws) marks validity shared by all bands (and excludes NaN)."""
    img = img.to(torch.float32)

    def passes(arr):
        return _fast_pass(_fast_pass(arr, spec_r, 0), spec_c, 1)

    num, den = _masked_num_den(img, nodata, valid_mask, passes)
    if den is None:
        den = passes(torch.ones(img.shape[:2] + (1,), dtype=torch.float32,
                                device=img.device))
    dev = img.device
    r = torch.arange(num.shape[0], device=dev)
    c = torch.arange(num.shape[1], device=dev)
    r_in = (r >= spec_r[-2]) & (r < spec_r[-1])
    c_in = (c >= spec_c[-2]) & (c < spec_c[-1])
    keep = r_in[:, None, None] & c_in[None, :, None]
    return _renormalise(num, den, keep, fill)


def separable_resample_matmul(img: torch.Tensor, Wr: torch.Tensor,
                              Wc: torch.Tensor,
                              nodata: Optional[float] = None,
                              fill: float = NO_DATA_VALUE,
                              valid_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """(Hs, Ws, B) resampled to (Hd, Wd, B) with dense row/column weight
    matrices Wr (Hd, Hs), Wc (Wd, Ws) from ``separable_weight_matrix``
    (``warp.py:302``, in f32). Same renormalisation as
    :func:`separable_resample_fast`."""
    img = img.to(torch.float32)

    def mm(arr):
        t1 = torch.einsum("dh,hwb->dwb", Wr, arr)
        return torch.einsum("ew,dwb->deb", Wc, t1)

    num, den = _masked_num_den(img, nodata, valid_mask, mm)
    if den is None:
        den = torch.outer(Wr.sum(dim=1), Wc.sum(dim=1))[..., None]
    return _renormalise(num, den, torch.ones((), dtype=torch.bool,
                                             device=img.device), fill)


# ---------------------------------------------------------------------------
# High-level API
# ---------------------------------------------------------------------------

def _on(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _interp_matrix(idx_1d: np.ndarray, src_size: int, method: str,
                   device: torch.device) -> torch.Tensor:
    """``separable_weight_matrix(idx_1d, src_size, method)`` for
    ``"bilinear"`` / ``"cubic"`` as a tensor on ``device``: its taps
    (``separable_taps``, on the host) scattered into the dense (Dst, Src)
    matrix there, so the dense host array and its upload are not made."""
    rows, cols, vals = separable_taps(idx_1d, src_size, method)
    W = torch.zeros((len(idx_1d), src_size), dtype=torch.float32,
                    device=device)
    W[_on(rows, device), _on(cols, device)] = _on(vals, device)
    return W


def resample_tensor_to_grid(arr: torch.Tensor, src_grid: Grid,
                            dst_grid: Grid, *, method: str = "bilinear",
                            nodata: Optional[float] = None,
                            fill: float = NO_DATA_VALUE,
                            band_chunk: Optional[int] = None,
                            kernel: str = "auto") -> torch.Tensor:
    """:func:`resample_to_grid` on a float32 (H, W, B) tensor, on its
    device, returning the (Hd, Wd, B) tensor there."""
    dev = arr.device
    if method == "average":
        f = integer_factor(src_grid, dst_grid)
        if f is not None:
            ox = int(round((dst_grid.x0 - src_grid.x0) / src_grid.dx))
            oy = int(round((src_grid.y0 - dst_grid.y0) / src_grid.dy))
            # the exact block reduction needs the dst window fully inside
            # the source; otherwise a negative / overflowing slice would
            # misplace or truncate the output
            if (0 <= oy and oy + dst_grid.height * f <= arr.shape[0]
                    and 0 <= ox and ox + dst_grid.width * f <= arr.shape[1]):
                sub = arr[oy:oy + dst_grid.height * f,
                          ox:ox + dst_grid.width * f, :]
                return block_average(sub, f, nodata=nodata, fill=fill)
        sep_avg = separable_index_axes(src_grid, dst_grid)
        if sep_avg is not None:
            # same CRS, not an integer ratio or not contained: the
            # area-weighted separable product (GDAL 'average')
            Wr = _on(separable_weight_matrix(
                sep_avg[0], src_grid.height, "average",
                scale=dst_grid.dy / src_grid.dy), dev)
            Wc = _on(separable_weight_matrix(
                sep_avg[1], src_grid.width, "average",
                scale=dst_grid.dx / src_grid.dx), dev)
            return separable_resample_matmul(arr, Wr, Wc, nodata=nodata,
                                             fill=fill)
        method_eff = "bilinear"  # cross-CRS average: bilinear transfer
    else:
        method_eff = method

    sep = separable_index_axes(src_grid, dst_grid)
    if sep is not None and method_eff in ("bilinear", "cubic"):
        if _sep.takes_kernel(dev):
            out = _sep.sep_resample(arr.to(torch.float32).contiguous(),
                                    sep[0], sep[1], method_eff,
                                    nodata=nodata, fill=fill)
            count(_sep.RESAMPLE_COUNTER)
            return out
        # on the CPU: two dense products, in exact f32
        Wr = _interp_matrix(sep[0], src_grid.height, method_eff, dev)
        Wc = _interp_matrix(sep[1], src_grid.width, method_eff, dev)
        return separable_resample_matmul(arr, Wr, Wc, nodata=nodata,
                                         fill=fill)
    if sep is not None:
        r1, c1 = _on(sep[0], dev), _on(sep[1], dev)
        rows = r1[:, None].expand(r1.shape[0], c1.shape[0])
        cols = c1[None, :].expand(r1.shape[0], c1.shape[0])
    else:
        rows_np, cols_np = source_index_field(src_grid, dst_grid)
        rows, cols = _on(rows_np, dev), _on(cols_np, dev)
        # large cross-CRS reprojections go to the two-pass scanline warp
        # when the row field is monotone per column; small ones keep the
        # gather kernel
        diffs = np.diff(rows_np, axis=0)
        monotone = (rows_np.shape[0] < 2
                    or bool(np.all(diffs > 0) or np.all(diffs < 0)))
        big = rows_np.size >= (256 * 256)
        if (method_eff in ("bilinear", "cubic") and monotone
                and (kernel == "two_pass" or (kernel == "auto" and big))):
            cstar = scanline_cstar(rows_np, cols_np, src_grid.height)
            return warp_two_pass(arr, rows, cols, _on(cstar, dev),
                                 nodata=nodata, method=method_eff, fill=fill)

    def run(block):
        if method_eff == "nearest":
            return warp_nearest(block, rows, cols, nodata=nodata, fill=fill)
        return warp_interpolate(block, rows, cols, nodata=nodata,
                                method=method_eff, fill=fill)

    nb = arr.shape[-1]
    if band_chunk is None or band_chunk >= nb:
        return run(arr)
    return torch.cat([run(arr[..., b0:b0 + band_chunk].contiguous())
                      for b0 in range(0, nb, band_chunk)], dim=-1)


def resample_to_grid(data: np.ndarray, src_grid: Grid, dst_grid: Grid, *,
                     method: str = "bilinear",
                     nodata: Optional[float] = None,
                     fill: float = NO_DATA_VALUE,
                     band_chunk: Optional[int] = None,
                     kernel: str = "auto", device=None) -> np.ndarray:
    """Resample (H, W, B) or (H, W) data from ``src_grid`` onto
    ``dst_grid`` (``warp.py:1094``). Returns float32 NumPy (Hd, Wd, B),
    the band axis kept.

    Routes, in the reference's order: an aligned integer-ratio
    ``"average"`` whose window lies inside the source is an exact block
    mean; any other same-CRS average the area-weighted separable
    product; same-CRS bilinear / cubic on a CUDA device one kernel
    (:mod:`.sep_resample`, counted as ``resample.kernel`` in the open
    span), on the CPU two dense f32 products; a
    cross-CRS bilinear / cubic transfer the two-pass scanline warp
    (:func:`warp_two_pass`, the scanline kernel) when its row field is
    monotone per column and ``kernel`` is ``"two_pass"``, or ``"auto"``
    and the destination has at least 256 x 256 pixels; everything else
    the gather kernels (``kernel="gather"`` keeps them), in chunks of
    ``band_chunk`` bands if given. ``device``: default the current CUDA
    device. A tensor ``data`` is resampled on ``device`` (default its
    own) and returned as a float32 tensor there."""
    if isinstance(data, torch.Tensor):
        dev = data.device if device is None else resolve_device(device)
        arr = data.to(dev, torch.float32)
    else:
        dev = resolve_device(device)
        arr = torch.from_numpy(np.asarray(data, dtype=np.float32)).to(dev)
    squeeze = arr.dim() == 2
    if squeeze:
        arr = arr[..., None]
    out = resample_tensor_to_grid(arr, src_grid, dst_grid, method=method,
                                  nodata=nodata, fill=fill,
                                  band_chunk=band_chunk, kernel=kernel)
    if not isinstance(data, torch.Tensor):
        out = out.cpu().numpy()
    return out[..., 0] if squeeze else out


def reproject_stack_to_grid(src_stack: np.ndarray, src_grid: Grid,
                            dst_grid: Grid, resampling: str = "bilinear",
                            nodata: Optional[float] = None,
                            device=None) -> np.ndarray:
    """(C, H, W) -> (C, H2, W2) float32 (``warp.py:1206``); the fill is
    NaN without a nodata value, else the nodata value."""
    hwb = np.moveaxis(np.asarray(src_stack), 0, -1)
    out = resample_to_grid(hwb, src_grid, dst_grid, method=resampling,
                           nodata=nodata,
                           fill=np.nan if nodata is None else nodata,
                           device=device)
    return np.moveaxis(out, -1, 0)

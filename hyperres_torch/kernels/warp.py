"""Grid-to-grid resampling on the device (``hyperres/kernels/warp.py``).

- :func:`orthowarp_two_pass`: fused GLT gather + two-pass scanline warp
  onto the S2-anchored UTM grid (``warp.py:837-931``), both passes in
  the hand-written scanline kernel (:mod:`.banded`), by the banded route
  or, with ``backend="pallas"``, the dense route.
- :func:`separable_resample_fast`: the integer-aligned same-CRS grid
  transfers (10 m -> 60 m box average, 60 m -> 10 m bilinear) as
  reshape block sums and phase-cycled lerps (``warp.py:449-618``), in
  the channel-minor (H, W, C) layout.
- :func:`separable_resample_matmul`: the dense weight-matrix transfer
  for grids without an integer-aligned spec (``warp.py:302``).

The float64 projection math and the index fields stay on the host
(:mod:`.host`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import NO_DATA_VALUE

from .banded import (
    check_precision, scanline_resample, scanline_resample_dense,
)
from .glt import glt_take


def _renormalise(num: torch.Tensor, den: torch.Tensor, keep: torch.Tensor,
                 fill: float) -> torch.Tensor:
    """``num / den`` where ``|den| > 1e-6`` and ``keep``, else ``fill``
    (the package-wide nodata renormalisation)."""
    good = den.abs() > 1e-6
    out = num / torch.where(good, den, torch.ones((), device=den.device))
    return out.masked_fill_(~(good & keep), fill)


def orthowarp_src_ext(raw: torch.Tensor, glt_flat_idx: torch.Tensor,
                      glt_valid: torch.Tensor) -> torch.Tensor:
    """The warp's source: the GLT-gathered cube times its validity, with
    the validity as one extra channel, ``[v * valid, valid]``
    (``warp.py:880-884``). (Ho, Wo, B + 1) float32."""
    v = glt_take(raw, glt_flat_idx)
    valid = glt_valid.to(torch.float32)[..., None]
    return torch.cat([v * valid, valid], dim=-1)


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
    centre_in = ((rows >= -0.5) & (rows <= ho - 0.5)
                 & (cols >= -0.5) & (cols <= wo - 0.5))[..., None]
    return _renormalise(out_ext[..., :b], out_ext[..., b:], centre_in,
                        fill)


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

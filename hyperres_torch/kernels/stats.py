"""Masked percentiles and stretches, min / max, binary erosion, the
cube PSNR / SAM metrics, the u16 quantizers and the OBS range estimator
(``hyperres/kernels/stats.py``), and the two fixed-shape percentile
estimators the reference keeps for sharded data (histogram and bracket
refinement).

The reference finds its order statistics with a 32-step bit search
(it works around the TPU sort's code size). Here they come from
``torch.sort`` over the masked values: the same k-th smallest values,
bit for bit. The ranks, the interpolation weight and the linear combine
follow the reference's f32 formula (``stats.py:103-115``) as its XLA
CPU program evaluates it — ``q / 100`` as ``q * f32(0.01)`` and the
combine ``lo * (1 - w) + hi * w`` with one fused multiply-add — in
NumPy on the host, where the handful of values involved already are.
The percentiles are then bit-identical to the reference's, so the
stretched values agree to the last bit of the division.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import quantize


def masked_order_stats(img: torch.Tensor, mask: torch.Tensor,
                       qs: Sequence[float]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """For each channel of img (H, W, C) over ``mask`` (H, W), NaNs
    excluded, and each percentile in ``qs``: the order statistics below
    and above the percentile's rank, the weight of the upper one, and
    the channel's count of valid values. Returns (lo (C, Q), hi (C, Q),
    hw (C, Q)) as float32 and n (C,); lo/hi are NaN where n == 0."""
    c = img.shape[-1]
    flat = img.reshape(-1, c)
    m = mask.reshape(-1)
    q32 = np.asarray(qs, dtype=np.float32)
    lo = np.full((c, q32.size), np.nan, np.float32)
    hi = np.full((c, q32.size), np.nan, np.float32)
    hw = np.zeros((c, q32.size), np.float32)
    n = np.zeros(c, np.int64)
    for ch in range(c):
        x = flat[:, ch]
        vals = torch.sort(x[m & ~torch.isnan(x)]).values
        n[ch] = vals.numel()
        nm1 = max(int(n[ch]) - 1, 0)
        pos = q32 * np.float32(0.01) * np.float32(nm1)
        j = np.clip(np.floor(pos).astype(np.int64), 0, nm1)
        jp = np.clip(np.ceil(pos).astype(np.int64), 0, nm1)
        hw[ch] = pos - np.floor(pos)
        if n[ch] == 0:
            continue
        idx = torch.as_tensor(np.concatenate([j, jp]), device=vals.device)
        v = vals[idx].cpu().numpy()
        lo[ch], hi[ch] = v[:q32.size], v[q32.size:]
    return lo, hi, hw, n


def masked_percentile_channels(img: torch.Tensor, mask: torch.Tensor,
                               qs: Sequence[float]) -> np.ndarray:
    """Per-channel percentiles (np.percentile linear interpolation) of
    img (H, W, C) over ``mask``, NaNs excluded -> (C, Q) float32 NumPy;
    NaN for a channel with no valid value (``stats.py:92``)."""
    lo, hi, hw, n = masked_order_stats(img, mask, qs)
    # fma(lo, 1 - w, hi * w): the f64 product of two f32 values is exact
    out = (lo.astype(np.float64) * (np.float32(1.0) - hw)
           + (hi * hw).astype(np.float64)).astype(np.float32)
    out[n == 0] = np.nan
    return out


#: ``shared_percentile_stretch`` methods, by the reference's names
STRETCH_METHODS = ("bitsearch", "sort", "bracket")


def shared_percentile_stretch(img: torch.Tensor, mask: torch.Tensor,
                              pmin: float = 2.0, pmax: float = 98.0,
                              method: str = "bitsearch") -> torch.Tensor:
    """Per-channel [pmin, pmax] percentile stretch within ``mask``,
    clipped to [0, 1] (``stats.py:230``). img (H, W, C).

    ``method``: ``"bitsearch"`` and ``"sort"`` are the reference's two
    exact order-statistic routes; both take the exact sort path here.
    ``"bracket"`` estimates each channel's percentiles with
    :func:`bracket_percentile`."""
    if method not in STRETCH_METHODS:
        raise ValueError(f"method must be one of {STRETCH_METHODS}, got "
                         f"{method!r}")
    if method == "bracket":
        qs = [pmin, pmax]
        return torch.stack(
            [_stretch(img[..., c], *bracket_percentile(img[..., c], mask, qs))
             for c in range(img.shape[-1])], dim=-1)
    lohi = torch.as_tensor(masked_percentile_channels(img, mask,
                                                      [pmin, pmax]),
                           device=img.device)  # (C, 2)
    return _stretch(img, lohi[:, 0], lohi[:, 1])


def histogram_counts(vals: torch.Tensor, lo: float, hi: float,
                     nbins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refinement round of :func:`histogram_percentile` over the
    valid values ``vals`` (1-D): the (nbins,) int64 histogram of the
    values in [lo, hi], binned as the reference bins them (f32
    ``(v - lo) / width * nbins`` truncated and clipped), and the int64
    count below ``lo``. Exact integer counts, so shards add up exactly."""
    width = float(max(np.float32(hi) - np.float32(lo), np.float32(1e-30)))
    inside = (vals >= lo) & (vals <= hi)
    idx = ((vals[inside] - lo) / width * nbins).to(torch.int32)
    hist = torch.bincount(idx.clamp_(0, nbins - 1), minlength=nbins)
    return hist, (vals < lo).sum()


def refine_histogram_brackets(counts, n: int, glo: float, ghi: float,
                              qs: Sequence[float], nbins: int, iters: int
                              ) -> np.ndarray:
    """The host side of :func:`histogram_percentile`: for each q, ``iters``
    rounds that narrow [lo, hi] to the bin holding the q-th percentile's
    rank, in the reference's f32 arithmetic (``stats.py:152-185``).
    ``counts(lo, hi)`` returns the (histogram, below) pair of one round
    over all the data (:func:`histogram_counts`, summed over shards).
    Returns (Q,) float32 bracket midpoints."""
    f32 = np.float32
    out = np.empty(len(qs), np.float32)
    for k, q in enumerate(qs):
        target = f32(q) / f32(100.0) * f32(n)
        lo, hi = f32(glo), f32(ghi)
        for _ in range(iters):
            width = np.maximum(hi - lo, f32(1e-30))
            hist, below = counts(float(lo), float(hi))
            cdf = int(below) + np.cumsum(hist.cpu().numpy())
            b = int(np.clip(np.searchsorted(cdf, np.float64(target)),
                            0, nbins - 1))
            lo, hi = (lo + f32(b) / f32(nbins) * width,
                      lo + f32(b + 1) / f32(nbins) * width)
        out[k] = (lo + hi) / f32(2.0)
    return out


def histogram_percentile(x: torch.Tensor, mask: torch.Tensor,
                         qs: Sequence[float], nbins: int = 2048,
                         iters: int = 2) -> torch.Tensor:
    """Percentiles of ``x[mask]`` by iterative histogram refinement
    (``stats.py:152``): each percentile narrows its own bracket ``iters``
    times to one of ``nbins`` bins, ~range / nbins**iters accurate; the
    bracket's midpoint is returned. The histograms are exact integer
    counts (the reference sums f32 weights, exact below 2**24 values per
    bin); the bracket arithmetic is the reference's f32. The reference
    computes this outside any Pallas kernel; here it is plain tensor
    ops. Returns (Q,) float32 on x's device."""
    vals = x.reshape(-1)[mask.reshape(-1)]
    n = vals.numel()
    glo = float(vals.min()) if n else float("inf")
    ghi = float(vals.max()) if n else float("-inf")
    out = refine_histogram_brackets(
        lambda lo, hi: histogram_counts(vals, lo, hi, nbins), n, glo, ghi,
        qs, nbins, iters)
    return torch.as_tensor(out, device=x.device)


def bracket_percentile(x: torch.Tensor, mask: torch.Tensor,
                       qs: Sequence[float], edges: int = 128,
                       iters: int = 3) -> torch.Tensor:
    """Percentiles of ``x[mask]`` by bracket refinement (``stats.py:188``):
    each round splits every percentile's bracket into ``edges`` spans
    and keeps the span whose count of values below its edges first
    passes the target rank, ~range / edges**iters accurate. The counts
    below the edges come from one ``bucketize`` and a cumulative
    ``bincount`` (the reference compares every value with every edge);
    the bracket arithmetic is the reference's f32. NaN for an empty
    mask. Returns (Q,) float32 on x's device."""
    vals = x.reshape(-1)[mask.reshape(-1)]
    dev = x.device
    n = torch.tensor(float(vals.numel()), device=dev)
    big = torch.tensor(float("inf"), device=dev)
    glo = vals.min() if vals.numel() else big
    ghi = vals.max() if vals.numel() else -big
    grid = torch.arange(1, edges, dtype=torch.float32, device=dev) / edges
    out = []
    for q in qs:
        target = torch.tensor(q, dtype=torch.float32, device=dev) / 100.0 * n
        lo, hi = glo, ghi
        for _ in range(iters):
            width = torch.clamp(hi - lo, min=1e-30)
            e = lo + width * grid                          # (E-1,)
            below = torch.bincount(torch.bucketize(vals, e, right=True),
                                   minlength=edges)
            counts = torch.cumsum(below, 0)[:edges - 1].to(torch.float32)
            idx = (counts <= target).sum().to(torch.float32)
            lo, hi = (lo + idx / edges * width,
                      lo + (idx + 1.0) / edges * width)
        out.append((lo + hi) / 2.0)
    res = torch.stack(out)
    return torch.where(n > 0, res, torch.full_like(res, float("nan")))


def masked_percentile(x: torch.Tensor, mask: torch.Tensor,
                      qs: Sequence[float]) -> torch.Tensor:
    """Percentiles of ``x[mask]``, NaNs excluded (linear interpolation,
    as ``np.percentile``; ``stats.py:25``). x and mask of one shape; qs
    (Q,) in [0, 100] -> (Q,) float32 on x's device, NaN for an empty
    mask."""
    out = masked_percentile_channels(x.reshape(-1, 1, 1),
                                     mask.reshape(-1, 1), qs)[0]
    return torch.as_tensor(out, device=x.device)


def masked_minmax(x: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of ``x[mask]`` at a fixed shape: (inf, -inf) for an
    empty mask (``stats.py:128``)."""
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    return (torch.where(mask, x, big).min(),
            torch.where(mask, x, -big).max())


def _stretch(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.clamp((x - lo) / (hi - lo + 1e-12), 0.0, 1.0)


def robust_norm(x: torch.Tensor, pmin: float = 2.0, pmax: float = 98.0
                ) -> torch.Tensor:
    """Unmasked NaN-aware [pmin, pmax] stretch, clipped to [0, 1]
    (color.py:6-8, ``stats.py:263``)."""
    lo, hi = masked_percentile(x, torch.ones_like(x, dtype=torch.bool),
                               [pmin, pmax])
    return _stretch(x, lo, hi)


def robust_norm_rgb(img: torch.Tensor, mask: torch.Tensor,
                    pmin: float = 2.0, pmax: float = 98.0) -> torch.Tensor:
    """Per-channel stretch within ``mask``; invalid pixels become NaN
    (color.py:10-23, ``stats.py:271``). img (H, W, C)."""
    lohi = torch.as_tensor(masked_percentile_channels(img, mask,
                                                      [pmin, pmax]),
                           device=img.device)
    out = _stretch(img, lohi[:, 0], lohi[:, 1])
    return out.masked_fill_(~mask[..., None], float("nan"))


def cube_psnr_sam(cube: torch.Tensor, truth: torch.Tensor, fill: float,
                  erode: int = 2, data_range: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(valid fraction, PSNR dB, mean SAM rad) of an (H, W, B) product
    cube against a truth cube over the ``erode``-px interior of the
    cube's valid mask (``cube[..., 0] != fill``), as 0-d tensors on the
    cube's device (``stats.py:337``): only scalars need to come back."""
    vmask = cube[..., 0] != fill
    e = erode_mask(vmask, erode)
    n_px = e.sum().clamp(min=1)
    zero = torch.zeros((), device=cube.device)
    d2 = torch.sum((cube - truth) ** 2, dim=-1)
    mse = torch.where(e, d2, zero).sum() / (n_px * cube.shape[-1])
    p_db = 10.0 * torch.log10(data_range ** 2 / mse)
    num = torch.sum(cube * truth, dim=-1)
    den = (torch.linalg.norm(cube, dim=-1)
           * torch.linalg.norm(truth, dim=-1) + 1e-12)
    ang = torch.arccos(torch.clamp(num / den, -1.0, 1.0))
    s_rad = torch.where(e, ang, zero).sum() / n_px
    return vmask.to(torch.float32).mean(), p_db, s_rad


def erode_mask(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary erosion with the 4-connected cross (scipy
    ``binary_erosion`` defaults: outside the array is background, so
    border pixels erode away) (``stats.py:324``)."""
    m = mask
    for _ in range(iterations):
        p = torch.nn.functional.pad(m, (1, 1, 1, 1), value=False)
        m = (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1]
             & p[1:-1, :-2] & p[1:-1, 2:])
    return m


def strided_band_minmax(cube_hwb: torch.Tensor, nodata: float,
                        stride: int = 64, pmin: float = 1.0,
                        pmax: float = 99.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-band robust (pmin, pmax) percentiles of the valid values
    (finite, != nodata) of a strided sample ``cube[::stride, ::stride]``,
    the OBS scaling estimator (``stats.py:136``). Returns (lo, hi), each
    (B,) float32, NaN for a band with no valid sample. Follows
    ``jnp.nanpercentile``'s f32 arithmetic: rank ``q / 100 * (n - 1)``,
    ``lo_value * (1 - w) + hi_value * w``."""
    sample = cube_hwb[::stride, ::stride, :]
    b = sample.shape[-1]
    flat = sample.reshape(-1, b)
    valid = torch.isfinite(flat) & (flat != np.float32(nodata))
    xs = torch.sort(torch.where(valid, flat, float("nan")), dim=0).values
    counts = valid.sum(dim=0).to(torch.float32)
    out = []
    for p in (pmin, pmax):
        pos = (torch.tensor(p, dtype=torch.float32) / 100.0).to(
            flat.device) * (counts - 1.0)
        low, high = torch.floor(pos), torch.ceil(pos)
        hw = pos - low
        lw = 1.0 - hw
        top = counts - 1.0
        low = torch.maximum(torch.minimum(low, top), torch.zeros_like(low))
        high = torch.maximum(torch.minimum(high, top), torch.zeros_like(high))
        lv = xs.gather(0, low.to(torch.int64)[None])[0]
        hv = xs.gather(0, high.to(torch.int64)[None])[0]
        out.append(lv * lw + hv * hw)
    return out[0], out[1]


def quantize_u16(x: torch.Tensor, lo, hi,
                 valid: Optional[torch.Tensor] = None, nodata_u16: int = 0,
                 *, nodata_src: Optional[float] = None) -> torch.Tensor:
    """Scale [lo, hi] -> [0, 65535] uint16 with a reserved nodata
    sentinel, gdal_translate -scale semantics (``stats.py:289``): lo/hi
    are scalars or per-band (B,) for (..., B) input. Validity is
    ``valid`` when given, else ``isfinite(x)`` and ``x != nodata_src``
    tested in the kernel. On a CUDA tensor this launches the quantize
    kernel (:mod:`.quantize`); on a CPU tensor it runs its plain
    version."""
    return quantize.quantize_u16(x, lo, hi, valid, nodata_u16,
                                 form="stats", nodata_src=nodata_src)


def dequantize_u16(q: torch.Tensor, scale, offset, nodata_u16: int,
                   fill: float = float("nan")) -> torch.Tensor:
    """Inverse of quantize: ``q * scale + offset`` in float32, ``fill``
    where ``q == nodata_u16`` (``stats.py:316``)."""
    qi = q.to(torch.int32)
    x = qi.to(torch.float32) * scale + offset
    return torch.where(qi == int(nodata_u16), float(fill), x)


def quantize_reflectance_u16(x: torch.Tensor, valid: torch.Tensor,
                             scale: float = 10000.0,
                             nodata_u16: int = 65535) -> torch.Tensor:
    """EMIT tile quantization (``stats.py:305``): ``rint(x * scale)``
    (half to even), clipped to [0, nodata - 1], as uint16; ``nodata``
    where ``valid`` (broadcast against ``x``) is False."""
    q = torch.clamp(torch.round(x * scale), 0.0, float(nodata_u16 - 1))
    # int32 until the end: CUDA takes few operators on uint16 beyond copy
    q = torch.where(valid, q.to(torch.int32), nodata_u16)
    return q.to(torch.uint16)

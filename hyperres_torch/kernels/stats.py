"""Masked percentile stretch, binary erosion, the u16 quantizers and the
OBS range estimator (``hyperres/kernels/stats.py``).

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


def shared_percentile_stretch(img: torch.Tensor, mask: torch.Tensor,
                              pmin: float = 2.0, pmax: float = 98.0
                              ) -> torch.Tensor:
    """Per-channel [pmin, pmax] percentile stretch within ``mask``,
    clipped to [0, 1] (``stats.py:230``). img (H, W, C)."""
    lohi = torch.as_tensor(masked_percentile_channels(img, mask,
                                                      [pmin, pmax]),
                           device=img.device)  # (C, 2)
    lo = lohi[:, 0]
    hi = lohi[:, 1]
    return torch.clamp((img - lo) / (hi - lo + 1e-12), 0.0, 1.0)


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

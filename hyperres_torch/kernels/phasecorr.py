"""Batched FFT phase correlation with subpixel peak refinement
(``hyperres/kernels/phasecorr.py``).

Device replacement for AROSICS' per-tie-point FFT shift estimation
(the black box behind s2_emit/arosics_coreg.py:135-163). All tie-point
windows are processed as one batch:

  windows -> Hann taper -> rFFT2 -> normalised cross-power spectrum ->
  irFFT2 -> argmax (wrapped) -> 3-point parabolic subpixel refinement,

with a reliability score in AROSICS' spirit: the correlation-surface
peak prominence ((peak - mean) / std, scaled to ~0-100).

The transforms are ``torch.fft.rfft2`` / ``irfft2`` (cuFFT on the card):
the reference computes them with ``jnp.fft`` outside any Pallas kernel,
so there is no TPU kernel here to port. The arithmetic around them
follows the reference's f32 operations: the Hann window in f64 cast to
f32, the population std, the frequencies as ``k / n`` in f32 (as
``jnp.fft.fftfreq`` / ``rfftfreq`` compute them), the wrapped neighbour
indices as ``torch.remainder`` (Python's ``%``), the first maximum by
``argmax`` (as ``jnp.argmax``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

# Copied exactly from hyperres/kernels/phasecorr.py:34 (its calibration
# note is there): reliability = 100 * (1 - exp(-snr / RELIABILITY_TAU)),
# snr = (corr peak - mean) / std, so that min_reliability=60 accepts the
# windows whose shift error is < 0.5 px with >= 99 % probability.
RELIABILITY_TAU = 20.8


def _hann2d(h: int, w: int) -> np.ndarray:
    wy = np.hanning(h)
    wx = np.hanning(w)
    return (wy[:, None] * wx[None, :]).astype(np.float32)


def _freqs(n: int, full: bool, device: torch.device) -> torch.Tensor:
    """``jnp.fft.fftfreq(n)`` (``full``) or ``rfftfreq(n)`` in f32: the
    integer frequencies divided by n, correctly rounded."""
    if full:
        i = torch.arange(n, dtype=torch.float32, device=device)
        k = torch.remainder(i + n // 2, n) - n // 2
    else:
        k = torch.arange(n // 2 + 1, dtype=torch.float32, device=device)
    return k / torch.tensor(float(n), dtype=torch.float32, device=device)


def _as_batch(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(dev)


def phase_correlate_batch(ref, tgt, lowpass_frac: float = 1.0, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """ref/tgt (N, H, W) float32 (arrays or tensors) -> (dy (N,), dx (N,),
    reliability (N,)) tensors on ``device`` (``phasecorr.py:44``;
    default the current CUDA device).

    The returned shift is the amount the *target* is displaced relative
    to the reference: shifting tgt by (-dy, -dx) aligns it to ref.

    ``lowpass_frac`` masks the cross-power spectrum beyond that fraction
    of Nyquist. Essential when the reference is an upsampled coarser
    raster (e.g. EMIT 60 m matched on the S2 10 m grid: frac ~ 1/6):
    spectral whitening would otherwise amplify frequencies where the
    reference has no signal at all, biasing the subpixel peak."""
    dev = resolve_device(device)
    ref = _as_batch(ref, dev)
    tgt = _as_batch(tgt, dev)
    n, h, w = ref.shape
    win = torch.from_numpy(_hann2d(h, w)).to(dev)

    def norm(x):
        m = torch.mean(x, dim=(1, 2), keepdim=True)
        return (x - m) * win[None]

    F1 = torch.fft.rfft2(norm(ref))
    F2 = torch.fft.rfft2(norm(tgt))
    cross = F1 * torch.conj(F2)
    cross = cross / (torch.abs(cross) + 1e-12)
    if lowpass_frac < 1.0:
        fy = _freqs(h, True, dev)[:, None]   # cycles/sample, |fy| <= 0.5
        fx = _freqs(w, False, dev)[None, :]
        rad = torch.sqrt(fy * fy + fx * fx) / 0.5
        cross = cross * (rad <= lowpass_frac)[None]
    corr = torch.fft.irfft2(cross, s=(h, w))  # (N, H, W)

    flat = corr.reshape(n, -1)
    peak_idx = torch.argmax(flat, dim=1)
    py = peak_idx // w
    px = peak_idx % w

    # 3-point parabolic refinement around the (wrapped) peak
    def parabola(cm, c0, cp):
        denom = cm - 2.0 * c0 + cp
        ok = torch.abs(denom) > 1e-12
        off = torch.where(ok, 0.5 * (cm - cp) / torch.where(ok, denom, 1.0),
                          0.0)
        return torch.clamp(off, -0.5, 0.5)

    bi = torch.arange(n, device=dev)
    c0 = corr[bi, py, px]
    cym = corr[bi, torch.remainder(py - 1, h), px]
    cyp = corr[bi, torch.remainder(py + 1, h), px]
    cxm = corr[bi, py, torch.remainder(px - 1, w)]
    cxp = corr[bi, py, torch.remainder(px + 1, w)]
    dy = py.to(torch.float32) + parabola(cym, c0, cyp)
    dx = px.to(torch.float32) + parabola(cxm, c0, cxp)
    # unwrap: shifts beyond half the window are negative, then negate so
    # the result is the displacement of tgt relative to ref (tgt(r, c) =
    # ref(r - dy, c - dx) => returns (dy, dx))
    dy = torch.where(dy > h / 2.0, dy - h, dy)
    dx = torch.where(dx > w / 2.0, dx - w, dx)
    dy = -dy
    dx = -dx

    # reliability: peak prominence of the correlation surface, mapped to
    # a 0-100 scale calibrated so 60 == the AROSICS-default acceptance
    # boundary (see RELIABILITY_TAU above)
    mean = torch.mean(flat, dim=1)
    std = torch.std(flat, dim=1, correction=0) + 1e-12
    snr = (c0 - mean) / std
    reliability = 100.0 * (1.0 - torch.exp(-snr / RELIABILITY_TAU))
    return dy, dx, reliability


def estimate_shift(ref_img: np.ndarray, tgt_img: np.ndarray, device=None
                   ) -> Tuple[float, float, float]:
    """Single-pair convenience wrapper (``phasecorr.py:113``); returns
    (dy, dx, reliability)."""
    dy, dx, rel = phase_correlate_batch(
        np.asarray(ref_img, np.float32)[None],
        np.asarray(tgt_img, np.float32)[None], device=device)
    return float(dy[0]), float(dx[0]), float(rel[0])

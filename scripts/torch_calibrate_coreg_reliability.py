#!/usr/bin/env python3
"""Calibrate the phase-correlation reliability score on the PyTorch port,
the counterpart of ``scripts/calibrate_coreg_reliability.py``.

Sweeps synthetic tie-point windows over texture scale x noise level x
subpixel shift (plus the cross-resolution case: reference upsampled 6x
with the matching 1/6 low-pass), runs each cell's windows as one batch
through the port's ``phase_correlate_batch`` (``torch.fft``, cuFFT on the
card), and reports the SNR acceptance threshold: the smallest snr* such
that windows with snr >= snr* recover the shift to < 0.5 px with >= 99%
probability on the ensemble. The reliability mapping
``100 * (1 - exp(-snr / tau))`` puts ``min_reliability=60`` on snr* when
``tau = snr* / ln(100 / 40)``; the port gates every coregistration tie
point with the constant ``RELIABILITY_TAU`` (20.8), which this checks
against the port's own correlation surface.

The ensemble is the JAX script's, draw for draw: 256² windows from
``np.random.default_rng(0)``; same resolution, 4 texture scales x 6 noise
levels; cross resolution, 3 x 4 with 6x block-mean upsampling.

    python3 scripts/torch_calibrate_coreg_reliability.py [n_per_cell] [--device cpu]

``n_per_cell`` defaults to 8 (288 windows); the constant rests on 40
(1440 windows): ``python3 scripts/torch_calibrate_coreg_reliability.py 40``
on the card, ``--device cpu`` on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WIN = 256
SAME_CORR_LENS = (2.0, 6.0, 20.0, 60.0)
SAME_NOISES = (0.05, 0.3, 1.0, 3.0, 10.0, 30.0)
XRES_CORR_LENS = (6.0, 20.0, 60.0)
XRES_NOISES = (0.05, 0.3, 1.0, 3.0)
#: the cross-resolution case: EMIT 60 m against S2 10 m
XRES_FACTOR = 6
MAX_SHIFT_PX = 8
OK_ERR_PX = 0.5
OK_RATE = 0.99
MIN_ACCEPTED = 30
#: the reliability ``min_reliability`` (60) maps onto snr*
MIN_RELIABILITY = 60.0
THRESHOLDS = (2, 4, 6, 8, 10, 15, 20, 30, 50)


def smooth_texture(rng, n, corr_len):
    """Band-limited random texture with correlation length ~corr_len px
    (copy of ``scripts/calibrate_coreg_reliability.py:25``)."""
    white = rng.standard_normal((n, n)).astype(np.float32)
    f = np.fft.rfft2(white)
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    f *= np.exp(-((rad * corr_len) ** 2))
    img = np.fft.irfft2(f, s=(n, n))
    img -= img.mean()
    s = img.std()
    return img / (s if s > 0 else 1.0)


def subpixel_shift(img, dy, dx):
    """``img`` moved by (dy, dx) px through its spectrum (copy of
    ``scripts/calibrate_coreg_reliability.py:39``)."""
    f = np.fft.rfft2(img)
    n, m = img.shape
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(m)[None, :]
    return np.fft.irfft2(f * np.exp(-2j * np.pi * (fy * dy + fx * dx)),
                         s=(n, m)).astype(np.float32)


def block_mean(img, f):
    """Means of ``f`` x ``f`` blocks (copy of
    ``scripts/calibrate_coreg_reliability.py:48``)."""
    h, w = img.shape
    return img[:h - h % f, :w - w % f].reshape(
        h // f, f, w // f, f).mean(axis=(1, 3))


def ensemble(n_per: int):
    """The JAX script's cells in its order, each as ``(kind, corr_len,
    noise, refs (n_per, WIN, WIN) f32, tgts, true [(dy, dx)],
    lowpass_frac)``, drawn from one ``default_rng(0)`` in the script's
    order (``calibrate_coreg_reliability.py:62-108``)."""
    rng = np.random.default_rng(0)
    cells = ([("same", c, s) for c in SAME_CORR_LENS for s in SAME_NOISES]
             + [("xres", c, s) for c in XRES_CORR_LENS for s in XRES_NOISES])
    for kind, corr_len, noise in cells:
        refs, tgts, true = [], [], []
        for _ in range(n_per):
            img = smooth_texture(rng, WIN, corr_len)
            if kind == "same":
                ref = img
            else:
                coarse = block_mean(img, XRES_FACTOR)
                up = np.repeat(np.repeat(coarse, XRES_FACTOR, 0),
                               XRES_FACTOR, 1)[:WIN, :WIN]
                pad_h, pad_w = WIN - up.shape[0], WIN - up.shape[1]
                ref = np.pad(up, ((0, pad_h), (0, pad_w)), mode="edge")
            dy = rng.uniform(-MAX_SHIFT_PX, MAX_SHIFT_PX)
            dx = rng.uniform(-MAX_SHIFT_PX, MAX_SHIFT_PX)
            tgt = subpixel_shift(img, dy, dx)
            refs.append(ref + noise * rng.standard_normal((WIN, WIN)))
            tgts.append(tgt + noise * rng.standard_normal((WIN, WIN)))
            true.append((dy, dx))
        yield (kind, corr_len, noise,
               np.stack(refs).astype(np.float32),
               np.stack(tgts).astype(np.float32), true,
               1.0 if kind == "same" else 1.0 / XRES_FACTOR)


def window_rows(n_per: int = 8, device=None) -> list:
    """One row per window of ``ensemble(n_per)``, in order: its cell
    (``kind``, ``corr_len``, ``noise``), the true and recovered shift,
    the port's reliability and the shift error (px)."""
    from hyperres_torch.device import resolve_device
    from hyperres_torch.kernels.phasecorr import phase_correlate_batch

    dev = resolve_device(device)
    rows = []
    for kind, corr_len, noise, refs, tgts, true, lp in ensemble(n_per):
        got_dy, got_dx, rel = (t.cpu().numpy() for t in phase_correlate_batch(
            refs, tgts, lowpass_frac=lp, device=dev))
        for i, (dy, dx) in enumerate(true):
            rows.append({
                "kind": kind, "corr_len": corr_len, "noise": noise,
                "dy": dy, "dx": dx, "got_dy": float(got_dy[i]),
                "got_dx": float(got_dx[i]), "reliability": float(rel[i]),
                "err": float(np.hypot(float(got_dy[i]) - dy,
                                      float(got_dx[i]) - dx))})
    return rows


def window_snr(reliability, tau: float) -> np.ndarray:
    """The correlation SNR of each reliability under
    ``100 * (1 - exp(-snr / tau))``; the reliability clipped to
    [0, 99.999] first, as the JAX script does, so a saturated window stays
    finite."""
    rel = np.asarray(reliability, np.float64)
    return -tau * np.log1p(-np.clip(rel, 0, 99.999) / 100.0)


def calibrate(rows: list, tau: float) -> dict:
    """The JAX script's threshold search (``:110-139``) over ``rows``:
    ``snr_star`` is the first value of the rounded SNR grid whose accepted
    windows number >= MIN_ACCEPTED and recover the shift to < 0.5 px at
    >= 99 % (None if there is none), ``tau`` the constant that puts
    reliability 60 there; ``thresholds`` the table at THRESHOLDS."""
    err = np.array([r["err"] for r in rows])
    snr = window_snr([r["reliability"] for r in rows], tau)
    out = {"n_windows": len(rows), "ok_rate": float((err < OK_ERR_PX).mean()),
           "snr_star": None, "accept_rate": None, "ok_rate_at_star": None,
           "tau": None, "thresholds": []}
    for t in np.unique(np.round(np.sort(snr), 1)):
        sel = snr >= t
        if sel.sum() < MIN_ACCEPTED:
            break
        if (err[sel] < OK_ERR_PX).mean() >= OK_RATE:
            out.update(snr_star=float(t), accept_rate=float(sel.mean()),
                       ok_rate_at_star=float((err[sel] < OK_ERR_PX).mean()))
            break
    for t in THRESHOLDS:
        sel = snr >= t
        if sel.sum():
            out["thresholds"].append({
                "snr": t, "n": int(sel.sum()),
                "ok": float((err[sel] < OK_ERR_PX).mean()),
                "median_err": float(np.median(err[sel]))})
    if out["snr_star"] is not None:
        out["tau"] = float(out["snr_star"]
                           / np.log(100.0 / (100.0 - MIN_RELIABILITY)))
    return out


def main(argv=None) -> dict:
    """Prints the JAX script's lines (the overall rate, snr*, the
    threshold table, tau) and returns them as :func:`calibrate`'s dict."""
    from hyperres_torch.kernels.phasecorr import RELIABILITY_TAU

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_per_cell", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    res = calibrate(window_rows(args.n_per_cell, args.device),
                    RELIABILITY_TAU)
    print(f"{res['n_windows']} windows; err<0.5px overall: "
          f"{res['ok_rate']:.3f}")
    if res["snr_star"] is not None:
        print(f"snr* = {res['snr_star']:.2f}: accepts "
              f"{res['accept_rate']:.2%}, err<0.5px rate "
              f"{res['ok_rate_at_star']:.4f}")
    for t in res["thresholds"]:
        print(f"  snr>={t['snr']:>3}: n={t['n']:4d} ok={t['ok']:.4f} "
              f"median_err={t['median_err']:.4f}")
    if res["tau"] is not None:
        print(f"==> tau = snr*/ln(2.5) = {res['tau']:.3f} "
              f"(reliability 60 <=> snr {res['snr_star']:.2f})")
    return res


if __name__ == "__main__":
    main()

"""Optimal-transport colour matching, phase by phase
(``hyperres/fusion/ot.py:29-138``).

- :func:`ot_match_rgb_sinkhorn`: sample, Sinkhorn, barycentric
  projection, affine fit, apply and clip (s2_emit/color.py:65-116);
- :func:`fit_ot_affine` / :func:`apply_affine`: demo notebook cell 74;
- :func:`fit_ot_poly` / :func:`apply_poly`: s2_emit/poly_regression.py:
  16-84 and demo cell 81, with the identity fallback under
  ``min_pixels`` valid pixels (coefficients (C, deg+1), highest power
  first, the linear term 1).

NumPy in and out, as in the reference. Sampling runs on the host with
NumPy's generator, so both packages draw the same samples from the same
seed; the Sinkhorn plan, the barycentric targets and the fits run in
PyTorch on ``device`` (by default the current CUDA device; pass
``device="cpu"`` for the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import OTConfig

from ..device import resolve_device
from ..kernels.lstsq import affine_fit, polyfit, polyval_channels
from ..kernels.sinkhorn import ot_barycentric_targets
from .sampling import sample_valid_pixels_host

DeviceLike = Union[str, torch.device, None]


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _sample_pair(src_rgb, ref_rgb, mask, n_samples, seed):
    rng = np.random.default_rng(seed)
    X = sample_valid_pixels_host(np.asarray(src_rgb), np.asarray(mask),
                                 n_samples, rng=rng)
    Y = sample_valid_pixels_host(np.asarray(ref_rgb), np.asarray(mask),
                                 n_samples, rng=rng)
    return X, Y


def _barycentric(X: np.ndarray, Y: np.ndarray, cfg: OTConfig,
                 device: torch.device) -> np.ndarray:
    Ybar = ot_barycentric_targets(
        _f32(X, device), _f32(Y, device), reg=cfg.reg,
        num_itermax=cfg.num_itermax, stop_thr=cfg.stop_thr,
        debias=cfg.debias)
    return Ybar.cpu().numpy().astype(np.float64)


def _affine(X: np.ndarray, Ybar: np.ndarray, device: torch.device):
    A, t = affine_fit(_f32(X, device), _f32(Ybar, device))
    return (A.cpu().numpy().astype(np.float64),
            t.cpu().numpy().astype(np.float64))


def fit_ot_affine(src_rgb: np.ndarray, ref_rgb: np.ndarray,
                  mask: np.ndarray, cfg: OTConfig = OTConfig(),
                  device: DeviceLike = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(A (C, C), t (C,)) via OT barycentric targets + least squares
    (demo cell 74). Identity under 2 valid pixels."""
    X, Y = _sample_pair(src_rgb, ref_rgb, mask, cfg.n_samples, cfg.seed)
    c = src_rgb.shape[-1]
    if X.shape[0] < 2 or Y.shape[0] < 2:
        return np.eye(c, dtype=np.float64), np.zeros(c, dtype=np.float64)
    dev = resolve_device(device)
    return _affine(X, _barycentric(X, Y, cfg, dev), dev)


def apply_affine(rgb: np.ndarray, A: np.ndarray, t: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> np.ndarray:
    """rgb' = rgb @ A + t, clipped to [0, 1]; outside-mask pixels kept
    (demo cell 74). In float64 on the host, as the reference."""
    out = np.asarray(rgb, dtype=np.float32).copy()
    if mask is None:
        Y = out.reshape(-1, out.shape[-1]).astype(np.float64) @ A + t
        return np.clip(Y, 0, 1).reshape(out.shape).astype(np.float32)
    X = out[mask].reshape(-1, out.shape[-1]).astype(np.float64)
    Y = np.clip(X @ A + t, 0, 1)
    out[mask] = Y.reshape(out[mask].shape).astype(np.float32)
    return out


def ot_match_rgb_sinkhorn(src_rgb: np.ndarray, ref_rgb: np.ndarray,
                          mask: np.ndarray, n_samples: int = 5000,
                          reg: float = 0.05, num_itermax: int = 300,
                          stop_thr: float = 1e-6, seed: int = 0,
                          device: DeviceLike = None) -> np.ndarray:
    """Full OT colour transfer (color.py:65-116): ``src_rgb`` with the
    masked pixels affinely mapped toward ``ref_rgb``'s distribution,
    clipped to [0, 1]. An unchanged copy under 2 valid pixels."""
    cfg = OTConfig(n_samples=n_samples, reg=reg, num_itermax=num_itermax,
                   stop_thr=stop_thr, seed=seed)
    X, Y = _sample_pair(src_rgb, ref_rgb, mask, cfg.n_samples, cfg.seed)
    if X.shape[0] < 2 or Y.shape[0] < 2:
        return np.asarray(src_rgb).copy()
    dev = resolve_device(device)
    A, t = _affine(X, _barycentric(X, Y, cfg, dev), dev)
    return apply_affine(src_rgb, A, t, mask)


def fit_ot_poly(src_rgb: np.ndarray, ref_rgb: np.ndarray, mask: np.ndarray,
                deg: int = 2, cfg: OTConfig = OTConfig(),
                min_pixels: int = 200, device: DeviceLike = None
                ) -> np.ndarray:
    """Per-channel polynomial coefficients (C, deg+1), highest power
    first, fitted on OT barycentric targets (poly_regression.py:16-62)."""
    c = src_rgb.shape[-1]
    X, Y = _sample_pair(src_rgb, ref_rgb, mask, cfg.n_samples, cfg.seed)
    if X.shape[0] < min_pixels or Y.shape[0] < min_pixels:
        coeffs = np.zeros((c, deg + 1), dtype=np.float64)
        coeffs[:, -2] = 1.0  # identity fallback (poly_regression.py:38-41)
        return coeffs
    dev = resolve_device(device)
    Ybar = _barycentric(X, Y, cfg, dev)
    Xt, Yt = _f32(X, dev), _f32(Ybar, dev)
    return np.stack([polyfit(Xt[:, ch], Yt[:, ch], deg).cpu().numpy()
                     for ch in range(c)]).astype(np.float64)


def apply_poly(rgb: np.ndarray, coeffs: np.ndarray,
               mask: Optional[np.ndarray] = None,
               device: DeviceLike = None) -> np.ndarray:
    """Per-channel polynomial applied in f32, clipped to [0, 1]; only
    masked pixels are replaced when a mask is given
    (poly_regression.py:65-84)."""
    dev = resolve_device(device)
    out = np.asarray(rgb, dtype=np.float32).copy()
    mapped = polyval_channels(_f32(coeffs, dev), _f32(out, dev)).cpu().numpy()
    if mask is None:
        return np.clip(mapped, 0.0, 1.0)
    out[mask] = mapped[mask]
    return np.clip(out, 0.0, 1.0)

"""Per-band linear calibration (pseudo -> real), demo cells 65/72
(``hyperres/fusion/linear.py``)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.lstsq import linear_fit_masked


def calibrate_linear(
    pseudo_stack: np.ndarray,
    real_stack: np.ndarray,
    valid_mask: np.ndarray,
    min_valid: float = 0.0,
    min_count: int = 50,
    device=None,
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Fit per-band y = a*x + b mapping pseudo -> real on valid pixels and
    return (corrected stack (B, H, W) float32, [(a, b), ...]).

    Reference semantics (demo cell 72): validity requires the shared mask,
    finite x and y, and x, y > min_valid; identity fallback below
    ``min_count`` samples. The correction is applied to *all* pixels.
    The sums run in f32 on ``device`` (default the current CUDA
    device)."""
    dev = resolve_device(device)
    pseudo = np.asarray(pseudo_stack, dtype=np.float32)
    real = np.asarray(real_stack, dtype=np.float32)
    corrected = np.zeros_like(pseudo)
    params: List[Tuple[float, float]] = []
    for k in range(pseudo.shape[0]):
        x = pseudo[k]
        y = real[k]
        vk = (np.asarray(valid_mask, dtype=bool)
              & np.isfinite(x) & np.isfinite(y)
              & (x > min_valid) & (y > min_valid))
        a, b = linear_fit_masked(
            torch.from_numpy(x.ravel()).to(dev),
            torch.from_numpy(y.ravel()).to(dev),
            torch.from_numpy(vk.ravel()).to(dev), min_count=min_count)
        a, b = float(a), float(b)
        corrected[k] = (x * a + b).astype(np.float32)
        params.append((a, b))
    return corrected, params

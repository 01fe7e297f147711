"""Polynomial fit and evaluation (``hyperres/kernels/lstsq.py:30-64``):
np.polyfit / np.polyval semantics, coefficients highest power first.
The fit is QR plus a triangular solve in f32 (not the normal
equations), so degree-4 Vandermonde systems stay well conditioned.
"""

from __future__ import annotations

from typing import Optional

import torch


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for an integer n >= 0 by square-and-multiply, the
    multiplication order of the reference's ``x ** n``."""
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


def polyfit(x: torch.Tensor, y: torch.Tensor, deg: int,
            w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Least-squares polynomial fit -> (deg + 1,) coefficients. ``w``
    are 0/1 sample weights that exclude masked points at a fixed
    shape."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    V = torch.stack([_ipow(x, deg - k) for k in range(deg + 1)], dim=1)
    if w is not None:
        sw = torch.sqrt(w.to(torch.float32))
        V = V * sw[:, None]
        y = y * sw
    Q, R = torch.linalg.qr(V)
    return torch.linalg.solve_triangular(R, (Q.T @ y)[:, None],
                                         upper=True)[:, 0]


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation, coefficients highest power first."""
    out = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


def polyval_channels(coeffs: torch.Tensor, img: torch.Tensor
                     ) -> torch.Tensor:
    """coeffs (C, deg+1), img (..., C) -> (..., C)."""
    return torch.stack([polyval(coeffs[c], img[..., c])
                        for c in range(img.shape[-1])], dim=-1)

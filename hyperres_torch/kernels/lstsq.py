"""Least squares, polynomial features and ridge regression
(``hyperres/kernels/lstsq.py``).

- Polynomial fit and evaluation (``:30-64``): np.polyfit / np.polyval
  semantics, coefficients highest power first. The fit is QR plus a
  triangular solve in f32 (not the normal equations), so degree-4
  Vandermonde systems stay well conditioned.
- The affine fit (``:99-105``) by an SVD least squares that follows
  ``jnp.linalg.lstsq``.
- Multivariate monomial expansion (``:166``) as ``degree`` gathered
  column products, over the factor table of
  :func:`~hyperres_torch.kernels.host.poly_factor_indices`.
- The ridge solve (``:192``), the logit / sigmoid pair (``:251-260``)
  and the per-band R^2 / RMSE (``:231``) of the spectral-SR model.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .host import poly_factor_indices


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


def lstsq(A: torch.Tensor, B: torch.Tensor,
          rcond: Optional[float] = None) -> torch.Tensor:
    """Least squares ``A X ~ B`` by SVD, as ``jnp.linalg.lstsq``:
    singular values that are zero or below ``rcond * s_max`` (default
    ``eps * max(A.shape)``) are dropped, so a rank-deficient ``A`` gives
    the finite minimum-norm solution on every device
    (``torch.linalg.lstsq`` on CUDA is ``gels``, which assumes full
    rank)."""
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(A.shape)
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = (S > 0) & (S >= rcond * S[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    return Vh.T @ (s_inv[:, None] * (U.T @ B))


def affine_fit(X: torch.Tensor, Y: torch.Tensor,
               w: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares affine map ``Y ~ X @ A + t`` -> (A (d, d), t (d,))
    through the augmented system (``lstsq.py:99-105``). ``w`` are 0/1 row
    weights that exclude padded sample slots (``fused.py:113-124``)."""
    n = X.shape[0]
    Xa = torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=X.device)],
                   dim=1)
    if w is not None:
        sw = torch.sqrt(torch.clamp(w.to(X.dtype), min=0.0))[:, None]
        Xa = Xa * sw
        Y = Y * sw
    W = lstsq(Xa, Y)
    return W[:-1, :], W[-1, :]


def poly_expand(X: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., F) monomials: column m is the product of the
    ``degree`` columns ``factors[m, :]`` of [1, x_0, ..., x_{n-1}]
    (``factors`` (F, degree) integer, on X's device), multiplied left
    to right."""
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    X_ext = torch.cat([ones, X], dim=-1)
    idx = factors.to(torch.int64)
    out = X_ext[..., idx[:, 0]]
    for d in range(1, idx.shape[1]):
        out = out * X_ext[..., idx[:, d]]
    return out


def make_poly_expander(n_features: int, degree: int,
                       include_bias: bool = False
                       ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                                  int]:
    """Returns (expand, F): ``expand`` maps (N, n_features) -> (N, F)
    in sklearn's monomial order, as ``degree`` gathered-column
    products."""
    factor_idx = torch.from_numpy(
        poly_factor_indices(n_features, degree, include_bias))
    on_device: Dict[torch.device, torch.Tensor] = {}

    def expand(X: torch.Tensor) -> torch.Tensor:
        idx = on_device.get(X.device)
        if idx is None:
            idx = on_device[X.device] = factor_idx.to(X.device)
        return poly_expand(X, idx)

    return expand, factor_idx.shape[0]


def ridge_solve(XtX: torch.Tensor, XtY: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """Solve (XtX + alpha I) W = XtY by Cholesky."""
    k = XtX.shape[0]
    A = XtX + alpha * torch.eye(k, dtype=XtX.dtype, device=XtX.device)
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(XtY, L)


def r2_rmse_per_band(y_true: torch.Tensor, y_pred: torch.Tensor,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-band R^2 and RMSE over (N, B) tensors, over ``valid`` (by
    default where both are finite)."""
    if valid is None:
        valid = torch.isfinite(y_true) & torch.isfinite(y_pred)
    w = valid.to(torch.float32)
    n = torch.sum(w, dim=0)
    zero = torch.zeros((), dtype=y_true.dtype, device=y_true.device)
    yt = torch.where(valid, y_true, zero)
    yp = torch.where(valid, y_pred, zero)
    mean = torch.sum(yt, dim=0) / torch.clamp(n, min=1.0)
    ss_res = torch.sum(w * (yt - yp) ** 2, dim=0)
    ss_tot = torch.sum(w * (yt - mean[None, :]) ** 2, dim=0) + 1e-8
    r2 = 1.0 - ss_res / ss_tot
    rmse = torch.sqrt(ss_res / torch.clamp(n, min=1.0))
    return r2, rmse


def logit(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def sigmoid(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, -50.0, 50.0)
    return 1.0 / (1.0 + torch.exp(-z))

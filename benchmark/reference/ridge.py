"""Plain reference of the 10 m spectral-SR product, in PyTorch.

The model (``legacy_notebooks/Spectral_matching.ipynb`` cells 14-27 of
martasumyk/hyperspectral_super-resolution, sklearn's ``StandardScaler ->
PolynomialFeatures(degree, include_bias=False) -> Ridge(alpha)`` on the
logit of the target, sigmoid at inference):

- fit, in float64 (the control: float32): the biased standardisation of X, every monomial of
  total degree 1 .. degree in sklearn's order, the logit of Y clipped to
  [eps, 1 - eps], ridge with an unpenalised intercept (centred normal
  equations plus alpha I); the parameters are kept in float32;
- the u16 product, in float32: a pixel is valid when all its bands are
  finite and none is within 1e-8 + 1e-5 |nodata| of ``nodata``;
  ``clip(rint(sigmoid(clip(F W + b, -50, 50)) * 1e4), 0, 65534)``,
  65535 where not valid; (By, H, W) from (Bx, H, W).

Nothing here imports the program. The matrix product follows
``torch.backends.cuda.matmul.allow_tf32`` (see ``granule.precision``).
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Dict, List

import torch


def monomial_index(n_features: int, degree: int) -> List[tuple]:
    return [c for d in range(1, degree + 1)
            for c in combinations_with_replacement(range(n_features), d)]


def monomials(Z: torch.Tensor, combos: List[tuple]) -> torch.Tensor:
    return torch.stack([torch.prod(Z[:, list(c)], dim=1) for c in combos],
                       dim=1)


def fit(X: torch.Tensor, Y: torch.Tensor, degree: int, alpha: float,
        eps: float, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """The four parameters: ``x_mean``, ``x_std`` (Bx,), ``W`` (F, By),
    ``intercept`` (By,), float32; computed in ``dtype``."""
    Xd = X.to(dtype)
    mean = Xd.mean(dim=0)
    std = torch.sqrt(((Xd - mean) ** 2).mean(dim=0)) + 1e-12
    F = monomials((Xd - mean) / std, monomial_index(X.shape[1], degree))
    Yc = Y.to(dtype).clamp(eps, 1.0 - eps)
    T = torch.log(Yc / (1.0 - Yc))
    fm, tm = F.mean(dim=0), T.mean(dim=0)
    Fc, Tc = F - fm, T - tm
    A = Fc.T @ Fc + alpha * torch.eye(F.shape[1], dtype=dtype,
                                      device=F.device)
    W = torch.linalg.solve(A, Fc.T @ Tc)
    return {"x_mean": mean.float(), "x_std": std.float(), "W": W.float(),
            "intercept": (tm - fm @ W).float()}


def predict_u16_block(Xb: torch.Tensor, p: Dict[str, torch.Tensor],
                      combos: List[tuple], nodata: float) -> torch.Tensor:
    """Codes of pixels Xb (n, Bx) -> (n, By) int32."""
    ok = torch.isfinite(Xb).all(dim=1)
    tol = 1e-8 + 1e-5 * abs(nodata)
    ok &= ~((Xb.double() - nodata).abs() <= tol).any(dim=1)
    Xs = torch.nan_to_num(Xb)
    z = monomials((Xs - p["x_mean"]) / p["x_std"], combos) @ p["W"] \
        + p["intercept"]
    y = 1.0 / (1.0 + torch.exp(-torch.clamp(z, -50.0, 50.0)))
    q = torch.clamp(torch.round(y * 10000.0), 0.0, 65534.0).to(torch.int32)
    return torch.where(ok[:, None], q, 65535)

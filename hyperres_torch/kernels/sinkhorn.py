"""Entropic optimal transport, log-domain Sinkhorn
(``hyperres/kernels/sinkhorn.py:25-169``).

Two engines, as in the reference's ``ot_barycentric_targets``:

- ``"xla"`` (and ``"auto"``, the default): :func:`sinkhorn_log` in plain
  PyTorch. Stopping rule as the reference's ``sinkhorn_log``: every
  ``check_every`` iterations the column-marginal L1 violation after the
  g-update is compared with ``stop_thr``, up to ``num_itermax``.
- ``"pallas"``: the hand-written duals kernel
  (:mod:`.sinkhorn_duals`), which stops on the row marginal of the
  previous iterate, where the padded cost matrix fits the reference's
  budget; larger shapes take ``"xla"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import sinkhorn_duals as _duals

ENGINES = ("auto", "xla", "pallas")


def sqeuclidean_cdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (n, d) x (m, d) -> (n, m),
    as ||x||^2 + ||y||^2 - 2 x.y clamped at 0."""
    xx = torch.sum(X * X, dim=1, keepdim=True)
    yy = torch.sum(Y * Y, dim=1, keepdim=True)
    cross = X @ Y.T
    return torch.clamp(xx + yy.T - 2.0 * cross, min=0.0)


def sinkhorn_log(a: torch.Tensor, b: torch.Tensor, M: torch.Tensor,
                 reg: float, num_itermax: int = 300,
                 stop_thr: float = 1e-6, check_every: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn. Returns (P, err): the transport plan with
    marginals ~(a, b) and the last column-marginal violation."""
    log_a = torch.log(a)
    log_b = torch.log(b)
    Mr = -M / reg
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)
    err = torch.tensor(float("inf"), device=M.device)
    i = 0
    while i < num_itermax and bool(err > stop_thr):
        for _ in range(check_every):
            f = f + log_a - torch.logsumexp(Mr + f[:, None] + g[None, :],
                                            dim=1)
            g = g + log_b - torch.logsumexp(Mr + f[:, None] + g[None, :],
                                            dim=0)
        col = torch.exp(torch.logsumexp(Mr + f[:, None] + g[None, :],
                                        dim=0))
        err = torch.sum(torch.abs(col - b))
        i += check_every
    P = torch.exp(Mr + f[:, None] + g[None, :])
    return P, err


def barycentric_map(P: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Row-normalised barycentric projection (P @ Y) / rowsum."""
    row_sum = torch.sum(P, dim=1, keepdim=True) + 1e-32
    return (P @ Y) / row_sum


def marginal(w: Optional[torch.Tensor], n: int,
             device: torch.device) -> torch.Tensor:
    """The OT marginal of n sample slots: uniform, or the 0/1 slot
    weights ``w`` floored at 1e-12 and normalised."""
    if w is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    aw = torch.clamp(w.to(torch.float32), min=1e-12)
    return aw / torch.sum(aw)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ot_barycentric_targets(X: torch.Tensor, Y: torch.Tensor,
                           reg: float = 0.05, num_itermax: int = 300,
                           stop_thr: float = 1e-6,
                           wx: Optional[torch.Tensor] = None,
                           wy: Optional[torch.Tensor] = None,
                           engine: str = "auto",
                           debias: bool = False) -> torch.Tensor:
    """Sinkhorn between samples X (n, d) and Y (m, d), then the
    barycentric target of each X row. ``wx``/``wy`` are optional 0/1
    slot weights from the fixed-shape sampler: zero-weight rows get a
    vanishing mass and their values are zeroed. ``engine`` picks the
    Sinkhorn (module docstring): ``"pallas"`` takes the duals kernel
    when ``round_up(n, 128) * round_up(m, 128) * 4`` bytes fit
    ``PALLAS_SINKHORN_VMEM_BUDGET`` (the reference's rule, by shape
    alone) and builds ``P = exp(Mr + f + g)`` from its duals.
    ``debias=True`` adds the self-transport correction
    T_XY(x) + (x - T_XX(x)), whose Sinkhorn is always ``sinkhorn_log``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {ENGINES})")
    if wx is not None:
        X = torch.where(wx[:, None] > 0, X, torch.zeros((), device=X.device))
    if wy is not None:
        Y = torch.where(wy[:, None] > 0, Y, torch.zeros((), device=Y.device))
    a = marginal(wx, X.shape[0], X.device)
    b = marginal(wy, Y.shape[0], Y.device)
    M = sqeuclidean_cdist(X, Y)
    n, m = M.shape
    if (engine == "pallas" and _round_up(n, 128) * _round_up(m, 128) * 4
            <= _duals.PALLAS_SINKHORN_VMEM_BUDGET):
        Mr = -M / reg
        f, g, _ = _duals.sinkhorn_duals(torch.log(a), torch.log(b), Mr,
                                        num_itermax=num_itermax,
                                        stop_thr=stop_thr)
        P = torch.exp(Mr + f[:, None] + g[None, :])
    else:
        P, _ = sinkhorn_log(a, b, M, reg, num_itermax=num_itermax,
                            stop_thr=stop_thr)
    T_xy = barycentric_map(P, Y)
    if not debias:
        return T_xy
    Pxx, _ = sinkhorn_log(a, a, sqeuclidean_cdist(X, X), reg,
                          num_itermax=num_itermax, stop_thr=stop_thr)
    return T_xy + (X - barycentric_map(Pxx, X))

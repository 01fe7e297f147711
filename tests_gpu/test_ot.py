"""The Sinkhorn-duals kernel (``csrc/sinkhorn_duals.cu``) on the card
against its plain version: the one-pass route, the long-rows route and
the two-read kernels. Moved from tests/test_torch_ot.py, whose CPU tests
hold the plain version to ``pallas_sinkhorn_duals``; the costs are built
by the port's ``sqeuclidean_cdist`` (held to the reference's there)."""

import numpy as np
import pytest
import torch

from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import sinkhorn as tsink
from hyperres_torch.kernels import sinkhorn_duals as tduals

T = torch.from_numpy


def _cost(rng, n, m, reg=0.05):
    X = rng.normal(0.45, 0.2, (n, 3)).astype(np.float32)
    Y = rng.normal(0.55, 0.18, (m, 3)).astype(np.float32)
    M = tsink.sqeuclidean_cdist(T(X), T(Y)).numpy()
    return (-M / np.float32(reg)).astype(np.float32)


def _check_against_plain(la, lb, Mr, sweeps, name):
    """Two kernel runs of ``sweeps`` sweeps (bit-equal, ``sweeps / 10``
    launches each under ``name`` alone) against the plain version: P =
    exp(Mr + f + g) to 1e-5 of its largest entry and f, g to 1e-4 (both
    sum f32 exps in their own fixed orders), err to 10 % plus 1e-8 (near
    convergence err is rounding noise)."""
    reset_launch_counts()
    f, g, err = tduals.sinkhorn_duals(la, lb, Mr, sweeps, 0.0)
    f2, g2, _ = tduals.sinkhorn_duals(la, lb, Mr, sweeps, 0.0)
    assert launch_counts == {name: 2 * sweeps // 10}
    assert torch.equal(f, f2) and torch.equal(g, g2)
    rf, rg, rerr = tduals.sinkhorn_duals_reference(la, lb, Mr, sweeps, 0.0)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    dP = (P - torch.exp(Mr + rf[:, None] + rg[None, :])).abs().max()
    assert float(dP) <= 1e-5 * float(P.max())
    torch.testing.assert_close(f, rf, rtol=0, atol=1e-4)
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-4)
    assert (abs(float(err) - float(rerr))
            <= 0.1 * max(float(err), float(rerr)) + 1e-8)


def _uniform(n, m, dev):
    return (torch.full((n,), -np.log(float(n)), device=dev),
            torch.full((m,), -np.log(float(m)), device=dev))


@pytest.mark.gpu
def test_sinkhorn_duals_kernel_matches_plain_on_gpu(cuda_device, rng):
    """The one-pass route == its plain version on the card at 1000 x
    1200, 60 sweeps, with the bounds of ``_check_against_plain``; each
    group of 10 sweeps counts one launch."""
    Mr = T(_cost(rng, 1000, 1200)).to(cuda_device)
    _check_against_plain(*_uniform(1000, 1200, cuda_device), Mr, 60,
                         tduals.KERNEL_NAME)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(64, 7001), (37, 6145)])
def test_sinkhorn_long_rows_kernel_matches_plain_on_gpu(cuda_device, rng,
                                                        n, m):
    """The long-rows route (m > ONE_PASS_COLS; m odd, so rows are not
    16-byte aligned) against the plain version at 60 sweeps, with the
    bounds of the one-pass test; two runs give the same bits; each group
    of 10 sweeps counts one launch of the long-rows counter alone."""
    Mr = T(_cost(rng, n, m)).to(cuda_device)
    _check_against_plain(*_uniform(n, m, cuda_device), Mr, 60,
                         tduals.LONG_ROWS_NAME)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(128, 100_000), (1024, 20_000), (8, 6400)])
def test_sliced_long_rows_on_gpu(cuda_device, rng, n, m):
    """The sliced long-rows kernels at the full-scale long-rows shapes (m a
    multiple of 4: the 16-byte loads; one chunk, four chunks, eight)
    against the plain version at 50 sweeps with the bounds of the one-pass
    test; two runs bit-equal; the two-read kernels, forced, agree with
    the plain version too and count under their own name."""
    Mr = T(_cost(rng, n, m)).to(cuda_device)
    la, lb = _uniform(n, m, cuda_device)
    rf, rg, _ = tduals.sinkhorn_duals_reference(la, lb, Mr, 50, 0.0)
    Pr = torch.exp(Mr + rf[:, None] + rg[None, :])
    reset_launch_counts()
    f, g, _ = tduals.sinkhorn_duals(la, lb, Mr, 50, 0.0)
    f2, g2, _ = tduals.sinkhorn_duals(la, lb, Mr, 50, 0.0)
    assert launch_counts == {tduals.LONG_ROWS_NAME: 10}
    assert torch.equal(f, f2) and torch.equal(g, g2)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    assert float((P - Pr).abs().max()) <= 1e-5 * float(Pr.max())
    rule = tduals.sinkhorn_route
    tduals.sinkhorn_route = lambda *shape: tduals.Route(tduals.TWO_READ)
    try:
        reset_launch_counts()
        f, g, _ = tduals.sinkhorn_duals(la, lb, Mr, 50, 0.0)
    finally:
        tduals.sinkhorn_route = rule
    assert launch_counts == {tduals.TWO_READ_NAME: 5}
    P = torch.exp(Mr + f[:, None] + g[None, :])
    assert float((P - Pr).abs().max()) <= 1e-5 * float(Pr.max())

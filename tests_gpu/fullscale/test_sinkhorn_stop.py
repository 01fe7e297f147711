"""The Sinkhorn-duals kernel (``csrc/sinkhorn_duals.cu``) against its
plain version under the plan's own ``OTConfig`` (the defaults), at a
fixed sweep count and with the config's stop rule: the one-pass route at
5000 x 5000 on the full-scale scene's stretched 60 m OT samples, with both
``ot_barycentric_targets`` engines; the long-rows route at each of
SINKHORN_LONG_ROWS_SHAPES on seeded samples; and the stop rule where it is
fragile."""

import numpy as np
import pytest
import torch

from card_inputs import SINKHORN_LONG_ROWS_SEED, SINKHORN_P_RTOL, counted
from hyperres_torch.kernels import sinkhorn_duals as sd
from hyperres_torch.kernels.sinkhorn import (
    marginal, ot_barycentric_targets, sqeuclidean_cdist,
)

pytestmark = pytest.mark.gpu

#: kernel vs plain at 5000 x 5000: max |dP| / max P within SINKHORN_P_RTOL,
#: and max |df|, |dg| (~25 ulp of duals of magnitude ~30)
SINKHORN_FG_TOL = 1e-4
#: kernel vs plain, the row-marginal err: near convergence it is rounding
#: noise of the two orders (measured on an H100: 6.9e-9 / 1.2e-8 at 300
#: sweeps, 6.9e-7 / 7.4e-7 at the stop), so |dErr| <= RTOL * err + ATOL
SINKHORN_ERR_RTOL = 0.1
SINKHORN_ERR_ATOL = 1e-8
#: engine="pallas" vs engine="xla" targets at an equal sweep count: the
#: reference's bound for its two engines (tests/test_kernels_ot_lstsq.py:120)
ENGINE_TOL = 5e-5
#: the long-rows route's checks: columns past the one-pass limit, inside
#: the engine budget; few rows (the kernel table's row) and more
SINKHORN_LONG_ROWS_SHAPES = ((128, 100_000), (1024, 20_000))
#: the fragile case is kept as a check of its own at 128 x 100,000: with seed
#: 11 the stop rule may split by one group of sweeps, which stop_rule accepts
#: only this close to stop_thr
SINKHORN_FRAGILE_SEED = 11
SINKHORN_CHECK_EVERY = 10
SINKHORN_STOP_MARGIN = 0.05
#: their err bound's floor: each row sums up to 100,000 exps, in slices,
#: so near convergence err is rounding noise of a few 1e-7 (measured on
#: an H100 at 300 sweeps at 128 x 100,000: 5.4e-7 kernel, 6.9e-7 plain)
SINKHORN_LONG_ROWS_ERR_ATOL = 3e-7


def err_close(kerr, perr, atol) -> bool:
    kerr, perr = float(kerr), float(perr)
    return abs(kerr - perr) <= SINKHORN_ERR_RTOL * max(kerr, perr) + atol


def fixed_count(la, lb, Mr, ot, name, atol):
    """The route counted as ``name`` against its plain version at
    ``ot.num_itermax`` sweeps: P = exp(Mr + f + g) within SINKHORN_P_RTOL
    of its largest entry, f and g within SINKHORN_FG_TOL, err within
    SINKHORN_ERR_RTOL / ``atol``, two kernel runs bit-equal, only
    ``name`` launched."""
    fixed = (ot.num_itermax, 0.0)
    (f, g, err), counts = counted(lambda: sd.sinkhorn_duals(la, lb, Mr,
                                                            *fixed))
    f2, g2, _ = sd.sinkhorn_duals(la, lb, Mr, *fixed)
    assert set(counts) == {name}, counts
    rf, rg, rerr = sd.sinkhorn_duals_reference(la, lb, Mr, *fixed)
    P = torch.exp(Mr + f[:, None] + g[None, :])
    p_err = float((P - torch.exp(Mr + rf[:, None] + rg[None, :])).abs().max())
    assert p_err <= SINKHORN_P_RTOL * float(P.max()), p_err
    del P
    assert max(float((f - rf).abs().max()),
               float((g - rg).abs().max())) <= SINKHORN_FG_TOL
    assert err_close(err, rerr, atol), (float(err), float(rerr))
    assert torch.equal(f, f2) and torch.equal(g, g2)


def stop_rule(la, lb, Mr, ot, atol):
    """The kernel against its plain version under the config's stop rule:
    the same sweep count, and err within SINKHORN_ERR_RTOL / ``atol``. The
    counts may differ by one group of SINKHORN_CHECK_EVERY sweeps only
    where the plain version's err at the earlier of the two checks lies
    within SINKHORN_STOP_MARGIN of ``stop_thr`` (two versions of the
    arithmetic then fall on either side of it); the errs are then
    compared at the later count."""
    every = SINKHORN_CHECK_EVERY
    rule = (ot.num_itermax, ot.stop_thr, every)
    *_, kerr, ksw = sd.sinkhorn_duals(la, lb, Mr, *rule, return_sweeps=True)
    *_, perr, psw = sd.sinkhorn_duals_reference(la, lb, Mr, *rule,
                                                return_sweeps=True)
    if ksw != psw:
        early, late = sorted((ksw, psw))
        *_, at_early = sd.sinkhorn_duals_reference(la, lb, Mr, early, 0.0,
                                                   every)
        off = abs(float(at_early) - ot.stop_thr) / ot.stop_thr
        assert late - early == every and off <= SINKHORN_STOP_MARGIN, (
            ksw, psw, off)
        *_, kerr = sd.sinkhorn_duals(la, lb, Mr, late, 0.0, every)
        *_, perr = sd.sinkhorn_duals_reference(la, lb, Mr, late, 0.0, every)
    assert err_close(kerr, perr, atol), (float(kerr), float(perr))


def duals_inputs(Xs, Ys, ot, wx=None, wy=None):
    n, m, dev = Xs.shape[0], Ys.shape[0], Xs.device
    return (torch.log(marginal(wx, n, dev)), torch.log(marginal(wy, m, dev)),
            -sqeuclidean_cdist(Xs, Ys) / ot.reg)


def seeded_samples(dev, n, m, seed):
    """Seeded RGB samples in [0, 1): (n, 3) and (m, 3) on ``dev``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random((k, 3), dtype=np.float32))
                 .to(dev) for k in (n, m))


def test_one_pass_route_and_engines(bench):
    """At 5000 x 5000 on the plan's OT samples and slot weights: the
    one-pass route's fixed-count checks and stop rule;
    ``ot_barycentric_targets(engine="pallas")`` launches the one-pass
    kernel and nothing else, and agrees with ``engine="xla"`` at an
    equal sweep count within ENGINE_TOL."""
    plan = bench.plan
    ot = plan.statics.ot
    utm = plan.warp(bench.raw)
    Xs, wxs, Ys, wys = plan.ot_samples(utm, bench.s2, plan.generator(0))
    del utm
    la, lb, Mr = duals_inputs(Xs, Ys, ot, wxs, wys)
    fixed_count(la, lb, Mr, ot, sd.KERNEL_NAME, SINKHORN_ERR_ATOL)
    stop_rule(la, lb, Mr, ot, SINKHORN_ERR_ATOL)
    kw = dict(reg=ot.reg, wx=wxs, wy=wys, num_itermax=ot.num_itermax)
    _, counts = counted(lambda: ot_barycentric_targets(
        Xs, Ys, stop_thr=ot.stop_thr, engine="pallas", **kw))
    assert counts.get(sd.KERNEL_NAME, 0) >= 1, counts
    assert set(counts) == {sd.KERNEL_NAME}, counts
    eng = [ot_barycentric_targets(Xs, Ys, stop_thr=0.0, engine=e, **kw)
           for e in ("pallas", "xla")]
    assert float((eng[0] - eng[1]).abs().max()) <= ENGINE_TOL


@pytest.mark.parametrize("n,m", SINKHORN_LONG_ROWS_SHAPES)
def test_long_rows_route(card, bench, n, m):
    """The long-rows route (column slices) on seeded samples at n x m,
    uniform marginals, the plan's ``OTConfig``:
    ``ot_barycentric_targets(engine="pallas")`` launches the long-rows
    kernels and nothing else, to finite targets; then the fixed-count
    checks (err's floor SINKHORN_LONG_ROWS_ERR_ATOL) and the stop rule."""
    ot = bench.plan.statics.ot
    Xs, Ys = seeded_samples(card, n, m, SINKHORN_LONG_ROWS_SEED)
    targets, counts = counted(lambda: ot_barycentric_targets(
        Xs, Ys, reg=ot.reg, num_itermax=ot.num_itermax,
        stop_thr=ot.stop_thr, engine="pallas"))
    assert counts.get(sd.LONG_ROWS_NAME, 0) >= 1, counts
    assert set(counts) == {sd.LONG_ROWS_NAME}, counts
    assert bool(torch.isfinite(targets).all())
    la, lb, Mr = duals_inputs(Xs, Ys, ot)
    fixed_count(la, lb, Mr, ot, sd.LONG_ROWS_NAME,
                SINKHORN_LONG_ROWS_ERR_ATOL)
    stop_rule(la, lb, Mr, ot, SINKHORN_LONG_ROWS_ERR_ATOL)


def test_fragile_stop(card, bench):
    """The long-rows route's stop rule where it is fragile: the first of
    SINKHORN_LONG_ROWS_SHAPES with SINKHORN_FRAGILE_SEED, whose err at
    sweep 50 lies ~1 % under stop_thr in the plain version: ``stop_rule``
    holds there too."""
    ot = bench.plan.statics.ot
    Xs, Ys = seeded_samples(card, *SINKHORN_LONG_ROWS_SHAPES[0],
                            SINKHORN_FRAGILE_SEED)
    stop_rule(*duals_inputs(Xs, Ys, ot), ot, SINKHORN_LONG_ROWS_ERR_ATOL)

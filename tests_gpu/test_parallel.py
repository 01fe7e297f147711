"""Each kernel wrapper on a second card (moved from
tests/test_torch_parallel.py). Needs two cards; on one card its
stand-in is ``scripts/torch_multi_card.py`` (run with four)."""

import numpy as np
import pytest
import torch

from hyperres_torch import parallel as tpar
from hyperres_torch.core.config import RidgeSRConfig
from hyperres_torch.fusion import ridge_sr as tridge
from hyperres_torch.kernels import host
from hyperres_torch.kernels.warp import orthowarp_two_pass

T = torch.from_numpy


def warp_case(rng, n_bands=6):
    """tests/test_tiling_parallel.py's two-pass case: a (40, 44) raw cube,
    a 64 x 48 GLT grid with 20 % holes, a sheared monotone rows field."""
    raw = rng.random((40, 44, n_bands)).astype(np.float32)
    ho, wo, hd, wd = 64, 48, 64, 50
    glt = np.zeros((ho, wo, 2), dtype=np.int32)
    valid = rng.random((ho, wo)) > 0.2
    glt[..., 0] = np.where(valid, rng.integers(1, 45, (ho, wo)), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, 41, (ho, wo)), 0)
    flat_idx, vmask = host.prepare_glt(glt, (40, 44))
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.003 * j * r / hd + 0.2).astype(np.float32)
    cols = (j * (wo / wd) + 0.002 * r - 0.1).astype(np.float32)
    return raw, flat_idx, vmask, rows, cols, host.scanline_cstar(rows, cols,
                                                                 ho)


@pytest.mark.gpu
def test_kernels_launch_on_the_tensors_card(cuda, rng):
    """Each kernel wrapper launches on its tensor's card, not on the
    calling thread's current one: with card 0 current, the five kernels
    on tensors on card 1 agree with their plain versions (the scanline
    passes and SRF to 1e-5, the quantize codes exactly, the SR codes to
    one step, the Sinkhorn duals to 1e-4), and the sharded two-pass warp
    on a mesh of cards 0 and 1 is bit-equal to one card's warp. Needs
    two CUDA devices; skips otherwise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a shard on a second card)")
    from hyperres_torch.kernels import banded, quantize, sr_predict, srf
    from hyperres_torch.kernels import sinkhorn_duals as sd

    c1 = torch.device("cuda", 1)
    with torch.cuda.device(0):
        src = T(rng.random((40, 30, 5)).astype(np.float32))
        pos1 = T(rng.uniform(-1, 31, (40, 25)).astype(np.float32))
        pos2 = T(rng.uniform(-1, 41, (20, 30)).astype(np.float32))
        for axis, p in ((1, pos1), (0, pos2)):
            got = banded.scanline_resample(src.to(c1), p.to(c1), axis)
            assert got.device == c1
            torch.testing.assert_close(
                got.cpu(), banded.scanline_resample(src, p, axis),
                rtol=0, atol=1e-5)
        x = T(rng.random((300, 7)).astype(np.float32))
        q = quantize.quantize_u16(x.to(c1), 0.0, 1.0, None, 65535)
        assert torch.equal(q.cpu(), quantize.quantize_u16(x, 0.0, 1.0, None,
                                                          65535))
        W = T(rng.random((7, 3)).astype(np.float32))
        v = T(rng.random(300) > 0.2)
        torch.testing.assert_close(
            srf.pallas_srf_synthesize(x.to(c1), W.to(c1), v.to(c1)).cpu(),
            srf.pallas_srf_synthesize(x, W, v), rtol=0, atol=1e-5)
        m = tridge.RidgeSpectralSR(4, 6, RidgeSRConfig(degree=2),
                                   device="cpu").fit(
            rng.random((2000, 4)).astype(np.float32),
            rng.uniform(0.1, 0.9, (2000, 6)).astype(np.float32))
        X = T(rng.random((512, 4)).astype(np.float32))
        args = (m.x_mean, m.x_std, m.W, m.intercept, m.factors)
        got = sr_predict.sr_predict_u16(X.to(c1), *(a.to(c1) for a in args),
                                        layout="rowmajor")
        want = sr_predict.sr_predict_u16(X, *args, layout="rowmajor")
        assert (got.cpu().to(torch.int32) - want.to(torch.int32)
                ).abs().max() <= 1
        Mr = -T(rng.random((64, 80)).astype(np.float32))
        la = torch.full((64,), -np.log(64.0))
        lb = torch.full((80,), -np.log(80.0))
        f, g, _ = sd.sinkhorn_duals(la.to(c1), lb.to(c1), Mr.to(c1), 30, 0.0)
        rf, rg, _ = sd.sinkhorn_duals_reference(la, lb, Mr, 30, 0.0)
        torch.testing.assert_close(f.cpu(), rf, rtol=0, atol=1e-4)
        torch.testing.assert_close(g.cpu(), rg, rtol=0, atol=1e-4)
        case = warp_case(rng)
        mesh = tpar.make_mesh(devices=["cuda:0", "cuda:1"])
        got = tpar.sharded_orthowarp_two_pass(*case, mesh, halo=8)
        want = orthowarp_two_pass(*(T(np.asarray(a)).to("cuda:0")
                                    for a in case))
        assert torch.equal(got, want)

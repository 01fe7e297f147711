"""The deshift kernel (``csrc/deshift_warp.cu``) on the card against the
eager chain it replaces in the coregistration: the shift field and
``warp_interpolate_chunked`` (``coreg.local.deshift_hwb``), then the cast
to the product's dtype (``coreg.local._cast_product``).

The target is bit-equality, as for the 10 m apply kernel: the kernel
rounds every step as the eager ops round them on the card (the affine in
float64, ``addcmul_``'s one fused multiply-add, IEEE divides), so the products
are compared with ``torch.equal``, NaN in the same places, and no
tolerance. Then ``coregister_stack`` on the card launches the kernel once
a successful attempt and counts ``deshift.kernel`` in ``coreg.deshift``.
"""

import numpy as np
import pytest
import torch

from card_inputs import coreg_scene
from hyperres_torch.core.config import CoregConfig
from hyperres_torch.coreg import granule as tgranule
from hyperres_torch.coreg import local as tlocal
from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import deshift_warp as dw
from hyperres_torch.utils import profiling

#: odd sizes, several blocks of 32 x 8 in each direction
B, H, W = 5, 67, 101
#: a zoom of 1.1 about the centre with a shear: positions leave the stack
#: on all four sides
AFFINE = np.array([[0.1, 0.02, -0.1 * (H / 2) - 0.3],
                   [0.01, 0.1, -0.1 * (W / 2) + 0.2]])
S2_NODATA = 65535.0
F32_NODATA = -9999.0
#: (stack dtype, nodata, product dtype)
CASES = {"u16_nodata": (torch.uint16, S2_NODATA, torch.uint16),
         "u16_nodata_f32": (torch.uint16, S2_NODATA, torch.float32),
         "u16_none": (torch.uint16, None, torch.uint16),
         "f32_nodata": (torch.float32, F32_NODATA, torch.float32),
         "f32_none": (torch.float32, None, torch.float32)}


def _result(rng, local: bool) -> tlocal.CoregResult:
    """The shift model; with ``local``, tie points whose residuals give
    the IDW field a few tenths of a px."""
    tps = []
    if local:
        for _ in range(12):
            r, c = int(rng.integers(0, H)), int(rng.integers(0, W))
            base = AFFINE @ np.array([r, c, 1.0])
            tps.append(tlocal.TiePoint(
                col=c, row=r, dy=float(base[0] + rng.normal(0, 0.4)),
                dx=float(base[1] + rng.normal(0, 0.4)), reliability=90.0))
    return tlocal.CoregResult(True, None, tie_points=tps, affine=AFFINE)


def _stack(rng, dtype, nodata, dev):
    """Codes 0-20000 with a nodata stripe (rows 3-8) and scattered nodata;
    a float stack adds NaN and +-inf at valid pixels."""
    x = rng.uniform(0.0, 20000.0, (B, H, W)).astype(np.float32)
    if dtype == torch.uint16:
        x = np.floor(x)
    if nodata is not None:
        x[:, 3:9] = nodata
        x.reshape(-1)[rng.choice(x.size, 200, replace=False)] = nodata
    if dtype == torch.float32:
        bad = rng.choice(x.size, 60, replace=False)
        x.reshape(-1)[bad] = np.tile([np.nan, np.inf, -np.inf], 20)
        return torch.from_numpy(x).to(dev)
    return torch.from_numpy(x.astype(np.uint16)).to(dev)


def _eager(stack, res, out_dtype, nodata, method, local):
    return tlocal._cast_product(
        tlocal.deshift_hwb(stack, res, nodata=nodata, method=method,
                           local_residuals=local), out_dtype, nodata)


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(want))
        zero = torch.zeros((), device=got.device)
        got, want = (torch.where(nan, zero, t) for t in (got, want))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["affine", "idw"])
@pytest.mark.parametrize("method", ["cubic", "bilinear"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_eager_chain_bit_for_bit(cuda_device, rng, case,
                                                method, field):
    """The kernel's product equals the eager chain's bit for bit: u16 and
    float32 stacks, a nodata stripe, NaN and +-inf in a float stack with
    and without a nodata value, positions off every side, cubic and
    bilinear, the affine and an IDW local-residual field, odd H, W, B.
    One launch a call."""
    dtype, nodata, out_dtype = CASES[case]
    local = field == "idw"
    res = _result(rng, local)
    stack = _stack(rng, dtype, nodata, cuda_device)
    assert dw.takes_kernel(cuda_device, dtype, method)
    reset_launch_counts()
    got = tlocal.deshift_product(stack, res, out_dtype, nodata=nodata,
                                 method=method, local_residuals=local)
    assert launch_counts == {dw.KERNEL_NAME: 1}
    want = _eager(stack, res, out_dtype, nodata, method, local)
    _assert_same(got, want)
    # fill off the sides, values inside
    if nodata is None:
        fill = torch.isnan(got) if out_dtype == torch.float32 else got == 0
    else:
        fill = got == nodata
    for edge in (fill[:, 0], fill[:, -1], fill[:, :, 0], fill[:, :, -1]):
        assert bool(edge.any())
    assert 0.1 < float(fill.float().mean()) < 0.6


@pytest.mark.gpu
def test_kernel_wrapper_refuses_bad_inputs(cuda_device, rng):
    """A CPU tensor, a non-contiguous stack and a wrong dtype raise before
    any launch."""
    stack = _stack(rng, torch.uint16, S2_NODATA, cuda_device)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        dw.deshift_warp(stack.cpu(), AFFINE, torch.uint16)
    with pytest.raises(ValueError, match="contiguous"):
        dw.deshift_warp(stack.transpose(1, 2), AFFINE, torch.uint16)
    with pytest.raises(TypeError, match="uint16 or float32"):
        dw.deshift_warp(stack.to(torch.int16), AFFINE, torch.uint16)
    with pytest.raises(TypeError, match="uint16 or float32"):
        dw.deshift_warp(stack, AFFINE, torch.float64)
    assert launch_counts == {}


@pytest.mark.gpu
def test_coregister_stack_launches_once_a_success(cuda_device, monkeypatch):
    """``coregister_stack`` on the card: each successful attempt launches
    the kernel once and counts ``deshift.kernel`` once in its
    ``coreg.deshift`` span (a B08 that is not in the stack's bands is no
    attempt that deshifts); the product equals the eager chain's, the
    rule forced off, bit for bit."""
    emit, emit_grid, stack, s2_grid = coreg_scene(cuda_device)
    cfg = CoregConfig(window_size=(128, 128), grid_res=150.0,
                      min_reliability=25.0)

    def run(bandmap):
        return tgranule.coregister_stack(
            {"B08": emit, "B04": emit}, emit_grid, stack, s2_grid, cfg,
            s2_bandmap=bandmap, nodata_s2=S2_NODATA, device=cuda_device)

    profiling.clear()
    reset_launch_counts()
    with profiling.tracing():
        outs = [run({"B03": 1, "B04": 2, "B08": 3}), run({"B04": 2})]
    assert [o["final"]["s2_code"] for o in outs] == ["B08", "B04"]
    assert launch_counts.get(dw.KERNEL_NAME) == 2
    recs = profiling.records()
    deshifts = [r for r in recs if r.name == "coreg.deshift"]
    assert [r.counts.get(dw.DESHIFT_COUNTER) for r in deshifts] == [1, 1]
    assert sum(r.counts.get(dw.DESHIFT_COUNTER, 0) for r in recs) == 2
    profiling.clear()
    for out in outs:   # the planted shift, to the scene's 60 m aliasing
        mean = out["final"]["mean_shift_px"]
        assert abs(mean[0] - 2.6) < 1.0 and abs(mean[1] + 3.3) < 1.0
        assert out["shifted"].dtype == torch.uint16
    monkeypatch.setattr(tlocal, "takes_kernel", lambda *a: False)
    reset_launch_counts()
    eager = run({"B03": 1, "B04": 2, "B08": 3})
    assert dw.KERNEL_NAME not in launch_counts
    assert torch.equal(outs[0]["shifted"], eager["shifted"])

"""The same-CRS resample kernel (``csrc/sep_resample.cu``) on the card
against two versions of it in eager ops:

- the kernel's own arithmetic (``tap_order``): each tap one
  ``addcmul_`` (a fused multiply-add on the card) in ascending source
  order from 0, the row pass then the column pass, then the IEEE divide;
  equal bit for bit, NaN (the fill) in the same places, in every case;
- the dense route it replaces there (``warp._interp_matrix``'s (Dst, Src)
  matrices through ``warp.separable_resample_matmul``'s f32 GEMMs). Where
  cuBLAS sums each output's products in source order with one fused
  multiply-add each (its zero terms add nothing), as at the
  coregistration cell's shapes, the two are equal bit for bit; cuBLAS
  picks other kernels for other shapes, and without a nodata value the
  dense mass is ``torch.sum``'s, so elsewhere they agree to the f32
  rounding of a sum in another order, amplified by 1 / mass:
  ``DENSE_ATOL`` where the mass is at least ``MIN_MASS``, the fill masks
  equal but where the mass lies within rounding of the 1e-6 threshold.

Each call goes through ``resample_tensor_to_grid`` and launches the
kernel once, counted as ``resample.kernel`` in the open span.
"""

import numpy as np
import pytest
import torch

from card_inputs import (EMIT_NODATA, RESAMPLE_DST, RESAMPLE_SRC,
                         resample_grids as grids, resample_source as source)
from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import sep_resample as sr
from hyperres_torch.kernels import warp as twarp
from hyperres_torch.kernels.host import separable_index_axes
from hyperres_torch.utils import profiling

NODATA = EMIT_NODATA
#: masses this close to the 1e-6 threshold may fall either side of it
MASS_SLACK = 1e-7
#: the dense route's bound away from the cell's shapes: atol / mass for a
#: mass of at least MIN_MASS (the CPU tests' TWO_PASS_ATOL for the dense
#: products against JAX's)
DENSE_ATOL = 1e-5
MIN_MASS = 0.05
#: name -> (source (rows, columns, m), destination (rows, columns, m,
#: offset in m), method, nodata, bands); "cell" is the coregistration
#: cell's transfer
CASES = {
    "cell": (RESAMPLE_SRC, RESAMPLE_DST, "cubic", NODATA, 1),
    "cubic_b3": ((61, 67, 60.0), (389, 403, 10.0, (-35.0, 25.0)), "cubic",
                 NODATA, 3),
    "bilinear_b3": ((61, 67, 60.0), (389, 403, 10.0, (-35.0, 25.0)),
                    "bilinear", NODATA, 3),
    "cubic_none": ((61, 67, 60.0), (389, 403, 10.0, (20.0, -15.0)),
                   "cubic", None, 1),
    "bilinear_none_b3": ((61, 67, 60.0), (389, 403, 10.0, (20.0, -15.0)),
                         "bilinear", None, 3),
    "down_bilinear_b3": ((389, 403, 10.0), (61, 67, 60.0, (15.0, -5.0)),
                         "bilinear", NODATA, 3),
    "down_cubic": ((389, 403, 10.0), (61, 67, 60.0, (0.0, 0.0)), "cubic",
                   None, 1),
    "past_source": ((61, 67, 60.0), (500, 560, 10.0, (-900.0, 700.0)),
                    "cubic", NODATA, 1),
}


def dense(x, sg, dg, method, nodata, fill):
    """The dense route on ``x``'s device, and its valid mass: through the
    same matrices, or without a nodata value the weight sums' product."""
    idx_r, idx_c = separable_index_axes(sg, dg)
    Wr = twarp._interp_matrix(idx_r, sg.height, method, x.device)
    Wc = twarp._interp_matrix(idx_c, sg.width, method, x.device)
    want = twarp.separable_resample_matmul(x, Wr, Wc, nodata=nodata,
                                           fill=fill)
    if nodata is None:
        mass = torch.outer(Wr.sum(dim=1), Wc.sum(dim=1))[..., None]
    else:
        ok = ((x != nodata) & torch.isfinite(x)).to(torch.float32)
        mass = torch.einsum("ew,dwb->deb", Wc,
                            torch.einsum("dh,hwb->dwb", Wr, ok))
    return want, mass


def tap_order(x, sg, dg, method, nodata, fill):
    """The kernel's arithmetic in eager ops on the card (module
    docstring); a tap off the source weighs 0 on a value of 0."""
    hs, ws, _ = x.shape
    idx_r, idx_c = separable_index_axes(sg, dg)
    taps = [sr.axis_taps(idx_r, hs, method), sr.axis_taps(idx_c, ws, method)]

    def axis_pass(a, ax):
        t = taps[ax]
        acc = None
        for k in range(t.weights.shape[0]):
            pos = torch.from_numpy(t.start + k).to(x.device).long()
            inside = ((pos >= 0) & (pos < a.shape[ax])).to(torch.float32)
            v = a.index_select(ax, pos.clamp(0, a.shape[ax] - 1))
            w = torch.from_numpy(t.weights[k]).to(x.device) * inside
            shape = (-1, 1, 1) if ax == 0 else (1, -1, 1)
            v = v * inside.view(shape)
            if acc is None:
                acc = torch.zeros_like(v)
            acc.addcmul_(w.view(shape), v)
        return acc

    def passes(a):
        return axis_pass(axis_pass(a, 0), 1)

    if nodata is None:
        num = passes(x)
        mass = torch.outer(*(torch.from_numpy(t.sums).to(x.device)
                             for t in taps))[..., None]
    else:
        ok = (x != nodata) & torch.isfinite(x)
        num = passes(torch.where(ok, x, torch.zeros((), device=x.device)))
        mass = passes(ok.to(torch.float32))
    good = mass.abs() > 1e-6
    return torch.where(good, num / torch.where(good, mass, 1.0),
                       torch.full((), fill, device=x.device)).expand_as(num)


def compare(got, want, mass=None):
    """(value cells that differ, fill cells on one side only where the
    mass is clear of the threshold, the largest value difference times
    min(1, |mass|) where the mass is at least MIN_MASS)."""
    fg, fw = torch.isnan(got), torch.isnan(want)
    both = ~fg & ~fw
    if mass is None:
        clear, weight = torch.ones_like(fg), torch.ones_like(got)
    else:
        m = mass.abs().expand_as(got)
        clear = (m - 1e-6).abs() > MASS_SLACK
        weight = torch.where(m >= MIN_MASS, m.clamp(max=1.0), 0.0)
    diff = torch.where(both, (got - want).abs() * weight, 0.0)
    return (int((both & (got != want)).sum()), int(((fg != fw) & clear).sum()),
            float(diff.max()))


def kernel_call(x, sg, dg, method, nodata, fill):
    """``resample_tensor_to_grid`` in a traced span: (result, kernel
    launches, the span's ``resample.kernel`` count)."""
    profiling.clear()
    reset_launch_counts()
    with profiling.tracing(), profiling.span("caller", x.device):
        got = twarp.resample_tensor_to_grid(x, sg, dg, method=method,
                                            nodata=nodata, fill=fill)
    rec = [r for r in profiling.records() if r.name == "caller"][-1]
    profiling.clear()
    return (got, launch_counts.get(sr.KERNEL_NAME, 0),
            rec.counts.get(sr.RESAMPLE_COUNTER, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_its_arithmetic_and_the_dense_route(cuda_device, rng,
                                                           case):
    """The kernel's result equals ``tap_order``'s bit for bit, fill in the
    same places, and the dense route's bit for bit at the coregistration
    cell's shapes (off-swath nodata and NaN), within DENSE_ATOL / mass
    elsewhere: bilinear and cubic, with and without a nodata value, 1 and
    3 bands, a downsample, a destination reaching past the source (fill
    there). One launch a call, counted once in the open span."""
    src, dst, method, nodata, b = CASES[case]
    sg, dg = grids(src, dst)
    x = source(rng, src[0], src[1], b, nodata, cuda_device)
    got, launches, counted = kernel_call(x, sg, dg, method, nodata, np.nan)
    assert (launches, counted) == (1, 1)
    assert got.shape == (dst[0], dst[1], b) and got.dtype == torch.float32
    n_diff, n_mask, _ = compare(got, tap_order(x, sg, dg, method, nodata,
                                               np.nan))
    assert (n_diff, n_mask) == (0, 0)
    want, mass = dense(x, sg, dg, method, nodata, np.nan)
    n_diff, n_mask, worst = compare(got, want, mass)
    assert n_mask == 0 and worst <= DENSE_ATOL, (n_diff, n_mask, worst)
    if case == "cell":
        assert n_diff == 0, (n_diff, worst)
    fill = torch.isnan(got)
    assert float(fill.float().mean()) < 1.0
    if case == "past_source":   # every side of the destination is fill
        for edge in (fill[0], fill[-1], fill[:, 0], fill[:, -1]):
            assert bool(edge.all())


@pytest.mark.gpu
def test_kernel_wrapper_refuses_bad_inputs(cuda_device, rng):
    """A CPU tensor, a non-contiguous or non-f32 source, a 2-D source,
    ``nearest`` and taps made for another shape raise before any
    launch."""
    x = source(rng, 20, 24, 2, NODATA, cuda_device)
    idx = np.arange(30) / 6.0 - 0.4
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        sr.sep_resample(x.cpu(), idx, idx, "cubic")
    with pytest.raises(ValueError, match="contiguous"):
        sr.sep_resample(x.transpose(0, 1), idx, idx, "cubic")
    with pytest.raises(ValueError, match="contiguous"):
        sr.sep_resample(x[..., 0], idx, idx, "cubic")
    with pytest.raises(TypeError, match="float32"):
        sr.sep_resample(x.double(), idx, idx, "cubic")
    with pytest.raises(ValueError, match="nearest"):
        sr.sep_resample(x, idx, idx, "nearest")
    taps = sr.device_taps(idx, idx, (20, 24, 3), "cubic", cuda_device)
    with pytest.raises(ValueError, match="taps made for"):
        sr.launch(x, taps)
    assert launch_counts == {}

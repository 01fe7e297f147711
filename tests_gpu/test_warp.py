"""The scanline kernel (``csrc/scanline_warp.cu``) on the card against
its plain version: both banded passes and the dense route, at the
warp's real channel widths (on a sheared geometry and on the scale-0.25
bench scene's warp operands), and ``warp_two_pass`` launching it. Moved
from tests/test_torch_warp.py and tests/test_torch_resample.py, whose
CPU tests hold the plain versions to the JAX package."""

import functools

import numpy as np
import pytest
import torch

from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import banded
from hyperres_torch.kernels import host
from hyperres_torch.kernels import warp as twarp

T = torch.from_numpy
NODATA = -9999.0
TWO_PASS_ATOL = 1e-5
#: the bench scene's scale for the second geometry
CHECK_SCALE = 0.25
GEOMETRIES = ["wide_150x600", f"bench_{CHECK_SCALE}"]


def _wide_geometry():
    """tests/test_torch_warp.py's ``wide_150x600`` two-pass geometry."""
    ho, wo, hd, wd = 150, 600, 140, 590
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.004 * j * r / hd + 0.3).astype(np.float32)
    cols = (j * (wo / wd) + 0.003 * r - 0.2).astype(np.float32)
    return rows, host.scanline_cstar(rows, cols, ho)


@functools.lru_cache(maxsize=1)
def _bench_operands():
    """The scale-CHECK_SCALE bench scene's warp operands on the card as its
    plan takes them: the extended source, c* and the rows field."""
    import bench_torch
    from hyperres_torch.testing.bench_scene import generate_scene

    small = generate_scene(CHECK_SCALE, 0)
    plan = bench_torch.build_plan(small, "cuda:0")
    return (twarp.orthowarp_src_ext(T(small["raw"]).to("cuda:0"),
                                    plan._flat_idx, plan._valid),
            plan._cstar, plan._wr)


def _operands(geometry, dev, rng):
    """(source, c*, rows): ``_wide_geometry`` with a seeded 286-channel
    source, or ``_bench_operands``."""
    if geometry != "wide_150x600":
        return _bench_operands()
    rows, cstar = _wide_geometry()
    src = T(rng.random((150, 600, 286)).astype(np.float32)).to(dev)
    return src, T(cstar).to(dev), T(rows).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_scanline_kernel_matches_plain_on_gpu(cuda_device, method, rng,
                                              geometry):
    """The CUDA kernel == its plain version on the card, both passes, at
    the warp's real channel width (286), to 1e-5 (same taps; FMA
    contraction differs; pass 2 on the kernel's pass-1 output); each
    launch counts once."""
    src, cstar_d, rows_d = _operands(geometry, cuda_device, rng)
    reset_launch_counts()
    h = banded.scanline_resample(src, cstar_d, 1, method)
    out = banded.scanline_resample(h, rows_d, 0, method)
    assert launch_counts == {"scanline_resample_pass1": 1,
                             "scanline_resample_pass2": 1}
    h_ref = banded.scanline_resample_reference(src, cstar_d, 1, method)
    out_ref = banded.scanline_resample_reference(h, rows_d, 0, method)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_dense_kernel_matches_plain_on_gpu(cuda_device, method, rng,
                                           geometry):
    """The dense route on the card == its dense plain version, both
    passes as the warp runs them (pass 2 on pass 1's natural layout), at
    the warp's channel width (286), to 1e-5; one launch per pass under
    the dense route's own counter."""
    src, cstar_d, rows_d = _operands(geometry, cuda_device, rng)
    reset_launch_counts()
    h = banded.scanline_resample_dense(src, cstar_d, method)
    out = banded.scanline_resample_dense(h, rows_d, method, axis=0)
    assert launch_counts == {banded.DENSE_KERNEL_NAME: 2}
    h_ref = banded.scanline_resample_dense_reference(src, cstar_d, method)
    out_ref = banded.scanline_resample_dense_reference(h, rows_d, method,
                                                       axis=0)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_warp_two_pass_launches_the_kernel_on_the_card(cuda_device, rng):
    """On a CUDA tensor ``warp_two_pass`` launches each pass of
    ``csrc/scanline_warp.cu`` once, at 2 B = 570 channels, and agrees
    with the gather warp to TWO_PASS_ATOL."""
    dev = cuda_device
    ho, wo, hd, wd = 200, 210, 190, 205
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.3 + 0 * j).astype(np.float32)
    cols = (j * (wo / wd) - 0.2 + 0 * r).astype(np.float32)
    cstar = host.scanline_cstar(rows, cols, ho)
    img = rng.random((ho, wo, 285)).astype(np.float32)
    args = [T(a).to(dev) for a in (img, rows, cols, cstar)]
    reset_launch_counts()
    got = twarp.warp_two_pass(*args, nodata=NODATA)
    assert dict(launch_counts) == {n: 1 for n in banded.KERNEL_NAMES.values()}
    want = twarp.warp_interpolate(*args[:3], nodata=NODATA, method="cubic")
    torch.testing.assert_close(got, want, rtol=0, atol=TWO_PASS_ATOL)

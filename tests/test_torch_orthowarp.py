"""The fused ortho warp's route rule and wrapper checks on the CPU
(``hyperres_torch/kernels/orthowarp.py``): the CPU keeps the plain chain
of ``orthowarp_two_pass`` (``orthowarp_src_ext``, two scanline passes,
``_renormalise``) and counts no ``orthowarp.kernel``; the wrappers raise
on what the kernels do not take before they build or launch anything.
The kernels themselves run on the card only (``tests_gpu/
test_orthowarp.py``, bit for bit against the eager chain)."""

import numpy as np
import pytest
import torch

from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import _build, banded, host
from hyperres_torch.kernels import orthowarp as ow
from hyperres_torch.kernels import warp as twarp
from hyperres_torch.utils import profiling

T = torch.from_numpy
FILL = -9999.0


def operands(b, seed=0):
    """A sheared GLT from a 20 x 24 raw cube onto a 22 x 26 ortho grid
    (holes off the swath and on ortho row 3), a 24 x 28 destination whose
    first rows leave the source, and a raw cube of ``b`` bands with a NaN
    in pixel 0 (which every invalid cell gathers)."""
    rng = np.random.default_rng(seed)
    (h, w), (ho, wo), (hd, wd) = (20, 24), (22, 26), (24, 28)
    r, c = np.mgrid[:ho, :wo].astype(np.float64)
    i = np.round(0.8 * r + 0.15 * c - 3).astype(np.int64)
    j = np.round(-0.12 * r + 0.85 * c + 1).astype(np.int64)
    valid = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    valid[3] = False
    flat = np.where(valid, i * w + j, 0).astype(np.int32)
    rr, cc = np.mgrid[:hd, :wd].astype(np.float32)
    rows = (rr * (ho / hd) + 0.02 * cc - 1.5).astype(np.float32)
    cols = (cc * (wo / wd) - 0.01 * rr + 0.3).astype(np.float32)
    raw = rng.random((h, w, b)).astype(np.float32)
    raw[0, 0, 0] = np.nan
    return [T(a) for a in (raw, flat, valid, rows, cols,
                           host.scanline_cstar(rows, cols, ho))]


def plain_chain(raw, flat, valid, rows, cols, cstar, method):
    b = raw.shape[-1]
    ho, wo = flat.shape
    h = banded.scanline_resample_reference(
        twarp.orthowarp_src_ext(raw, flat, valid), cstar, 1, method)
    out_ext = banded.scanline_resample_reference(h, rows, 0, method)
    return twarp._renormalise(out_ext[..., :b], out_ext[..., b:],
                              twarp._centre_in(rows, cols, ho, wo), FILL)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas_banded"])
@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_cpu_keeps_the_plain_chain(monkeypatch, method, backend):
    """On CPU tensors ``orthowarp_two_pass`` is the plain chain bit for
    bit (NaN in the same places: pixel 0's NaN poisons through the
    invalid cells), calls no kernel wrapper, launches nothing and counts
    no ``orthowarp.kernel`` in the open span."""
    args = operands(5)

    def refuse(*a, **k):
        raise AssertionError("the CPU must not reach the kernels")

    monkeypatch.setattr(ow, "orthowarp", refuse)
    profiling.clear()
    reset_launch_counts()
    with profiling.tracing(), profiling.span("caller"):
        got = twarp.orthowarp_two_pass(*args, method=method, fill=FILL,
                                       backend=backend)
    rec = [r for r in profiling.records() if r.name == "caller"][-1]
    profiling.clear()
    assert rec.counts == {} and not launch_counts
    want = plain_chain(*args, method)
    nan = torch.isnan(want)
    assert bool(nan.any()) and bool((want == FILL).any())
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.parametrize("device,backend,want", [
    ("cuda", "auto", True), ("cuda", "xla", True),
    ("cuda", "pallas_banded", True), ("cuda:1", "auto", True),
    ("cuda", "pallas", False), ("cpu", "auto", False),
])
def test_route_rule(device, backend, want):
    """The banded route on a CUDA device takes the kernels; the dense
    route and the CPU keep the scanline passes."""
    assert ow.takes_kernel(device, backend) is want


def _bad_calls():
    """(exception, call) pairs on CPU tensors, each with one fault."""
    raw, flat, valid, rows, cols, cstar = operands(5)
    vf = valid.to(torch.float32)
    ho, wo = flat.shape
    mid = torch.zeros((ho, cstar.shape[1], 6))
    return {
        "raw_f64": (TypeError, lambda: ow.pass1(raw.double(), flat, vf,
                                                cstar)),
        "raw_2d": (ValueError, lambda: ow.pass1(raw[..., 0], flat, vf,
                                                cstar)),
        "raw_channel_stride": (ValueError, lambda: ow.pass1(
            raw[..., ::2], flat, vf, cstar)),
        "raw_row_stride": (ValueError, lambda: ow.pass1(
            raw[::2], flat, vf, cstar)),
        "flat_float": (TypeError, lambda: ow.pass1(raw, flat.float(), vf,
                                                   cstar)),
        "flat_strided": (ValueError, lambda: ow.pass1(
            raw, flat.T.contiguous().T, vf, cstar)),
        "valid_bool": (TypeError, lambda: ow.pass1(raw, flat, valid, cstar)),
        "valid_shape": (ValueError, lambda: ow.pass1(raw, flat, vf[1:],
                                                     cstar)),
        "cstar_rows": (ValueError, lambda: ow.pass1(raw, flat, vf,
                                                    cstar[1:])),
        "cstar_strided": (ValueError, lambda: ow.pass1(
            raw, flat, vf, cstar.T.contiguous().T)),
        "nearest": (ValueError, lambda: ow.pass1(raw, flat, vf, cstar,
                                                 "nearest")),
        "cpu_pass1": (ValueError, lambda: ow.pass1(raw, flat, vf, cstar)),
        "mid_2d": (ValueError, lambda: ow.pass2(mid[..., 0], rows, cols,
                                                wo)),
        "rows_columns": (ValueError, lambda: ow.pass2(mid, rows[:, 1:],
                                                      cols, wo)),
        "cols_shape": (ValueError, lambda: ow.pass2(mid, rows, cols[1:],
                                                    wo)),
        "cols_f64": (TypeError, lambda: ow.pass2(mid, rows, cols.double(),
                                                 wo)),
        "cpu_pass2": (ValueError, lambda: ow.pass2(mid, rows, cols, wo)),
        "cpu_orthowarp": (ValueError, lambda: ow.orthowarp(
            raw, flat, valid, rows, cols, cstar)),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_refuse_before_building(monkeypatch, case):
    """Each fault raises its error before the kernels' library is built
    or loaded; well-formed CPU operands raise the device error."""
    def no_build(name):
        raise AssertionError(f"{name} built for a refused call")

    monkeypatch.setattr(_build, "load_library", no_build)
    exc, call = _bad_calls()[case]
    with pytest.raises(exc) as info:
        call()
    if case.startswith("cpu_"):
        assert "CUDA tensors only" in str(info.value)

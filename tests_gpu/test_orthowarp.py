"""The fused ortho warp's two kernels (``kernels/orthowarp.py``,
``csrc/scanline_warp.cu``) on the card against the eager chain they
replace there: ``orthowarp_src_ext`` (the GLT gather times its validity,
the validity as one more channel), the scanline kernel's two passes and
``_renormalise``. Equal bit for bit, on both sides of the fill, and the
pass-1 intermediate equal to the chain's pass-1 output; on a sheared
geometry with GLT holes, quality-mask holes, all-invalid ortho rows,
destinations whose centre leaves the source, and raw NaNs under an
invalid GLT cell (pixel 0, which every invalid cell gathers) and under a
valid one."""

import numpy as np
import pytest
import torch

from card_inputs import assert_bits, eager_orthowarp
from hyperres_torch.device import launch_counts, reset_launch_counts
from hyperres_torch.kernels import host
from hyperres_torch.kernels import orthowarp as ow
from hyperres_torch.kernels import warp as twarp
from hyperres_torch.utils import profiling

T = torch.from_numpy
FILL = -9999.0
#: raw (h, w), ortho (Ho, Wo) and UTM (Hd, Wd) grids of the geometry
RAW, ORTHO, UTM = (40, 50), (48, 56), (52, 60)
#: band counts: LOC, OBS, a band-masked chunk's 2 nb (nb = 16), DATA, and
#: more channels than one tile takes (1024 at 4 a thread)
BANDS = [3, 11, 32, 285, 1200]
#: a raw pixel that a valid GLT cell reads, and its NaN band
VALID_NAN = ((10, 20), 7)


def geometry(rng):
    """(flat int32, valid bool, rows, cols, cstar) of a sheared GLT: ortho
    (r, c) reads raw pixel (0.8 r + 0.15 c - 5, -0.12 r + 0.85 c + 2),
    invalid off the swath, at ~10 % quality-flagged raw pixels and on
    ortho rows 5-6; the UTM centres leave the source at the first rows
    and the last columns."""
    (h, w), (ho, wo), (hd, wd) = RAW, ORTHO, UTM
    r, c = np.mgrid[:ho, :wo].astype(np.float64)
    i = np.round(0.8 * r + 0.15 * c - 5).astype(np.int64)
    j = np.round(-0.12 * r + 0.85 * c + 2).astype(np.int64)
    valid = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    flat = np.where(valid, i * w + j, 0)
    flagged = rng.random(h * w) < 0.1
    flagged[VALID_NAN[0][0] * w + VALID_NAN[0][1]] = False
    valid &= ~flagged[flat]
    valid[5:7] = False
    rr, cc = np.mgrid[:hd, :wd].astype(np.float32)
    rows = (rr * (ho / hd) + 0.02 * cc - 1.5).astype(np.float32)
    cols = (cc * (wo / wd) - 0.01 * rr + 0.7).astype(np.float32)
    return (flat.astype(np.int32), valid, rows, cols,
            host.scanline_cstar(rows, cols, ho))


def operands(rng, b, dev):
    """The geometry's operands on ``dev`` and a seeded raw (h, w, b) cube
    with a NaN in raw pixel 0 and one under a valid GLT cell."""
    flat, valid, rows, cols, cstar = geometry(rng)
    raw = rng.random((*RAW, b)).astype(np.float32)
    raw[0, 0, min(1, b - 1)] = np.nan
    (vr, vc), band = VALID_NAN
    raw[vr, vc, min(band, b - 1)] = np.nan
    assert valid.reshape(-1)[flat.reshape(-1) == vr * RAW[1] + vc].any()
    return [T(a).to(dev) for a in (raw, flat, valid, rows, cols, cstar)]


@pytest.mark.gpu
@pytest.mark.parametrize("b", BANDS)
@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_fused_warp_equals_the_eager_chain(cuda, rng, method, b):
    """``orthowarp_two_pass`` on the card: one launch of each fused pass
    and no other, one ``orthowarp.kernel`` in the open span, the result
    and the pass-1 intermediate equal to the eager chain's bit for bit;
    fill where the chain fills, NaN where it poisons (both present)."""
    raw, flat, valid, rows, cols, cstar = operands(rng, b, cuda)
    profiling.clear()
    reset_launch_counts()
    with profiling.tracing(), profiling.span("caller", cuda):
        got = twarp.orthowarp_two_pass(raw, flat, valid, rows, cols, cstar,
                                       method=method, fill=FILL)
    assert dict(launch_counts) == {n: 1 for n in ow.KERNEL_NAMES.values()}
    rec = [r for r in profiling.records() if r.name == "caller"][-1]
    assert rec.counts == {ow.ORTHOWARP_COUNTER: 1}
    profiling.clear()
    h_want, want = eager_orthowarp(raw, flat, valid, rows, cols, cstar,
                                   method, FILL)
    assert_bits(got, want)
    assert bool((want == FILL).any()) and bool(torch.isnan(want).any())
    assert bool(((want != FILL) & ~torch.isnan(want)).any())
    h = ow.pass1(raw, flat, valid.to(torch.float32), cstar, method)
    assert_bits(h, h_want)


@pytest.mark.gpu
def test_int64_indices_and_a_band_slice(cuda, rng):
    """int64 GLT indices and a band slice of a wider cube (pixels at a
    stride of 300 floats): the same bits."""
    raw, flat, valid, rows, cols, cstar = operands(rng, 300, cuda)
    raw = raw[..., 10:295]
    got = ow.orthowarp(raw, flat.long(), valid, rows, cols, cstar)
    assert_bits(got, eager_orthowarp(raw.contiguous(), flat, valid, rows,
                                      cols, cstar)[1])


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernels_do_not_take(cuda, rng):
    """Raw not float32, a channel-strided raw, float GLT indices, a
    non-contiguous cstar, mismatched shapes or devices, nearest: raised
    before any launch."""
    raw, flat, valid, rows, cols, cstar = operands(rng, 11, cuda)
    vf = valid.to(torch.float32)
    mid = torch.zeros((*ORTHO[:1], UTM[1], 12), device=cuda)
    reset_launch_counts()
    bad = [
        (TypeError, lambda: ow.pass1(raw.double(), flat, vf, cstar)),
        (ValueError, lambda: ow.pass1(raw[..., ::2], flat, vf, cstar)),
        (TypeError, lambda: ow.pass1(raw, flat.float(), vf, cstar)),
        (ValueError, lambda: ow.pass1(raw, flat, vf,
                                      cstar.T.contiguous().T)),
        (ValueError, lambda: ow.pass1(raw, flat, vf[1:], cstar)),
        (ValueError, lambda: ow.pass1(raw, flat, vf.cpu(), cstar)),
        (ValueError, lambda: ow.pass1(raw, flat, vf, cstar, "nearest")),
        (ValueError, lambda: ow.pass2(mid, rows, cols[:, 1:], ORTHO[1])),
        (ValueError, lambda: ow.pass2(mid, rows[:, 1:], cols, ORTHO[1])),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    assert not launch_counts
